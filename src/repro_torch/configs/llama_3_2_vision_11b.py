"""llama-3.2-vision-11b — VLM with gated cross-attention image layers.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

40L backbone, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 128256;
a gated cross-attention layer every 5th layer (8 total).  The vision frontend
is a STUB per the assignment: ``input_specs()`` supplies precomputed patch
embeddings (B, 1601, 7680); only the multi-modal projection into the backbone
is built.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    cross_every=5,
    vision_dim=7680,
    n_vision_tokens=1601,
    rope_theta=5e5,
)

REDUCED = ModelConfig(
    name="llama-3.2-vision-11b-reduced",
    family="vlm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    cross_every=2,
    vision_dim=32,
    n_vision_tokens=8,
    attn_chunk=32,
    remat=False,
)

SHARDING_OVERRIDES: dict = {}
