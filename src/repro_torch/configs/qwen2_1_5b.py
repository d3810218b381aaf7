"""qwen2-1.5b — dense, GQA kv=2, QKV bias. [arXiv:2407.10671; hf]

28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960, vocab 151936.

Sharding override: 12 q-heads / 2 kv-heads do not divide the 16-way model
axis; head-sharding would force GSPMD padding of 1.33×/8×.  Attention is
replicated across the model axis and tensor parallelism carries the MLP
(d_ff 8960 = 16 × 560) and the vocab — the standard small-head-count layout.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="qwen2-1.5b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    attn_chunk=32,
    remat=False,
)

SHARDING_OVERRIDES = {"heads": None, "kv_heads": None}
