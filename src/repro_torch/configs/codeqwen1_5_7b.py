"""codeqwen1.5-7b — dense, Qwen1.5 architecture. [hf:Qwen/CodeQwen1.5-7B; hf]

32L, d_model 4096, 32 heads (GQA kv=32 == MHA), d_ff 13440 (SwiGLU),
vocab 92416, RoPE, QKV bias (Qwen1.5 convention).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="codeqwen1.5-7b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    rope_theta=1e6,
    attn_chunk=32,
    remat=False,
)

SHARDING_OVERRIDES: dict = {}
