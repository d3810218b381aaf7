"""qwen3-4b — dense, qk-norm, GQA kv=8. [hf:Qwen/Qwen3-8B; hf]

36L, d_model 2560, 32 heads (GQA kv=8, head_dim 128), d_ff 9728,
vocab 151936, RMSNorm on q/k heads (qk_norm), no QKV bias (Qwen3 dropped it).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="qwen3-4b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    qk_norm=True,
    attn_chunk=32,
    remat=False,
)

SHARDING_OVERRIDES: dict = {}
