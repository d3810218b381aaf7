"""zamba2-2.7b — hybrid: Mamba2 backbone + ONE shared attention block.
[arXiv:2411.15242; hf]

54 Mamba2 layers (d_model 2560, expand 2 → d_inner 5120, ssm_state 64,
head_dim 64 → 80 SSM heads); a shared transformer block (32 heads MHA +
SwiGLU d_ff 10240, weights shared, per-invocation RMSNorm) every 6 layers
(9 invocations) — the simplified Zamba2 scheme recorded in DESIGN.md.

O(1) SSM state ⇒ runs the long_500k cell; only the shared block's KV cache
scales with context (sharded over the data axis via the kv_seq rule).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="zamba",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,
    rope_theta=1e4,
)

REDUCED = ModelConfig(
    name="zamba2-2.7b-reduced",
    family="zamba",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    shared_attn_every=2,
    ssm_chunk=16,
    attn_chunk=32,
    remat=False,
)

SHARDING_OVERRIDES: dict = {}
