"""arctic-480b — Snowflake Arctic: 128-expert top-2 MoE + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]

35L, d_model 7168, 56 heads (GQA kv=8), d_ff 4864 per expert, vocab 32000;
each block runs the top-2-of-128 MoE in parallel with a dense residual SwiGLU
(d_ff_dense 4864).  ~460 B total parameters — the largest dry-run cell; the
train cells use Adafactor (AdamW's 8 B/param f32 state does not fit the
per-device HBM budget at 256 chips — EXPERIMENTS.md §Dry-run).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    n_experts=128,
    top_k=2,
    d_ff_dense=4864,
    rope_theta=1e4,
)

REDUCED = ModelConfig(
    name="arctic-480b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab=256,
    n_experts=8,
    top_k=2,
    d_ff_dense=32,
    attn_chunk=32,
    remat=False,
)

SHARDING_OVERRIDES: dict = {}
