"""granite-moe-3b-a800m — fine-grained MoE. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

32L, d_model 1536, 24 heads (GQA kv=8), vocab 49155; MoE with d_ff(expert) 512.

SPEC CONFLICT (recorded in DESIGN.md §4): the assignment's numeric config
says "MoE 40e top-8" while its free-text note says "32 experts top-8".
We follow the numeric field: 40 experts, top-8.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    rope_theta=1e4,
)

REDUCED = ModelConfig(
    name="granite-moe-3b-a800m-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab=256,
    n_experts=8,
    top_k=2,
    attn_chunk=32,
    remat=False,
)

# 40 experts do not divide the 16-way model axis; tensor-parallel the expert
# FFN dim instead (d_ff 512 = 16 × 32) and replicate the expert axis.
SHARDING_OVERRIDES = {"experts": None, "expert_mlp": "model"}
