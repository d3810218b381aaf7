"""xlstm-1.3b — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

48 blocks, d_model 2048, 4 heads, vocab 50304, no separate FFN (d_ff 0 — the
mLSTM block carries its own 2× up/down projection).  Layout: one sLSTM block
every 8 blocks (6 total), the rest mLSTM (matrix memory, qk_dim 256).
Recurrent O(1) state ⇒ runs the long_500k cell.

Sharding override: 4 heads cannot use the 16-way model axis; TP carries the
2×-expanded inner dim (4096 = 16 × 256) instead ("mlp" rule), heads replicated.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="xlstm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_every=8,
    mlstm_qk_dim=256,
    ssm_expand=2,
)

REDUCED = ModelConfig(
    name="xlstm-1.3b-reduced",
    family="xlstm",
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab=256,
    slstm_every=2,
    mlstm_qk_dim=16,
    ssm_expand=2,
    ssm_chunk=16,
    attn_chunk=32,
    remat=False,
)

SHARDING_OVERRIDES = {"heads": None}
