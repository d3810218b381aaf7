"""h2o-danube-1.8b — dense, llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]

24L, d_model 2560, 32 heads (GQA kv=8), d_ff 6912, vocab 32000, SWA.
The 4096-token window bounds the KV cache, so this arch RUNS the long_500k
cell (ring-buffer cache of `window` slots — DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    window=4096,
    rope_theta=1e4,
)

REDUCED = ModelConfig(
    name="h2o-danube-1.8b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    window=32,
    attn_chunk=16,
    remat=False,
)

SHARDING_OVERRIDES: dict = {}
