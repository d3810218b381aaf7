"""whisper-large-v3 — encoder–decoder audio backbone. [arXiv:2212.04356; unverified]

32L encoder + 32L decoder, d_model 1280, 20 heads (MHA), d_ff 5120,
vocab 51866.  Conv frontend is a STUB: ``input_specs()`` supplies
post-conv mel-frame embeddings (B, T_enc, 1280).  train/prefill cells stretch
T_enc to the assigned seq_len (beyond Whisper's 1500-frame reality — noted as
synthetic in DESIGN.md); decode cells use a 1500-frame encoder memory and the
assigned seq_len for the decoder self-cache.

20 heads do not divide the 16-way model axis (1.6× GSPMD pad); attention is
replicated and TP carries the MLP + vocab (see SHARDING_OVERRIDES).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    qkv_bias=True,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="whisper-large-v3-reduced",
    family="encdec",
    n_layers=2,
    n_encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    tie_embeddings=True,
    attn_chunk=32,
    remat=False,
)

SHARDING_OVERRIDES = {"heads": None, "kv_heads": None}
