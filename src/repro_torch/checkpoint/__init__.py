"""ONN checkpoints in the reference's ``onn.npz`` + ``onn.json`` format
(:mod:`repro_torch.checkpoint.onn`, re-exported here)."""

from repro_torch.checkpoint.onn import OnnCheckpoint, load_onn, save_onn  # noqa: F401
