"""ONN checkpoints in the reference's ``onn.npz`` + ``onn.json`` format."""
