"""Escape-hatch fixture: deliberate violations, pragma-suppressed."""

import torch

# A reproducible demo: the literal seed is the point here.
GEN = torch.Generator().manual_seed(0)  # repro-lint: disable=RPT001
# One comment names a reference code and a port code.
NOISE = torch.randn(3)  # repro-lint: disable=RPL002,RPT002
