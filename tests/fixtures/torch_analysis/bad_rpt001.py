"""RPT001 fixture: a fixed seed hidden in library code."""

import torch


def make_generator():
    return torch.Generator().manual_seed(0)


def reset():
    torch.manual_seed(1234)
