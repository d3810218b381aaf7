"""RPT002 fixture: draws from torch's global generator."""

import torch


def noise(shape, like):
    a = torch.randn(shape)
    b = torch.rand_like(like)
    c = torch.empty(shape).uniform_(-1.0, 1.0)
    return a + b + c
