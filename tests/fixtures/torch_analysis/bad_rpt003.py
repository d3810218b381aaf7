"""RPT003 fixture: a functools cache that keeps tensors alive."""

import functools

import torch


@functools.lru_cache(maxsize=None)
def identity(n: int):
    return torch.eye(n) + torch.zeros((n, n))


@functools.cache
def scaled(x: torch.Tensor, k: int) -> torch.Tensor:
    return x * k
