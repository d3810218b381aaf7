"""RPT004 fixture: a tensor-holding dataclass with the generated __eq__."""

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Slab:
    name: str
    state: Optional[torch.Tensor]
