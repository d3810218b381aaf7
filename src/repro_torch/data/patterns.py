"""Pattern datasets for the associative-memory benchmark (paper §4.3).

Five datasets at pattern sizes 3×3, 5×4, 7×6, 10×10 and 22×22; spins +1 =
black pixel, −1 = white.  Corruption flips exactly ``round(fraction · N)``
pixels.  The rasters are the reference's (``repro.data.patterns``); the
random choice of pixels comes from an explicit ``torch.Generator`` or from
explicit indices, since PyTorch cannot replay JAX's PRNG.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.checks import resolve_device

# 5×7 dot-matrix font for the letters used by the letter datasets.
_FONT_5x7 = {
    "A": ["01110", "10001", "10001", "11111", "10001", "10001", "10001"],
    "B": ["11110", "10001", "11110", "10001", "10001", "10001", "11110"],
    "C": ["01111", "10000", "10000", "10000", "10000", "10000", "01111"],
    "E": ["11111", "10000", "11110", "10000", "10000", "10000", "11111"],
    "H": ["10001", "10001", "10001", "11111", "10001", "10001", "10001"],
    "L": ["10000", "10000", "10000", "10000", "10000", "10000", "11111"],
    "N": ["10001", "11001", "10101", "10011", "10001", "10001", "10001"],
    "T": ["11111", "00100", "00100", "00100", "00100", "00100", "00100"],
    "U": ["10001", "10001", "10001", "10001", "10001", "10001", "01110"],
    "X": ["10001", "01010", "00100", "00100", "01010", "10001", "10001"],
}

DATASET_SHAPES: Dict[str, Tuple[int, int]] = {
    "3x3": (3, 3),
    "5x4": (5, 4),
    "7x6": (7, 6),
    "10x10": (10, 10),
    "22x22": (22, 22),
}
DATASET_LETTERS: Dict[str, List[str]] = {
    "3x3": ["X", "T"],
    "5x4": ["A", "E", "H", "L", "T"],
    "7x6": ["A", "E", "H", "L", "T"],
    "10x10": ["A", "E", "H", "L", "T"],
    "22x22": ["A", "E", "H", "L", "T"],
}


def _render_letter(letter: str, rows: int, cols: int) -> np.ndarray:
    """Nearest-neighbor resample the 5×7 glyph onto a rows×cols raster."""
    glyph = np.array(
        [[int(c) for c in line] for line in _FONT_5x7[letter]], dtype=np.int8
    )  # (7, 5)
    ri = np.clip((np.arange(rows) * 7) // rows, 0, 6)
    ci = np.clip((np.arange(cols) * 5) // cols, 0, 4)
    img = glyph[np.ix_(ri, ci)]
    return (2 * img - 1).astype(np.int8)  # {0,1} → {−1,+1}


def load_dataset(name: str, device=None) -> torch.Tensor:
    """Return (P, N) int8 spin patterns for dataset ``name``."""
    rows, cols = DATASET_SHAPES[name]
    letters = DATASET_LETTERS[name]
    pats = np.stack([_render_letter(c, rows, cols).reshape(-1) for c in letters])
    # Degenerate tiny rasters can collide; nudge collisions apart deterministically.
    for i in range(len(pats)):
        for j in range(i):
            if np.array_equal(pats[i], pats[j]) or np.array_equal(pats[i], -pats[j]):
                pats[i][j % pats.shape[1]] *= -1
    return torch.as_tensor(pats, dtype=torch.int8, device=resolve_device(device))


def n_corrupt_pixels(n_pixels: int, fraction: float) -> int:
    """Exact pixel count flipped at a corruption level (paper convention)."""
    return int(round(n_pixels * fraction))


def corrupt(
    pattern: torch.Tensor,
    fraction: float,
    *,
    generator: Optional[torch.Generator] = None,
    idx=None,
) -> torch.Tensor:
    """Flip ``round(fraction·N)`` distinct pixels of one (N,) pattern.

    The pixels are ``idx`` when given (a tensor or numpy array of distinct
    indices), else drawn without replacement from ``generator`` (a CPU
    ``torch.Generator``).  One of the two is required.
    """
    n = pattern.shape[-1]
    k = n_corrupt_pixels(n, fraction)
    if idx is None:
        if generator is None:
            raise ValueError("corrupt: pass a torch.Generator or explicit indices")
        idx = torch.randperm(n, generator=generator)[:k]
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=pattern.device)
    if idx.numel() != k or torch.unique(idx).numel() != k:
        raise ValueError(f"corrupt: need {k} distinct pixel indices, got {idx.numel()}")
    flip = torch.ones((n,), dtype=torch.int8, device=pattern.device)
    flip[idx] = -1
    return (pattern * flip).to(torch.int8)


def corrupt_batch(
    pattern: torch.Tensor,
    fraction: float,
    trials: int,
    *,
    generator: torch.Generator,
) -> torch.Tensor:
    """(trials, N) independently corrupted copies of one pattern."""
    return torch.stack(
        [corrupt(pattern, fraction, generator=generator) for _ in range(trials)]
    )
