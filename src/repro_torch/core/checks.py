"""Dtype and device contracts for the integer compute paths.

:func:`require_int_dtype` turns a float arriving on an int8/int32 path into
an immediate ``TypeError`` instead of a silent truncation toward zero.
:func:`resolve_device` is the port's device rule: entry points place their
tensors on ``cuda`` unless the caller asks for ``"cpu"``, and a missing GPU
is an error, never a silent fallback to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

_INT_DTYPES = {
    torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool,
}


def require_int_dtype(x, name: str):
    """Return ``x`` after checking it carries an integer/bool dtype.

    ``None`` passes through (optional bias operands).  Accepts tensors and
    numpy arrays.  Floats must be quantized explicitly
    (:func:`repro_torch.core.quantization.quantize_weights`) first.
    """
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        ok = x.dtype in _INT_DTYPES
        dtype = x.dtype
    else:
        dtype = np.asarray(x).dtype
        ok = np.issubdtype(dtype, np.integer) or np.issubdtype(dtype, np.bool_)
    if ok:
        return x
    raise TypeError(
        f"{name} must be an integer array for the int compute path, got "
        f"{dtype}; quantize floats explicitly (e.g. "
        "repro_torch.core.quantization.quantize_weights) before the kernels"
    )


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point places its tensors on.

    ``None`` means the GPU.  Without a GPU that raises: the caller must ask
    for ``device="cpu"`` explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
