"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into its own shared library with a plain C
interface, which ``ctypes`` loads; there is no PyTorch header in the build,
so it takes seconds.  Libraries go into ``_build/`` beside this file (listed
in ``.gitignore``), keyed by a hash of the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and an
unchanged one loads as is.  :func:`build_all` starts
one ``nvcc`` per source at once.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: Source stem → the C entry points it exports, with their ctypes signatures.
_P, _I = ctypes.c_void_p, ctypes.c_int
SOURCES: Dict[str, Dict[str, List]] = {
    "coupling_gemm": {
        # ... (operands, extents), then the launch plan's tile, bm, bn, span
        # (autotune.CouplingPlan.args), then the stream.
        "onn_coupling_sum": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "onn_step": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "onn_phase_step": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "onn_phase_step_packed": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        # mode, then the plan's tile, bm, bn, span; out: six ints (ops.ATTRIBUTES).
        "onn_coupling_gemm_attributes": [_I, _I, _I, _I, _I, _P],
    },
    "phase_step_multi": {
        # ... (operands, extents, packed), then the launch plan's regime,
        # cluster, lanes, rows, shared memory (autotune.MultiPlan.args), then
        # the stream.
        "onn_phase_step_multi": [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
            _I, _I, _I, _I, _I, _P,
        ],
        "onn_phase_step_multi_occupancy": [_I, _I, _I, _I, _I, _P],
        # N, KP, packed, then the plan's regime, cluster, lanes, rows, shared
        # memory; out: six ints (ops.ATTRIBUTES).
        "onn_phase_step_multi_attributes": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "quantized_matvec": {
        "onn_quantized_matvec": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        # the plan's gemv lanes, k_chunk, vector; out: six ints (ops.ATTRIBUTES).
        "onn_quantized_matvec_attributes": [_I, _I, _I, _P],
    },
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return found


def _lib_path(stem: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def build_all(stems: Iterable[str] = tuple(SOURCES)) -> None:
    """Compile every out-of-date source, one ``nvcc`` per source in parallel.

    Each output goes to a temporary name and is renamed into place when its
    build ends, so a concurrent or interrupted build never leaves a partial
    library under the final name.
    """
    jobs = []
    for stem in stems:
        out = _lib_path(stem)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{stem}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((stem, proc, tmp, out))
    errors = []
    for stem, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {stem}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def loaded() -> Tuple[str, ...]:
    """The sources whose library this process has built or loaded."""
    with _LOCK:
        return tuple(_LOADED)


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(stem)
        if lib is not None:
            return lib
        build_all([stem])
        lib = ctypes.CDLL(str(_lib_path(stem)))
        for name, argtypes in SOURCES[stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED[stem] = lib
        return lib
