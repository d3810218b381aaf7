"""Fault-tolerant checkpointing: atomic writes, retention, restore onto a
device (the port of ``repro.checkpoint``), in the reference's format.

* A checkpoint is a directory ``step_<n>/`` holding ``arrays.npz`` (every
  leaf, keyed by its ``//``-joined path: ``step``, ``params//blocks//attn//wq``,
  ``opt//m//…``, ``opt//count``) and ``meta.json`` (step, leaf count, the
  dtypes numpy cannot hold, wall time, and the caller's metadata such as the
  data cursor).  bfloat16 leaves are stored as their ``uint16`` bit pattern
  with ``"bfloat16"`` recorded under ``dtypes``.  A checkpoint either side
  writes, the other restores bit for bit.
* **Atomic**: written to ``step_<n>.tmp`` then ``os.replace``d — a crash
  mid-write never corrupts the latest checkpoint.
* **Retention**: the ``keep`` newest checkpoints are kept, older ones deleted.
* **Auto-resume**: ``latest_step`` scans for the newest *complete* directory.
* **Restore**: :func:`restore` rebuilds the structure of a target tree on a
  device, or onto a mesh: given ``shardings`` (a tree of
  ``distributed.sharding.NamedSharding`` or None), a sharded leaf comes
  back as a ``ShardedTensor``, each mesh position's block on its device.
* **Async**: :class:`AsyncCheckpointer` copies the tree to host memory
  synchronously and writes it on a background thread.

A tree is nested dicts (keys in sorted order), NamedTuples (fields in order,
keyed by name), lists or tuples (keyed by index) and leaves (tensors, numpy
arrays or numbers), flattened in the reference's order.

ONN checkpoints (a trained, quantized coupling matrix and its config
header) live in :mod:`repro_torch.checkpoint.onn`, re-exported here.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.onn import OnnCheckpoint, load_onn, save_onn  # noqa: F401
from repro_torch.core.checks import resolve_device
from repro_torch.distributed.sharding import NamedSharding, place

_SEP = "//"
_STEP_RE = re.compile(r"^step_(\d+)$")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree):
    """(key, child) of a container in flatten order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    if tree is None:  # an empty subtree, as in the reference
        return []
    items = _items(tree)
    if items is None:
        return [(_SEP.join(prefix), tree)]
    out = []
    for key, child in items:
        out.extend(_flatten(child, prefix + (key,)))
    return out


def _unflatten(tree, values: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, prefix + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(v, values, prefix + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, values, prefix + (str(i),)) for i, v in enumerate(tree))
    return values[_SEP.join(prefix)]


def _to_numpy(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """(the array to store, "bfloat16" for a bf16 leaf stored as uint16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # a reference (ml_dtypes) array
        return arr.view(np.uint16), "bfloat16"
    return arr, None


def _flatten_arrays(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat, dtypes = {}, {}
    for key, leaf in _flatten(tree):
        flat[key], dtype = _to_numpy(leaf)
        if dtype is not None:
            dtypes[key] = dtype
    return flat, dtypes


def save(
    directory: str,
    step: int,
    tree: Any,
    *,
    extra_meta: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> str:
    """Write one checkpoint atomically; enforce retention.  Returns its path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat, dtypes = _flatten_arrays(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {
        "step": int(step),
        "n_leaves": len(flat),
        "dtypes": dtypes,
        "time": time.time(),
        **(extra_meta or {}),
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit
    _enforce_retention(directory, keep)
    return final


def _enforce_retention(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and _is_complete(os.path.join(directory, name)):
            out.append(int(m.group(1)))
    return sorted(out)


def _is_complete(path: str) -> bool:
    return os.path.exists(os.path.join(path, "meta.json")) and os.path.exists(
        os.path.join(path, "arrays.npz")
    )


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def load_meta(directory: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(directory, f"step_{step}", "meta.json")) as f:
        return json.load(f)


def _tensor(arr: np.ndarray, stored: Optional[str]) -> torch.Tensor:
    if stored == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _sharding_leaves(target, shardings, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """The entry of ``shardings`` (a tree of ``target``'s structure) at each
    leaf path of ``target``: a ``NamedSharding`` or None.  A None or a
    ``NamedSharding`` where ``target`` has a subtree covers all of it."""
    if shardings is None or isinstance(shardings, NamedSharding):
        return {key: shardings for key, _ in _flatten(target, prefix)}
    items = _items(target)
    if items is None:
        raise ValueError(f"shardings at {_SEP.join(prefix)!r}: {shardings!r} is not a "
                         "NamedSharding or None")
    sub = dict(_items(shardings) or ())
    out: Dict[str, Any] = {}
    for key, child in items:
        if key not in sub:
            raise ValueError(f"shardings lack {_SEP.join(prefix + (key,))!r}")
        out.update(_sharding_leaves(child, sub[key], prefix + (key,)))
    return out


def restore(directory: str, step: int, target: Any, device=None, shardings: Any = None) -> Any:
    """Restore a checkpoint into the structure of ``target``.

    ``target``'s leaves (tensors, or anything with a torch ``dtype`` such as
    a ``ParamSpec``) give the dtypes; a stored array of another dtype is
    cast.  The leaves land on ``device``; without it, on the target leaf's
    own device (a leaf without one: the GPU, as the port's entry points
    default).

    ``shardings``, the reference's elastic restore: a tree matching
    ``target`` whose entries are None or a
    ``distributed.sharding.NamedSharding`` (``params.shardings`` makes one
    from the rules and a mesh).  A leaf with a sharding comes back as a
    ``distributed.sharding.ShardedTensor``: each mesh position's block
    (``params.local_shape`` of the leaf) cut from the stored array and
    copied to that position's device alone; a split that does not divide
    its dim raises ``ValueError``, as ``jax.device_put`` does.  A leaf whose
    entry is None is restored as without ``shardings``.
    """
    path = os.path.join(directory, f"step_{step}", "arrays.npz")
    stored = load_meta(directory, step).get("dtypes", {})
    placed = _sharding_leaves(target, shardings)
    values = {}
    with np.load(path) as data:
        for key, leaf in _flatten(target):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = _tensor(data[key], stored.get(key))
            dtype = getattr(leaf, "dtype", None)
            if isinstance(dtype, torch.dtype) and t.dtype != dtype:
                t = t.to(dtype)
            if placed[key] is not None:
                values[key] = place(t, placed[key])
                continue
            if device is not None:
                dev = resolve_device(device)
            elif isinstance(leaf, torch.Tensor):
                dev = leaf.device
            else:
                dev = resolve_device(None)
            values[key] = t.to(dev)
    return _unflatten(target, values)


def _host_copy(tree):
    """The tree with every tensor copied to the host now."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_host_copy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at-most-one in flight.

    ``save`` copies the tree to host memory synchronously (device→host) and
    returns; the disk write overlaps the next steps.  A new save waits for
    the previous write to finish (bounded memory); an error of the write is
    raised by the next ``save`` or ``wait``.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra_meta: Optional[Dict[str, Any]] = None):
        self.wait()
        host_tree = _host_copy(tree)  # snapshot now

        def _write():
            try:
                save(self.directory, step, host_tree, extra_meta=extra_meta, keep=self.keep)
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
