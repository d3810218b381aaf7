"""One device's program of a tensor-parallel LM step.

The reference hands the whole step to XLA's partitioner, which gives each
device a program of its own.  The port has no partitioner, so a device's
program is the model's own code run on that device's blocks of the
parameters, with its collectives written out (the ONN's counterpart is
``launch.dryrun.OnnProgram``):

* **Blocks.** :func:`local_specs` gives each leaf the block one position of
  the ``"model"`` axis holds (``params.local_shape`` over ``"model"`` alone;
  the FSDP axes are gathered at use, so the program sees those whole), and
  a decode cache's ``kv_seq`` its block over the axes it is split on.
  :func:`annotate` records on each level of the built module the full
  shape of each of its parameters, so that a layer reads how a weight is
  split (:func:`parts`); a module without the record (every run outside a
  device's program) reads 1 everywhere and runs as it always did.
* **Collectives.** A layer that contracts over a split dim leaves a partial
  sum (:func:`reduce`: an all-reduce); one whose output dim is split leaves
  a block of its result (:func:`gather`: an all-gather, where the next op
  needs it whole); a region whose input is whole and whose weights are
  split takes it through :func:`enter`, whose backward all-reduces the
  input's gradient.  Each is an ``autograd.Function`` that calls the
  :class:`Layout`'s hook in its forward and its backward, so that a train
  step's forward, its recompute under remat and its backward each call it.
* **Layouts.** The hook decides what a collective does: count it
  (:class:`CountHook`, the dry run on the meta device), exchange the blocks
  of every position of a mesh run in lock step (the composed runs of
  ``tests/test_torch_dryrun.py``), or stand in for one that has no peers
  (:class:`IdentityHook`, one device's share on the card).

The points where the layers call these (``models/layers.py``,
``models/ssm.py``, ``models/xlstm.py``, ``models/transformer.py``,
``models/encdec.py``, ``models/hybrid.py``, ``models/model.py``): the
attention's output projection (heads split), the MLP's down projection
(``mlp`` split), the MoE's router logits (``experts`` split: gathered) and
its combine (``experts`` or ``expert_mlp`` split), the vocab-split
embedding, logits and loss, the SSM's in-projection and conv (gathered) and
out-projection, the mLSTM's projections, the sLSTM's cell outputs and its
feed-forward, and a ``kv_seq``-split decode cache's attention (over the
axes that split it).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models import params as P

_state = threading.local()

#: A hook: ``hook(op, x, axis, dim)`` → the collective's result, ``op`` one
#: of ``"all-reduce"`` (the sum of every position's ``x``) and
#: ``"all-gather"`` (every position's ``x`` concatenated along ``dim`` in
#: axis order), over the mesh axis ``axis``.
Hook = Callable[[str, torch.Tensor, str, int], torch.Tensor]


class Layout:
    """One device's place in the program: the sizes of the axes it splits
    over (``"model"``; the axes a ``kv_seq`` cache is split on, under
    ``"kv_seq"``), its index along each, and the hook its collectives
    call."""

    def __init__(self, sizes: Dict[str, int], ranks: Dict[str, int], hook: Hook) -> None:
        self.sizes = dict(sizes)
        self.ranks = dict(ranks)
        self.hook = hook

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def rank(self, axis: str) -> int:
        return self.ranks.get(axis, 0)


#: The layout of the one program the process runs (``use(shared=True)``):
#: what autograd's own threads (the backward pass and remat's recompute on
#: a CUDA device) read, since a thread-local is theirs alone.  The
#: positions of a mesh run in threads (forward-only) open theirs unshared.
_shared: List[Optional[Layout]] = [None]


@contextlib.contextmanager
def use(layout: Optional[Layout], *, shared: bool = False):
    """Run a device's program under ``layout`` (thread-local); ``shared``:
    also the layout of every thread that opens none (one program in the
    process, trained with autograd)."""
    prev, prev_shared = getattr(_state, "layout", None), _shared[0]
    _state.layout = layout
    if shared:
        _shared[0] = layout
    try:
        yield layout
    finally:
        _state.layout = prev
        if shared:
            _shared[0] = prev_shared


def current() -> Optional[Layout]:
    lay = getattr(_state, "layout", None)
    return _shared[0] if lay is None else lay


def rank(axis: str = "model") -> int:
    lay = current()
    return 0 if lay is None else lay.rank(axis)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_spec(spec: P.ParamSpec, rules: Dict[str, Any], axis_sizes: Dict[str, int]):
    """``spec`` at the block one device's program holds: each dim over the
    ``"model"`` axis, and a ``kv_seq`` dim over every axis that splits it,
    as ``params.pspecs`` places them (a size that does not divide stays
    whole)."""
    pspec = P.logical_to_pspec(spec.axes, rules, spec.shape, axis_sizes)
    shape = []
    for i, dim in enumerate(spec.shape):
        entry = _axes(pspec[i] if i < len(pspec) else None)
        keep = entry if spec.axes[i] == "kv_seq" else tuple(a for a in entry if a == "model")
        parts = 1
        for a in keep:
            parts *= axis_sizes.get(a, 1)
        shape.append(dim // parts)
    return P.ParamSpec(tuple(shape), spec.axes, dtype=spec.dtype, init=spec.init,
                       scale=spec.scale)


def local_specs(tree, rules: Dict[str, Any], axis_sizes: Dict[str, int]):
    """:func:`local_spec` of every leaf of a ParamSpec tree."""
    return P.map_tree(lambda s: local_spec(s, rules, axis_sizes), tree)


def annotate(module: torch.nn.Module, full_tree) -> torch.nn.Module:
    """Record on each level of ``module`` (built over a tree of
    :func:`local_specs`' shapes) the full shape of each parameter it holds:
    the full leaf's shape less its stacked leading dims.  Returns
    ``module``."""
    full = dict(P.leaves(full_tree))
    for prefix, mod in module.named_modules():
        own = {}
        for name, p in mod.named_parameters(recurse=False):
            path = ".".join(k for k in (f"{prefix}.{name}" if prefix else name).split(".")
                            if not k.isdigit())
            shape = full[path].shape
            own[name] = tuple(shape[len(shape) - p.dim():])
        if own:
            mod._tp_full = own
    return module


def parts(params, name: str, dim: int) -> int:
    """How many blocks the ``"model"`` axis cuts dim ``dim`` of
    ``params[name]`` into: 1 outside a device's program."""
    full = getattr(params, "_tp_full", None)
    if full is None or current() is None:
        return 1
    return full[name][dim] // params[name].shape[dim]


def seq_blocks() -> int:
    """How many blocks split a decode cache's sequence (the ``kv_seq`` axes)."""
    lay = current()
    return 1 if lay is None else lay.size("kv_seq")


def chunk(x: torch.Tensor, dim: int, n: int, axis: str = "model") -> torch.Tensor:
    """This device's block of ``x`` cut into ``n`` along ``dim``."""
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, rank(axis) * size, size)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axis):
        ctx.layout = layout
        return layout.hook("all-reduce", x, axis, -1)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axis):
        ctx.layout, ctx.axis = layout, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.hook("all-reduce", g, ctx.axis, -1), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axis, dim):
        ctx.layout, ctx.axis, ctx.dim, ctx.size = layout, axis, dim, x.shape[dim]
        return layout.hook("all-gather", x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        # every position computes the same function of the gathered tensor,
        # so its gradient is whole on each: keep this position's block
        r = ctx.layout.rank(ctx.axis)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size), None, None, None


def reduce(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The sum of every position's partial ``x`` along ``axis``."""
    lay = current()
    if lay is None or lay.size(axis) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Reduce.apply(x, lay, axis)
    return lay.hook("all-reduce", x, axis, -1)


def enter(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """``x`` entering a region whose weights are split along ``axis``: the
    identity, its gradient all-reduced."""
    lay = current()
    if lay is None or lay.size(axis) == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Enter.apply(x, lay, axis)


def gather(x: torch.Tensor, dim: int, axis: str = "model") -> torch.Tensor:
    """Every position's block of ``x`` along ``dim``, concatenated in order."""
    lay = current()
    if lay is None or lay.size(axis) == 1:
        return x
    dim = dim % x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, lay, axis, dim)
    return lay.hook("all-gather", x, axis, dim)


# ---------------------------------------------------------------------------
# Hooks
# ---------------------------------------------------------------------------


def _gathered(x: torch.Tensor, dim: int, n: int) -> Tuple[int, ...]:
    shape = list(x.shape)
    shape[dim] *= n
    return tuple(shape)


class CountHook:
    """Counts each collective by op (``counts``) and wire bytes per device
    (``bytes``, with ``launch.hlo_analysis.WIRE_FACTOR``'s ring factors: an
    all-reduce moves 2(s−1)/s of its buffer, an all-gather (s−1)/s of its
    output), and returns a stand-in of the result's shape: ``x`` itself
    for an all-reduce (in place), a new tensor for an all-gather (made where
    the counting mode sees its storage)."""

    def __init__(self, sizes: Dict[str, int]) -> None:
        from repro_torch.launch.hlo_analysis import WIRE_FACTOR

        self.sizes = sizes
        self.factor = WIRE_FACTOR
        self.counts: Dict[str, int] = {}
        self.bytes: Dict[str, float] = {}

    def __call__(self, op: str, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        s = self.sizes[axis]
        out = x if op == "all-reduce" else torch.empty(_gathered(x, dim, s), dtype=x.dtype,
                                                       device=x.device)
        self.counts[op] = self.counts.get(op, 0) + 1
        self.bytes[op] = self.bytes.get(op, 0.0) + self.factor[op](s) * out.nbytes
        return out


class IdentityHook:
    """One device run alone, with no peers: an all-reduce returns its own
    partial sum, an all-gather its block repeated (the shape the program
    goes on with).  Counts the calls by op."""

    def __init__(self, sizes: Dict[str, int]) -> None:
        self.sizes = sizes
        self.counts: Dict[str, int] = {}

    def __call__(self, op: str, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        self.counts[op] = self.counts.get(op, 0) + 1
        if op == "all-reduce":
            return x
        reps = [1] * x.dim()
        reps[dim] = self.sizes[axis]
        return x.repeat(*reps)


class MeshHook:
    """The positions of a mesh run in lock step, one thread each: every
    collective waits for the position's peers along its axis and returns
    the sum (in position order) or the concatenation of their tensors.
    ``grid`` maps a position's ranks (a dict axis → index) to its slot."""

    def __init__(self, sizes: Dict[str, int], n_threads: int) -> None:
        self.sizes = sizes
        self.barrier = threading.Barrier(n_threads)
        self.slots: Dict[Tuple, torch.Tensor] = {}
        self.lock = threading.Lock()

    def bind(self, ranks: Dict[str, int]) -> Hook:
        """The hook of the position at ``ranks``."""

        def hook(op: str, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
            key = tuple(sorted(ranks.items()))
            with self.lock:
                self.slots[key] = x
            self.barrier.wait()
            peers: List[torch.Tensor] = []
            for r in range(self.sizes[axis]):
                other = dict(ranks, **{axis: r})
                peers.append(self.slots[tuple(sorted(other.items()))])
            if op == "all-reduce":
                out = peers[0].clone()
                for p in peers[1:]:
                    out = out + p
            else:
                out = torch.cat(peers, dim=dim)
            self.barrier.wait()
            return out

        return hook
