"""One device's program of a sharded LM step.

The reference hands the whole step to XLA's partitioner, which gives each
device a program of its own.  The port has no partitioner, so a device's
program is the model's own code run on that device's blocks of the
parameters, with its collectives written out (the ONN's counterpart is
``launch.dryrun.OnnProgram``):

* **Blocks.** :func:`splits` gives each leaf its :class:`Split`: the mesh
  axes that ``params.pspecs`` places on each of its dims (``"model"``, the
  FSDP ``"data"``, a cache's ``kv_seq`` axes; an axis whose size does not
  divide the dim leaves it whole), and :func:`local_specs` the block one
  position holds (``params.local_shape``).  A ``"batch"`` dim is not cut:
  the caller gives the program the replica's share of the batch.
  :func:`annotate` records on each level of the built module the split of
  each of its parameters, so that a layer reads how a weight is split over
  ``"model"`` (:func:`parts`); a module without the record (every run
  outside a device's program) reads 1 everywhere and runs as it always did.
* **FSDP.** A parameter split over any other axis is gathered where a
  layer reads it (``transformer.ParamTree.__getitem__`` calls
  :func:`param`): an all-gather over those axes whose backward
  reduce-scatters the gradient over them, so that a train step's gradient
  arrives at the device's block.  The gathered tensor is an activation of
  the layer group that reads it: it is freed after the group runs, and
  remat's recompute gathers it again.
* **Collectives.** A layer that contracts over a split dim leaves a partial
  sum (:func:`reduce`: an all-reduce); one whose output dim is split leaves
  a block of its result (:func:`gather`: an all-gather, where the next op
  needs it whole); a region whose input is whole and whose weights are
  split takes it through :func:`enter`, whose backward all-reduces the
  input's gradient; a statistic of the whole batch sums its replicas'
  parts through :func:`join`.  Each is an ``autograd.Function`` that calls
  the :class:`Layout`'s hook in its forward and its backward, so that a
  train step's forward, its recompute under remat and its backward each
  call it.  The optimizer and the train step sum their per-leaf statistics
  and the gradients' replicas through :func:`psum` (``optim``,
  ``models.steps``).
* **Layouts.** The hook decides what a collective does: count it
  (:class:`CountHook`, the dry run on the meta device), exchange the blocks
  of every position of a mesh run in lock step (:class:`MeshHook`, the
  composed runs of ``tests/test_torch_dryrun_tp.py`` and
  ``tests/test_torch_dryrun_fsdp.py``), or stand in for one that has no
  peers (:class:`IdentityHook`, one device's share on the card).

The points where the layers call these (``models/layers.py``,
``models/ssm.py``, ``models/xlstm.py``, ``models/transformer.py``,
``models/encdec.py``, ``models/hybrid.py``, ``models/model.py``): the
attention's output projection (heads split), the MLP's down projection
(``mlp`` split), the MoE's router logits (``experts`` split: gathered), its
combine (``experts`` or ``expert_mlp`` split) and its balance statistic
(the batch joined), the vocab-split embedding, logits and loss, the SSM's
in-projection and conv (gathered) and out-projection, the mLSTM's
projections, the sLSTM's cell outputs and its feed-forward, and a
``kv_seq``-split decode cache's attention (over the axes that split it).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.models import params as P

_state = threading.local()

#: A hook: ``hook(op, x, axes, dim, side)`` → the collective's result over
#: the group of positions that differ only along the mesh ``axes`` (major
#: first), ``op`` one of ``"all-reduce"`` (the sum of every member's
#: ``x``), ``"all-gather"`` (every member's ``x`` concatenated along
#: ``dim`` in group order) and ``"reduce-scatter"`` (the sum, cut along
#: ``dim`` into one block a member: this member's block).  ``side`` says
#: what moves: ``"params"`` (a parameter's gather, a gradient's
#: reduce-scatter or sum, an optimizer statistic) or ``"tp"`` (the layers'
#: activations, the loss).
Hook = Callable[[str, torch.Tensor, Tuple[str, ...], int, str], torch.Tensor]

OPS = ("all-reduce", "all-gather", "reduce-scatter")
SIDES = ("params", "tp")

#: An axis argument: a mesh axis, a group name of the :class:`Layout`
#: (``"batch"``, ``"kv_seq"``) or a tuple of mesh axes.
Axes = Union[str, Tuple[str, ...]]


class Layout:
    """One device's place in the program: the sizes of the mesh axes it
    splits over, its index along each, the hook its collectives call, and
    the axes of two groups: ``batch`` (the data-parallel replicas, each
    with its share of the batch) and ``kv_seq`` (the blocks of a decode
    cache's sequence)."""

    def __init__(self, sizes: Dict[str, int], ranks: Dict[str, int], hook: Hook, *,
                 batch: Sequence[str] = (), kv_seq: Sequence[str] = ()) -> None:
        self.sizes = dict(sizes)
        self.ranks = dict(ranks)
        self.hook = hook
        self.groups = {"batch": tuple(batch), "kv_seq": tuple(kv_seq)}

    def axes(self, axis: Axes) -> Tuple[str, ...]:
        """The mesh axes ``axis`` names, those of size 1 left out."""
        names = axis if isinstance(axis, tuple) else self.groups.get(axis, (axis,))
        return tuple(a for a in names if self.sizes.get(a, 1) > 1)

    def size(self, axis: Axes) -> int:
        return math.prod(self.sizes[a] for a in self.axes(axis))

    def rank(self, axis: Axes) -> int:
        """This position's index in the group (major axis first)."""
        r = 0
        for a in self.axes(axis):
            r = r * self.sizes[a] + self.ranks.get(a, 0)
        return r

    def call(self, op: str, x: torch.Tensor, axis: Axes, dim: int, side: str) -> torch.Tensor:
        return self.hook(op, x, self.axes(axis), dim, side)


#: The layout of the one program the process runs (``use(shared=True)``):
#: what autograd's own threads (the backward pass and remat's recompute on
#: a CUDA device) read, since a thread-local is theirs alone.  The
#: positions of a mesh run in threads open theirs unshared (on the CPU the
#: backward and the recompute run in the thread that calls them).
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


def rank(axis: Axes = "model") -> int:
    lay = current()
    return 0 if lay is None else lay.rank(axis)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class Split(NamedTuple):
    """How one device's program holds a leaf: for each dim, the mesh axes
    that cut it (major first; none of size 1) and their sizes."""

    axes: Tuple[Tuple[str, ...], ...]
    sizes: Tuple[Tuple[int, ...], ...]

    def parts(self, dim: int, only: Optional[Tuple[str, ...]] = None) -> int:
        """The blocks dim ``dim`` is cut into (by the axes in ``only``)."""
        return math.prod(n for a, n in zip(self.axes[dim], self.sizes[dim])
                         if only is None or a in only)

    def over(self, dims: Optional[Sequence[int]] = None) -> Tuple[str, ...]:
        """The axes that cut any of ``dims`` (every dim by default), sorted."""
        dims = range(len(self.axes)) if dims is None else dims
        return tuple(sorted({a for d in dims for a in self.axes[d]}))

    def full(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The whole leaf's shape from a block's."""
        return tuple(n * self.parts(d) for d, n in enumerate(shape))

    def inner(self, ndim: int) -> "Split":
        """The split of the last ``ndim`` dims (a block of a stacked leaf)."""
        lead = len(self.axes) - ndim
        if any(self.axes[:lead]):
            raise ValueError(f"a stacked dim is split: {self.axes[:lead]}")
        return Split(self.axes[lead:], self.sizes[lead:])


def split_of(spec: P.ParamSpec, rules: Dict[str, Any], axis_sizes: Dict[str, int]) -> Split:
    """The :class:`Split` of ``spec`` under ``rules``: every mesh axis that
    ``params.pspecs`` places on a dim except a ``"batch"`` dim's."""
    pspec = P.logical_to_pspec(spec.axes, rules, spec.shape, axis_sizes)
    axes = []
    for i, name in enumerate(spec.axes):
        entry = () if name == "batch" else _axes(pspec[i] if i < len(pspec) else None)
        axes.append(tuple(a for a in entry if axis_sizes.get(a, 1) > 1))
    return Split(tuple(axes), tuple(tuple(axis_sizes[a] for a in ax) for ax in axes))


def splits(tree, rules: Dict[str, Any], axis_sizes: Dict[str, int]):
    """:func:`split_of` of every leaf of a ParamSpec tree."""
    return P.map_tree(lambda s: split_of(s, rules, axis_sizes), tree)


def local_spec(spec: P.ParamSpec, rules: Dict[str, Any], axis_sizes: Dict[str, int]):
    """``spec`` at the block one device's program holds (module docstring)."""
    sp = split_of(spec, rules, axis_sizes)
    shape = tuple(dim // sp.parts(i) for i, dim in enumerate(spec.shape))
    return P.ParamSpec(shape, spec.axes, dtype=spec.dtype, init=spec.init, scale=spec.scale)


def local_specs(tree, rules: Dict[str, Any], axis_sizes: Dict[str, int]):
    """:func:`local_spec` of every leaf of a ParamSpec tree."""
    return P.map_tree(lambda s: local_spec(s, rules, axis_sizes), tree)


def annotate(module: torch.nn.Module, split_tree) -> torch.nn.Module:
    """Record on each level of ``module`` (built over a tree of
    :func:`local_specs`' shapes) the :class:`Split` of each parameter it
    holds (``split_tree``: :func:`splits` of the whole leaves), less the
    stacked leading dims.  Returns ``module``."""
    full = dict(P.leaves(split_tree))
    for prefix, mod in module.named_modules():
        own = {}
        for name, p in mod.named_parameters(recurse=False):
            path = ".".join(k for k in (f"{prefix}.{name}" if prefix else name).split(".")
                            if not k.isdigit())
            own[name] = full[path].inner(p.dim())
        if own:
            mod._tp_split = own
    return module


def parts(params, name: str, dim: int) -> int:
    """How many blocks the ``"model"`` axis cuts dim ``dim`` of
    ``params[name]`` into: 1 outside a device's program."""
    own = getattr(params, "_tp_split", None)
    if own is None or current() is None:
        return 1
    return own[name].parts(dim, ("model",))


def seq_blocks() -> int:
    """How many blocks split a decode cache's sequence (the ``kv_seq`` axes)."""
    lay = current()
    return 1 if lay is None else lay.size("kv_seq")


def chunk(x: torch.Tensor, dim: int, n: int, axis: Axes = "model") -> torch.Tensor:
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
        return layout.call("all-reduce", x, axis, -1, "tp")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Join(torch.autograd.Function):
    # every replica's loss reads the sum, and the replicas' losses are
    # summed: the gradient of each part is the sum of theirs
    @staticmethod
    def forward(ctx, x, layout, axis):
        ctx.layout, ctx.axis = layout, axis
        return layout.call("all-reduce", x, axis, -1, "tp")

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.call("all-reduce", g, ctx.axis, -1, "tp"), None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axis):
        ctx.layout, ctx.axis = layout, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.call("all-reduce", g, ctx.axis, -1, "tp"), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axis, dim):
        ctx.layout, ctx.axis, ctx.dim, ctx.size = layout, axis, dim, x.shape[dim]
        return layout.call("all-gather", x, axis, dim, "tp")

    @staticmethod
    def backward(ctx, g):
        # every position computes the same function of the gathered tensor,
        # so its gradient is whole on each: keep this position's block
        r = ctx.layout.rank(ctx.axis)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size), None, None, None


class _Use(torch.autograd.Function):
    # a parameter's block gathered for a layer; the replicas' gradients of
    # the whole are summed into each one's block
    @staticmethod
    def forward(ctx, x, layout, axes, dim):
        ctx.layout, ctx.axes, ctx.dim = layout, axes, dim
        return layout.call("all-gather", x, axes, dim, "params")

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.call("reduce-scatter", g, ctx.axes, ctx.dim, "params"), None, None, None


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce(x: torch.Tensor, axis: Axes = "model") -> torch.Tensor:
    """The sum of every position's partial ``x`` along ``axis``."""
    lay = current()
    if lay is None or lay.size(axis) == 1:
        return x
    if _recorded(x):
        return _Reduce.apply(x, lay, axis)
    return lay.call("all-reduce", x, axis, -1, "tp")


def join(x: torch.Tensor, axis: Axes = "batch") -> torch.Tensor:
    """The sum of the replicas' parts ``x`` of a whole-batch statistic that
    each replica's loss reads; its gradient the sum of theirs."""
    lay = current()
    if lay is None or lay.size(axis) == 1:
        return x
    if _recorded(x):
        return _Join.apply(x, lay, axis)
    return lay.call("all-reduce", x, axis, -1, "tp")


def enter(x: torch.Tensor, axis: Axes = "model") -> torch.Tensor:
    """``x`` entering a region whose weights are split along ``axis``: the
    identity, its gradient all-reduced."""
    lay = current()
    if lay is None or lay.size(axis) == 1 or not _recorded(x):
        return x
    return _Enter.apply(x, lay, axis)


def gather(x: torch.Tensor, dim: int, axis: Axes = "model") -> torch.Tensor:
    """Every position's block of ``x`` along ``dim``, concatenated in order."""
    lay = current()
    if lay is None or lay.size(axis) == 1:
        return x
    dim = dim % x.dim()
    if _recorded(x):
        return _Gather.apply(x, lay, axis, dim)
    return lay.call("all-gather", x, axis, dim, "tp")


def psum(x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
    """``x`` summed over the mesh ``axes`` (a parameter-side all-reduce:
    an optimizer statistic, a gradient's replicas); the identity over no
    axis or axes of size 1."""
    lay = current()
    if lay is None:
        if axes:
            raise RuntimeError(f"a sum over {tuple(axes)} outside a device's program")
        return x
    if lay.size(tuple(axes)) == 1:
        return x
    return lay.call("all-reduce", x, tuple(axes), -1, "params")


def param(module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name`` as a layer reads it: gathered over
    every axis other than ``"model"`` that splits it (FSDP)."""
    value = getattr(module, name)
    own = getattr(module, "_tp_split", None)
    sp = None if own is None else own.get(name)
    if sp is None or not any(a != "model" for ax in sp.axes for a in ax):
        return value
    lay = current()
    if lay is None:
        raise RuntimeError(f"parameter {name!r} is a block split over {sp.axes}, read outside "
                           f"a device's program")
    for dim, ax in enumerate(sp.axes):
        outer = tuple(a for a in ax if a != "model")
        if not outer:
            continue
        if len(outer) != len(ax):
            raise NotImplementedError(f"parameter {name!r}: dim {dim} is split over {ax}")
        if lay.size(outer) != sp.parts(dim):
            raise ValueError(f"parameter {name!r}: the layout's {outer} hold "
                             f"{lay.size(outer)} blocks, the program {sp.parts(dim)}")
        if _recorded(value):
            value = _Use.apply(value, lay, outer, dim)
        else:
            value = lay.call("all-gather", value, outer, dim, "params")
    return value


# ---------------------------------------------------------------------------
# Hooks
# ---------------------------------------------------------------------------


def _resized(x: torch.Tensor, dim: int, op: str, s: int) -> Tuple[int, ...]:
    """The shape of ``op``'s result over ``s`` members."""
    shape = list(x.shape)
    shape[dim] = shape[dim] * s if op == "all-gather" else shape[dim] // s
    return tuple(shape)


def _check(op: str, side: str) -> None:
    if op not in OPS or side not in SIDES:
        raise ValueError(f"unknown collective {op!r} on side {side!r}")


class CountHook:
    """Counts each collective by op (``counts``) and wire bytes per device
    (``bytes``, with ``launch.hlo_analysis.WIRE_FACTOR``'s ring factors: an
    all-reduce moves 2(s−1)/s of its buffer, an all-gather (s−1)/s of its
    output, a reduce-scatter s−1 times its output), in all and by side
    (``sides[side]["counts"]``, ``["bytes"]``), and returns a stand-in of
    the result's shape: ``x`` itself for an all-reduce (in place), a new
    tensor otherwise (made where the counting mode sees its storage)."""

    def __init__(self, sizes: Dict[str, int]) -> None:
        from repro_torch.launch.hlo_analysis import WIRE_FACTOR

        self.sizes = sizes
        self.factor = WIRE_FACTOR
        self.counts: Dict[str, int] = {}
        self.bytes: Dict[str, float] = {}
        self.sides = {s: {"counts": {}, "bytes": {}} for s in SIDES}

    def __call__(self, op: str, x: torch.Tensor, axes: Tuple[str, ...], dim: int,
                 side: str) -> torch.Tensor:
        _check(op, side)
        s = math.prod(self.sizes[a] for a in axes)
        if op == "all-reduce":
            out = x
        else:
            out = torch.empty(_resized(x, dim, op, s), dtype=x.dtype, device=x.device)
        wire = self.factor[op](s) * out.nbytes
        for counts, byts in ((self.counts, self.bytes),
                             (self.sides[side]["counts"], self.sides[side]["bytes"])):
            counts[op] = counts.get(op, 0) + 1
            byts[op] = byts.get(op, 0.0) + wire
        return out


class IdentityHook:
    """One device run alone, with no peers: an all-reduce returns its own
    partial sum, an all-gather its block repeated (the shape the program
    goes on with), a reduce-scatter the first block of its input (a copy:
    the block a position holds).  Counts the calls by op."""

    def __init__(self, sizes: Dict[str, int]) -> None:
        self.sizes = sizes
        self.counts: Dict[str, int] = {}

    def __call__(self, op: str, x: torch.Tensor, axes: Tuple[str, ...], dim: int,
                 side: str) -> torch.Tensor:
        _check(op, side)
        self.counts[op] = self.counts.get(op, 0) + 1
        s = math.prod(self.sizes[a] for a in axes)
        if op == "all-reduce":
            return x
        if op == "all-gather":
            reps = [1] * x.dim()
            reps[dim] = s
            return x.repeat(*reps)
        return x.narrow(dim, 0, x.shape[dim] // s).clone()


class MeshHook:
    """The positions of a mesh run in lock step, one thread each: every
    collective waits for every position, then sums (in group order) or
    concatenates the tensors of the position's group: the positions whose
    ranks differ from its own only along the collective's axes.
    ``bind(ranks)`` gives the hook of the position at ``ranks`` (axis →
    index, every axis of ``sizes``)."""

    def __init__(self, sizes: Dict[str, int], n_threads: int) -> None:
        self.sizes = sizes
        self.barrier = threading.Barrier(n_threads)
        self.slots: Dict[Tuple, torch.Tensor] = {}
        self.lock = threading.Lock()

    def bind(self, ranks: Dict[str, int]) -> Hook:
        """The hook of the position at ``ranks``."""
        key = tuple(sorted(ranks.items()))

        def hook(op: str, x: torch.Tensor, axes: Tuple[str, ...], dim: int,
                 side: str) -> torch.Tensor:
            _check(op, side)
            with self.lock:
                self.slots[key] = x
            self.barrier.wait()
            peers: List[torch.Tensor] = []
            mine = 0
            for i, idx in enumerate(itertools.product(*(range(self.sizes[a]) for a in axes))):
                other = dict(ranks, **dict(zip(axes, idx)))
                peers.append(self.slots[tuple(sorted(other.items()))])
                mine = i if other == ranks else mine
            if op == "all-gather":
                out = torch.cat(peers, dim=dim)
            else:
                out = peers[0].clone()
                for p in peers[1:]:
                    out = out + p
                if op == "reduce-scatter":
                    size = out.shape[dim] // len(peers)
                    out = out.narrow(dim, mine * size, size).clone()
            self.barrier.wait()
            return out

        return hook
