"""Step factories: train_step / prefill_step / serve_step, the generate
loop and the input specs (the port of ``repro.models.steps``).

Training works on the reference's own parameter tree: ``TrainState.params``
is the nested dict of tensors ``materialize`` makes, layers stacked on
leading axes (``blocks`` (L, …), the VLM's (group, layer, …), Zamba's and
xLSTM's groups, the enc-dec's ``enc_blocks``/``dec_blocks``), and the
gradients come back in the same tree, so the optimizer and the checkpointer
see the reference's shapes and flatten order.  A train step builds the
model's module over the tree (each block's parameters views of its slice of
the stacked leaves), differentiates the loss with respect to those views,
and writes each block's gradient into its slice of the stacked gradient.

Every assigned (architecture × shape) cell resolves to one step function
plus meta-device input stand-ins and their specs (:func:`build_cell`), so
the dry run (``repro_torch.launch.dryrun``) counts the same code the
launchers run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import optim as optim_lib
from repro_torch.models import params as P
from repro_torch.models import tp
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.model import ENCDEC_PREFILL_PROMPT_LEN, Model, get_model
from repro_torch.models.params import torch_dtype


class TrainState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    params: Any  # the reference's parameter tree of tensors
    opt: Any  # the optimizer's state tree


# ---------------------------------------------------------------------------
# Input specs (ParamSpec trees)
# ---------------------------------------------------------------------------


def _tok_spec(b: int, s: int) -> P.ParamSpec:
    return P.ParamSpec((b, s), ("batch", None), dtype=torch.int32, init="zeros")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, P.ParamSpec]:
    """ParamSpec tree for one training/prefill batch of this cell."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, P.ParamSpec] = {}
    if cfg.family == "encdec":
        specs["frames"] = P.ParamSpec(
            (b, s, cfg.d_model), ("batch", None, None), dtype=torch_dtype(cfg.dtype))
        dec_len = s if shape.kind == "train" else ENCDEC_PREFILL_PROMPT_LEN
        specs["tokens"] = _tok_spec(b, dec_len)
        if shape.kind == "train":
            specs["labels"] = _tok_spec(b, dec_len)
        return specs
    specs["tokens"] = _tok_spec(b, s)
    if shape.kind == "train":
        specs["labels"] = _tok_spec(b, s)
    if cfg.family == "vlm":
        specs["vision"] = P.ParamSpec(
            (b, cfg.n_vision_tokens, cfg.vision_dim), ("batch", None, None),
            dtype=torch_dtype(cfg.dtype))
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, model: Model):
    """(cache, token, index) ParamSpec trees for a decode cell."""
    b, s = shape.global_batch, shape.seq_len
    cache = model.cache_specs(b, s)
    token = _tok_spec(b, 1)
    index = P.ParamSpec((), (), dtype=torch.int32, init="zeros")
    return cache, token, index


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _trainable(model: Model, tree) -> Tuple[torch.nn.Module, List[Tuple[str, torch.Tensor]]]:
    """The model's module over ``tree`` with every parameter requiring grad:
    (module, [(dotted name, parameter)]).  A block's parameter is a view of
    its slice of a stacked leaf; its name's integer parts are the slice's
    index, the rest the leaf's path."""
    module = model.build_params(tree)
    named = list(module.named_parameters())
    for _, p in named:
        p.requires_grad_(True)
    return module, named


def _leaf_index(name: str) -> Tuple[str, Tuple[int, ...]]:
    keys = name.split(".")
    return (".".join(k for k in keys if not k.isdigit()),
            tuple(int(k) for k in keys if k.isdigit()))


def _loss_and_parts(model: Model, tree, batch):
    """((loss, metrics), [(leaf path, slice index, gradient)]) of the
    model's loss at ``tree`` on ``batch``; an unused parameter's gradient
    is zeros, as ``jax.grad`` gives it."""
    module, named = _trainable(model, tree)
    loss, metrics = model.loss_fn(module, batch)
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    out = [(*_leaf_index(name), torch.zeros_like(p) if g is None else g)
           for (name, p), g in zip(named, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), out


def _into_tree(tree, parts, accumulate=None):
    """The gradient tree of ``tree``'s shapes and dtypes from per-slice
    ``parts``, or, given ``accumulate`` (a tree of buffers), each part added
    into its slice there in the buffer's dtype."""
    if accumulate is None:
        out = {path: torch.empty_like(leaf) for path, leaf in P.leaves(tree)}
    else:
        out = dict(P.leaves(accumulate))
    with torch.no_grad():
        for path, idx, g in parts:
            if accumulate is None:
                out[path][idx] = g
            else:
                out[path][idx] += g.to(out[path].dtype)
    return P._rebuild(tree, out) if accumulate is None else accumulate


def value_and_grad(model: Model, params, batch: Dict[str, torch.Tensor]):
    """((loss, metrics), grads): the model's loss on ``batch`` (tensors on
    the params' device) and its gradient tree, the params' shapes and
    dtypes (``jax.value_and_grad`` of ``model.loss_fn`` with ``has_aux``)."""
    (loss, metrics), parts = _loss_and_parts(model, params, batch)
    return (loss, metrics), _into_tree(params, parts)


def _replicas(grads, loss, splits):
    """A data-parallel program's step (``models/tp.py``): each replica took
    its share of the batch, so each gradient leaf is summed over the
    ``"batch"`` axes that do not cut it (its FSDP axes were summed into its
    block at use) and the gradients and the loss are divided by the
    replicas: the step on the whole batch.  The identity outside one."""
    lay = tp.current()
    if lay is None or lay.size("batch") == 1:
        return grads, loss
    n, batch = lay.size("batch"), lay.axes("batch")
    cuts = {} if splits is None else {path: sp.over() for path, sp in P.leaves(splits)}
    with torch.no_grad():
        out = {path: tp.psum(g, tuple(a for a in batch if a not in cuts.get(path, ()))) / n
               for path, g in P.leaves(grads)}
        loss = tp.reduce(loss, "batch") / n
    return P._rebuild(grads, out), loss


def make_train_step(
    model: Model,
    optimizer: optim_lib.Optimizer,
    microbatches: int = 1,
    accum_dtype=torch.float32,
    splits=None,
):
    """(TrainState, batch) → (TrainState, metrics).

    The batch's tensors (numpy arrays or tensors) are moved to the params'
    device.  ``microbatches > 1`` runs gradient accumulation: the batch is
    split along its leading axis, each microbatch's gradients are added
    into separate ``accum_dtype`` buffers (never into the parameters'
    ``.grad``), and the loss and the gradients are their means over the
    microbatches; the metrics are the last microbatch's, with ``loss``,
    ``grad_norm`` and ``lr``.

    One device's program (``models/tp.py``; ``splits``: ``tp.splits`` of
    the whole leaves, as the optimizer takes them): the state holds the
    device's blocks, the batch is its replica's share, each microbatch's
    gradient arrives at the blocks (an FSDP leaf's reduce-scattered at its
    use) before it is added into the buffers, and the replicas' gradients
    and losses are joined once a step (:func:`_replicas`)."""

    def train_step(state: TrainState, batch: Dict[str, Any]):
        dev = state.step.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(model, state.params, batch)
        else:
            def split(x):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
                return x.reshape(microbatches, b // microbatches, *x.shape[1:])

            mbatches = {k: split(v) for k, v in batch.items()}
            grads = P.map_tree(lambda p: torch.zeros(p.shape, dtype=accum_dtype, device=p.device),
                               state.params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                (l_i, metrics), parts = _loss_and_parts(
                    model, state.params, {k: v[i] for k, v in mbatches.items()})
                _into_tree(state.params, parts, accumulate=grads)
                del parts
                loss = loss + l_i
            loss = loss / microbatches
            grads = P.map_tree(lambda g: g / microbatches, grads)
        grads, loss = _replicas(grads, loss, splits)

        new_params, new_opt, opt_metrics = optimizer.update(grads, state.opt, state.params)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(state.step + 1, new_params, new_opt), metrics

    return train_step


# Auto-microbatching target: per-device tokens per microbatch.  Activation
# memory scales linearly with this.
MICROBATCH_TOKEN_TARGET = 16384


def auto_microbatches(shape: ShapeConfig, dp_size: int) -> int:
    if shape.kind != "train" or dp_size <= 0:
        return 1
    tokens_per_dev = shape.global_batch * shape.seq_len // dp_size
    mb = max(1, tokens_per_dev // MICROBATCH_TOKEN_TARGET)
    # must divide the per-shard batch
    while (shape.global_batch // dp_size) % mb != 0 and mb > 1:
        mb -= 1
    return mb


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill_fn(params, batch)

    return prefill_step


def make_serve_step(model: Model, sample: str = "greedy"):
    """One-token greedy decode: (params, cache, token, index) → (next_token,
    logits, cache), the token the first maximal logit, as ``jnp.argmax``
    takes it.  ``sample`` is accepted and ignored, as in the reference:
    decoding is greedy."""
    del sample

    def serve_step(params, cache, token, index):
        logits, new_cache = model.decode_fn(params, cache, token, index)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, logits, new_cache

    return serve_step


def graft_cache(cache: Dict[str, torch.Tensor], prefill_cache: Dict[str, torch.Tensor]):
    """Copy the prefill caches into a (longer) decode cache, in place.

    Each prefill leaf lands at the start of its decode leaf: a KV leaf along
    its sequence axis (the rest stays zero; an enc-dec model's cross K/V
    fills the first T_enc of its memory slots), a recurrent state or conv
    buffer of the same shape whole.  The decode cache never aliases the
    prefill cache.  Returns ``cache``.
    """
    for name, dst in cache.items():
        src = prefill_cache[name]
        dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
    return cache


def decode_cache(model: Model, prefill_cache: Dict[str, torch.Tensor], batch: int, total: int,
                 device) -> Dict[str, torch.Tensor]:
    """The decode cache for ``total`` positions from the prefill's: a leaf
    of the decode cache's shape and dtype (a recurrent state, a conv buffer,
    a cross K/V of every memory slot) is the prefill's tensor itself, the
    value a copy would hold; every other leaf is allocated zeroed and the
    prefill's leaf grafted into its start (:func:`graft_cache`)."""
    specs = model.cache_specs(batch, total)
    kept = {name: prefill_cache[name] for name, spec in specs.items()
            if (tuple(prefill_cache[name].shape), prefill_cache[name].dtype)
            == (spec.shape, spec.dtype)}
    grown = {name: spec for name, spec in specs.items() if name not in kept}
    cache = graft_cache(P.materialize(grown, None, device), prefill_cache)
    return {name: cache[name] if name in cache else kept[name] for name in specs}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_generate(model: Model, sample: str = "greedy"):
    """Prefill + decode loop with explicit token accounting (``sample`` is
    accepted and ignored, as in the reference: decoding is greedy).

    Returns ``generate(params, batch_in, max_new_tokens)`` → ``(tokens,
    timing)`` where ``tokens`` is an int32 CPU tensor of shape ``(batch,
    max_new_tokens)`` — always exactly ``max_new_tokens`` columns:

    * token 0 is taken from the prefill logits (the model's prediction at
      the last prompt position);
    * token ``i`` (1 ≤ i < max_new_tokens) is taken by the i-th decode
      step, which consumes token ``i−1`` at sequence index
      ``prompt_len + i − 1``;
    * ``max_new_tokens == 0`` returns a ``(batch, 0)`` tensor (prefill only).

    Every entry of ``batch_in`` (``tokens``, ``vision`` for the VLM,
    ``frames`` for the enc-dec family) is
    moved to the params' device before the prefill.  ``timing`` holds
    ``prefill_s`` and ``decode_s`` on the host clock, each
    ending in a wait on the device.  Every token is read to the host as it
    is made (one read per decode step), as the reference does.

    The reference materializes the decode cache from an explicit key, zeroes
    it and grafts the prefill's into it; the port allocates only the leaves
    that grow (:func:`decode_cache`) zeroed on the params' device, so it
    needs no generator and never holds a recurrent state twice.
    """
    prefill = make_prefill_step(model)
    decode = make_serve_step(model, sample)

    @torch.inference_mode()
    def generate(params, batch_in: Dict[str, Any], max_new_tokens: int):
        device = params.device
        batch = {name: torch.as_tensor(value).to(device) for name, value in batch_in.items()}
        b, prompt_len = batch["tokens"].shape
        t0 = time.perf_counter()
        logits, prefill_cache = prefill(params, batch)
        _sync(device)
        timing = {"prefill_s": time.perf_counter() - t0}
        if max_new_tokens <= 0:
            timing["decode_s"] = 0.0
            return torch.zeros((b, 0), dtype=torch.int32), timing

        cache = decode_cache(model, prefill_cache, b, prompt_len + max_new_tokens, device)
        del prefill_cache

        token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        generated = [token.cpu()]
        t0 = time.perf_counter()
        for i in range(1, max_new_tokens):
            token, logits, cache = decode(params, cache, token, prompt_len + i - 1)
            generated.append(token.cpu())
        timing["decode_s"] = time.perf_counter() - t0
        tokens = torch.cat(generated, dim=1)
        if tokens.shape != (b, max_new_tokens):  # survives python -O
            raise RuntimeError(
                f"generate: produced {tuple(tokens.shape)}, expected ({b}, {max_new_tokens})"
            )
        return tokens, timing

    return generate


# ---------------------------------------------------------------------------
# Cell assembly: everything the dry run needs for one cell
# ---------------------------------------------------------------------------


#: The ``torch.profiler.record_function`` range a train cell's optimizer
#: update runs in: the dry run's memory count reads it as a segment of its own.
UPDATE_RANGE = "train_step.update"


def device_model(model: Model, rules: Dict[str, Any],
                 axis_sizes: Dict[str, int]) -> Tuple[Model, Any]:
    """(``model`` as one device's program runs it, the leaves' splits):
    its ``param_specs`` the blocks a position holds (``tp.local_specs``),
    its ``build_params`` annotated (``tp.annotate``) so that the layers read
    their splits and gather the FSDP blocks, and ``tp.splits`` of the whole
    leaves, which the optimizer and :func:`make_train_step` take."""
    splits = tp.splits(model.param_specs, rules, axis_sizes)
    build = model.build_params
    return (model._replace(param_specs=tp.local_specs(model.param_specs, rules, axis_sizes),
                           build_params=lambda tree: tp.annotate(build(tree), splits)), splits)


@dataclasses.dataclass
class CellProgram:
    """A countable program for one (arch × shape) cell."""

    name: str
    kind: str  # train | prefill | decode
    step_fn: Any
    abstract_args: Tuple[Any, ...]  # meta tensors
    in_specs: Tuple[Any, ...]  # spec trees matching abstract_args
    donate: Tuple[int, ...] = ()
    #: A device's program (``per_device``): the mesh's axis sizes, the axes
    #: the batch is split over (the replicas) and those a decode cache's
    #: sequence is split over.
    sizes: Dict[str, int] = dataclasses.field(default_factory=dict)
    batch: Tuple[str, ...] = ()
    kv_seq: Tuple[str, ...] = ()

    def layout(self, hook: tp.Hook, ranks: Optional[Dict[str, int]] = None) -> tp.Layout:
        """The ``tp.Layout`` of the program's position at ``ranks`` (each
        axis 0 by default) calling ``hook``."""
        return tp.Layout(self.sizes, ranks or {}, hook, batch=self.batch, kv_seq=self.kv_seq)


def build_cell(
    cfg: ModelConfig,
    shape: ShapeConfig,
    rules: Dict[str, Any],
    optimizer_name: Optional[str] = None,
    microbatches: int = 0,
    dp_size: int = 0,
    axis_sizes: Optional[Dict[str, int]] = None,
    accum_dtype=torch.float32,
    per_device: bool = False,
) -> CellProgram:
    """Assemble the step function + abstract inputs + specs for one cell.

    ``microbatches=0`` → auto (see :func:`auto_microbatches`, needs dp_size).
    ``axis_sizes``: mesh axis → size, for divisibility-aware sharding.
    ``per_device``: one device's program (``models/tp.py``): the parameters,
    the optimizer's state and a decode cache at the blocks one position
    holds (``params.local_shape`` under the cell's specs; the batch is the
    replica's share the caller gives in ``shape``), the module annotated so
    that the layers read their splits and gather the FSDP blocks, the
    optimizer and the train step joining their statistics over the blocks;
    the step runs under the layout ``CellProgram.layout`` gives, which the
    caller opens.  ``in_specs`` stay the full leaves' specs.

    The train step takes the parameter tree, as :func:`make_train_step`
    does; its optimizer update runs inside the :data:`UPDATE_RANGE` range.  The prefill and serve steps take the tree too, as the
    reference's do, and build the model's module over it inside.  They run
    under ``torch.no_grad``: the layers take the branches they take under
    :func:`make_generate`'s ``inference_mode`` (autograd off), and a
    dispatch mode sees each composite op's parts (``matmul``'s ``mm``), as
    it does in a train step.  A serve step's ``index`` (a 0-d tensor, as
    the reference's, or a position) on the meta device has no value: the
    step is then taken at the cell's last position, a full cache.
    """
    model = get_model(cfg)
    full_specs = model.param_specs
    sizes = dict(axis_sizes or {})
    splits, program = None, {}

    def pspec_of(tree):
        return P.pspecs(tree, rules, axis_sizes)

    def local(tree):
        return tp.local_specs(tree, rules, sizes) if per_device else tree

    if per_device:
        model, splits = device_model(model, rules, sizes)
        batch = rules.get("batch") or ()
        program = {"sizes": {a: n for a, n in sizes.items() if n > 1},
                   "batch": tuple(a for a in (batch if isinstance(batch, tuple) else (batch,))
                                  if sizes.get(a, 1) > 1)}

    if microbatches == 0:
        microbatches = auto_microbatches(shape, dp_size)

    if shape.kind == "train":
        opt_name = optimizer_name or ("adafactor" if cfg.family == "moe" else "adamw")
        optimizer = optim_lib.get_optimizer(
            opt_name, optim_lib.cosine_warmup(3e-4, 2000, 100_000), splits=splits
        )

        def update(grads, opt_state, params):
            with torch.profiler.record_function(UPDATE_RANGE):
                return optimizer.update(grads, opt_state, params)

        train_step = make_train_step(
            model, optimizer._replace(update=update), microbatches=microbatches,
            accum_dtype=accum_dtype, splits=splits
        )
        state_specs = {
            "step": P.ParamSpec((), (), dtype=torch.int32, init="zeros"),
            "params": full_specs,
            "opt": optimizer.state_specs(full_specs),
        }
        b_specs = batch_specs(cfg, shape)
        return CellProgram(
            name=f"{cfg.name}:{shape.name}",
            kind="train",
            step_fn=train_step,
            abstract_args=(TrainState(**P.abstract(local(state_specs))), P.abstract(b_specs)),
            in_specs=(TrainState(**pspec_of(state_specs)), pspec_of(b_specs)),
            donate=(0,),
            **program,
        )

    if shape.kind == "prefill":
        prefill_step = make_prefill_step(model)

        @torch.no_grad()
        def prefill_cell_step(params, batch):
            return prefill_step(model.build_params(params), batch)

        b_specs = batch_specs(cfg, shape)
        return CellProgram(
            name=f"{cfg.name}:{shape.name}",
            kind="prefill",
            step_fn=prefill_cell_step,
            abstract_args=(P.abstract(model.param_specs), P.abstract(b_specs)),
            in_specs=(pspec_of(full_specs), pspec_of(b_specs)),
            **program,
        )

    # decode
    serve_step = make_serve_step(model)

    @torch.no_grad()
    def serve_cell_step(params, cache, token, index):
        if isinstance(index, torch.Tensor):
            index = shape.seq_len - 1 if index.is_meta else int(index)
        return serve_step(model.build_params(params), cache, token, index)

    cache_specs, token_spec, index_spec = decode_input_specs(cfg, shape, model)
    kv_seq = {sp.axes[i] for (_, spec), (_, sp) in zip(P.leaves(cache_specs),
                                                       P.leaves(tp.splits(cache_specs, rules, sizes)))
              for i, name in enumerate(spec.axes) if name == "kv_seq"}
    if len(kv_seq) > 1:
        raise ValueError(f"{cfg.name}: the cache's kv_seq dims split unevenly: {kv_seq}")
    if per_device:
        program["kv_seq"] = next(iter(kv_seq), ())
    return CellProgram(
        name=f"{cfg.name}:{shape.name}",
        kind="decode",
        step_fn=serve_cell_step,
        abstract_args=(
            P.abstract(model.param_specs),
            P.abstract(local(cache_specs)),
            P.abstract(token_spec),
            P.abstract(index_spec),
        ),
        in_specs=(
            pspec_of(full_specs),
            pspec_of(cache_specs),
            pspec_of(token_spec),
            pspec_of(index_spec),
        ),
        donate=(1,),
        **program,
    )
