"""Serving step factories: prefill_step / serve_step and the generate loop
(the port of ``repro.models.steps``, serving subset).

``make_train_step``, ``build_cell`` and ``auto_microbatches`` wait for
training (ROADMAP.md, section 1, item 5).
"""

from __future__ import annotations

import time
from typing import Any, Dict

import torch

from repro_torch.models import params as P
from repro_torch.models.model import Model


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill_fn(params, batch)

    return prefill_step


def make_serve_step(model: Model):
    """One-token greedy decode: (params, cache, token, index) → (next_token,
    logits, cache), the token the first maximal logit, as ``jnp.argmax``
    takes it."""

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


def make_generate(model: Model):
    """Prefill + decode loop with explicit token accounting.

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
    decode = make_serve_step(model)

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
