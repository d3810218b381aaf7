"""Deterministic synthetic token pipeline with a checkpointable cursor (the
port of ``repro.data.tokens``: numpy only, the same batches, ``==``).

Production shape without production data: an infinite token stream that is

* **deterministic** — batch ``i`` is a pure function of (seed, i), so a
  restore-from-checkpoint resumes the exact stream (no repeated/skipped data),
* **host-sharded** — each host materializes only its slice of the global
  batch (``host_id``/``n_hosts``), the multi-host layout of a real loader,
* **prefetched** — a background thread keeps ``prefetch`` batches ready so
  host-side generation overlaps device compute,
* **structured** — tokens follow a repeating-ngram mixture (not iid uniform),
  so a training loss that *decreases* actually demonstrates learning in the
  examples.

State to checkpoint: just the integer cursor (``state()``/``restore()``).
Batches are numpy int32 arrays on the host; the trainer moves them to its
device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class TokenStream:
    """An infinite stream of ``{"tokens", "labels"}`` int32 batches of
    (batch // n_hosts, seq_len), batch ``i`` a function of (seed, i,
    host_id)."""

    def __init__(
        self,
        vocab: int,
        batch: int,
        seq_len: int,
        *,
        seed: int = 0,
        host_id: int = 0,
        n_hosts: int = 1,
        ngram: int = 8,
        prefetch: int = 2,
    ):
        if batch % n_hosts:
            raise ValueError("global batch must divide across hosts")
        self.vocab = vocab
        self.global_batch = batch
        self.local_batch = batch // n_hosts
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.ngram = ngram
        self._cursor = 0
        self._prefetch = prefetch
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- deterministic generation ------------------------------------------

    def _gen(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, index, self.host_id))
        b, s, g = self.local_batch, self.seq_len, self.ngram
        # structured stream: a few base n-grams repeated with noise
        n_motifs = 32
        motifs = np.random.default_rng(self.seed).integers(
            0, self.vocab, size=(n_motifs, g)
        )
        picks = rng.integers(0, n_motifs, size=(b, (s + g) // g + 1))
        toks = motifs[picks].reshape(b, -1)[:, : s + 1]
        noise = rng.random((b, s + 1)) < 0.05
        toks = np.where(noise, rng.integers(0, self.vocab, size=(b, s + 1)), toks)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    # -- cursor (checkpoint state) ------------------------------------------

    def state(self) -> Dict[str, int]:
        return {"cursor": self._cursor, "seed": self.seed}

    def restore(self, state: Dict[str, int]) -> None:
        if state["seed"] != self.seed:
            raise ValueError("restoring a different stream")
        self._cursor = int(state["cursor"])
        self._restart_prefetch()

    # -- iteration -----------------------------------------------------------

    def _restart_prefetch(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._prefetch)
        start = self._cursor
        stop = self._stop

        def worker(idx=start):
            while not stop.is_set():
                item = (idx, self._gen(idx))
                while not stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                idx += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._queue is None:
            self._restart_prefetch()
        while True:
            yield self.next()

    def next(self) -> Dict[str, np.ndarray]:
        if self._queue is None:
            self._restart_prefetch()
        idx, item = self._queue.get()
        if idx != self._cursor:
            raise RuntimeError("prefetch out of sync")
        self._cursor += 1
        return item

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._queue = None
