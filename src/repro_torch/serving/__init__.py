"""repro_torch.serving — continuous-batching streaming service on the engine
(the port of ``repro.serving``).

A long-lived daemon serving a continuous mixed request stream.  Early-exit
dynamics free solver lanes mid-slab; the scheduler backfills them with
queued requests of the same bucket signature at the next settle-chunk
boundary, bit-exact with solving each request in isolation (per-lane clocks
in :class:`repro_torch.core.dynamics.BatchState`).

Quickstart::

    import torch
    from repro_torch import serving
    from repro_torch.engine import Request

    eng = serving.ContinuousEngine(torch.Generator().manual_seed(0),
                                   tenant_weights={"alpha": 2.0})  # on the GPU
    eng.install("letters", "retrieval", xi=patterns)   # DO-I on the card
    daemon = serving.ServeDaemon(eng, heartbeat_path="/tmp/hb")
    report = daemon.run(source)           # yields Request batches per tick

See :mod:`repro_torch.serving.scheduler` for the tick semantics,
:mod:`repro_torch.serving.admission` for tenant fairness, and
``launch/serve_daemon.py`` for the CLI.
"""

from repro_torch.serving.admission import FairQueues  # noqa: F401
from repro_torch.serving.daemon import ServeDaemon  # noqa: F401
from repro_torch.serving.load import (  # noqa: F401
    install_mixed_workloads,
    mixed_requests,
    poisson_offsets,
    ticked_source,
    timed_source,
)
from repro_torch.serving.scheduler import ContinuousEngine, DrainRejectedError  # noqa: F401
