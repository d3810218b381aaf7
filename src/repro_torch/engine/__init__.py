"""repro_torch.engine — async, shape-bucketed solver engine (the port of
``repro.engine``, serving the "retrieval" and "maxcut" workloads).

One surface for every serving loop::

    import torch
    from repro_torch import api, engine

    eng = engine.Engine(torch.Generator().manual_seed(0))      # on the GPU
    eng.install("letters", api.RetrievalSolver(cfg, params).as_engine_solver())
    fut = eng.submit(engine.Request("letters", corrupted_batch))
    eng.drain()
    result = fut.result()

Pass ``device="cpu"`` to :class:`Engine` (and place the solver there) to
serve on the CPU.  See :mod:`repro_torch.engine.engine` for the engine
itself and its randomness contract, :mod:`repro_torch.engine.bucketing` for
the shape buckets, :mod:`repro_torch.engine.planner` for the
time-to-solution planner, and :mod:`repro_torch.engine.adapters` for the
built-in workloads.
"""

from repro_torch.engine.bucketing import (  # noqa: F401
    DEFAULT_BATCH_BUCKETS,
    bucket_batch,
    bucket_n,
    chop,
)
from repro_torch.engine.engine import (  # noqa: F401
    Engine,
    EngineSolver,
    QueueFullError,
    Request,
)
from repro_torch.engine.planner import Estimate, Planner  # noqa: F401
from repro_torch.engine.registry import (  # noqa: F401
    available_solvers,
    register_solver,
    solver_factory,
)

# Built-in workload registrations: "retrieval" and "maxcut" register from
# repro_torch.api next to the Solver classes they wrap.
from repro_torch.engine import adapters  # noqa: E402,F401
from repro_torch import api as _api  # noqa: E402,F401  (registers "retrieval", "maxcut")
