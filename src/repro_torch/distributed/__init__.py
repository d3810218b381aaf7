"""Distributed execution: the ShardPlan API, the sharding context and the
fault-tolerance primitives (the port of ``repro.distributed``).

The public surface for parallel solves is :class:`ShardPlan` and its
:class:`Mesh` (:mod:`repro_torch.distributed.plan`); the placement of the
coupling matrix (:mod:`repro_torch.distributed.sharding`) and the
fault-tolerance primitives (:mod:`repro_torch.distributed.ft`) are
submodules.
"""

from repro_torch.distributed.ft import (  # noqa: F401
    Heartbeat,
    PreemptionGuard,
    StepMonitor,
    StragglerEvent,
    propose_mesh,
)
from repro_torch.distributed.plan import (  # noqa: F401
    Mesh,
    ShardPlan,
    make_mesh,
    plan_of_legacy_shard_batch,
)
