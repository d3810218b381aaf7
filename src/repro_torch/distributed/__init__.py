"""Fault tolerance for the serve daemon (:mod:`repro_torch.distributed.ft`).

The sharded-solve surface of ``repro.distributed`` (``ShardPlan``) is not
ported yet; only the host-side fault-tolerance primitives are exported.
"""

from repro_torch.distributed.ft import (  # noqa: F401
    Heartbeat,
    PreemptionGuard,
    StepMonitor,
    StragglerEvent,
    propose_mesh,
)
