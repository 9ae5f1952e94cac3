"""Serving: artifacts, the batched inference engine, the HTTP front end,
and the fleet router with its autoscaler in front of the replicas.

Only the fleet's names are exported here: the router and the autoscaler
are stdlib only, and a process that imports them (``cli/fleet.py``) must
not import torch. The engine, decode engine, server and export modules
are imported by their own paths.
"""

from distributed_tensorflow_framework_torch.serve.autoscale import (  # noqa: F401
    Autoscaler,
    FleetSnapshot,
    ScaleDecision,
    TenantQuotas,
    priority_of,
)
from distributed_tensorflow_framework_torch.serve.fleet import (  # noqa: F401
    FleetDrainError,
    FleetError,
    FleetProberError,
    FleetRouter,
    ReplicaLaunchError,
)
