"""The replica fleet: replicas as processes behind a socket protocol.

Port of ``dalle_tpu/fleet`` under the same names and the same wire
protocol (``contracts/wire.json``): ``transport`` (length-prefixed JSON
frames, retried dials, ``RemoteReplica`` speaking the router's duck type,
``ReplicaServer`` serving one in-process ``Replica``), ``manager``
(spawning ``python -m dalle_tpu_torch.cli.serve_replica`` processes, the
warm pool, kill) and ``controller`` (burn-rate and backlog scale-up, idle
scale-down, wedge, degradation and heartbeat drains and replaces).
Mid-stream hand-offs stay bitwise: a drained or crashed replica's requests
resubmit with the same seed and the router's row high-water mark splices
the streams.
"""

from .controller import FleetController
from .manager import FleetManager, ReplicaProcess, SpawnError
from .transport import (RemoteCompletion, RemoteGroupStream, RemoteReplica,
                        RemoteResultStream, ReplicaServer, TransportError,
                        call, dial, recv_frame, send_frame, set_frame_tap)

__all__ = [
    "FleetController", "FleetManager", "ReplicaProcess", "SpawnError",
    "RemoteCompletion", "RemoteGroupStream", "RemoteReplica",
    "RemoteResultStream", "ReplicaServer", "TransportError", "call",
    "dial", "recv_frame", "send_frame", "set_frame_tap",
]
