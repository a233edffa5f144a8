"""Pluggable distributed backend: the reference's ``DistributedBackend``
contract on ``torch.distributed``.

Port of ``dalle_tpu/parallel/backend.py``: the same eight-method ABC, the
registry and the CLI layer (``wrap_arg_parser``, ``set_backend_from_args``,
``using_backend``). The JAX ``JaxBackend`` becomes ``TorchBackend``:

* ``initialize`` → ``init_process_group(init_method="tcp://<coordinator>",
  world_size, rank)`` under ``with_retry("coordinator_connect")`` (a failed
  dial destroys the half-made group before the next attempt, as the JAX
  backend's ``jax.distributed.shutdown()``), a timeout on every collective
  (``collective_timeout_s``: a dead peer raises instead of hanging), then
  the process mesh (``mesh.build_mesh``).
* The flags are the JAX ones (``--coordinator_address``,
  ``--num_processes``, ``--process_id``); the command line wins over the
  environment, which is torch's own launcher's (``MASTER_ADDR`` /
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), not
  ``JAX_*``.
* The wire is chosen, not fallen back to. The default group is gloo (the
  host's: the signal latches, barriers, the wire's choice); each rank names
  its device (host name and card UUID, ``device_identity``) over it once,
  and the mesh's groups, over which the step's tensors travel, take NCCL
  when every rank holds a card no other rank holds, gloo when two share one
  (NCCL refuses two ranks on one device) or on the CPU (``choose_wire``).
  So a card a rank under torchrun on many hosts, or one card made visible
  to each worker, is NCCL; two ranks on one card are gloo. A rank's card is
  ``LOCAL_RANK % device_count`` (``local_device``). Under gloo the
  collectives stage CUDA tensors through pinned host memory (``comm.py``).
  ``wire`` names the choice.
* ``get_world_size`` / ``get_rank`` are the process count and rank, one
  process a card (the JAX backend counts devices, one process a host).
* ``average_all`` is an ``all_reduce`` mean, ``local_barrier`` a
  ``dist.barrier()``, ``distribute`` this rank's fsdp slices of a state
  (``partition.shard_params``).

``DummyBackend`` is one process, world 1.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
from abc import ABC, abstractmethod
from typing import Optional

import numpy as np

from ..chaos import io_hook
from ..config import MeshConfig
from ..utils.retry import TRANSIENT, with_retry
from .mesh import build_mesh, single_device_mesh


class DistributedBackend(ABC):
    """Same eight-method contract as the reference ABC
    (distributed_backends/distributed_backend.py:12-28)."""

    BACKEND_MODULE_NAME: str = "torch"
    BACKEND_NAME: str = "Base"

    ROOT_RANK = 0

    def __init__(self):
        self.mesh = None
        self._initialized = False

    # -- lifecycle ---------------------------------------------------------
    def has_backend(self) -> bool:
        return True

    def initialize(self, mesh_config: Optional[MeshConfig] = None):
        self._backend_initialize(mesh_config or MeshConfig())
        self._initialized = True
        return self

    def require_init(self):
        assert self._initialized, f"{self.BACKEND_NAME} backend used before initialize()"

    # -- abstract surface --------------------------------------------------
    @abstractmethod
    def wrap_arg_parser(self, parser: argparse.ArgumentParser) -> argparse.ArgumentParser: ...

    @abstractmethod
    def _backend_initialize(self, mesh_config: MeshConfig): ...

    @abstractmethod
    def _get_world_size(self) -> int: ...

    @abstractmethod
    def _get_rank(self) -> int: ...

    @abstractmethod
    def _get_local_rank(self) -> int: ...

    @abstractmethod
    def _local_barrier(self): ...

    @abstractmethod
    def _distribute(self, *, params=None, optimizer_state=None, train_step=None, **kw): ...

    @abstractmethod
    def _average_all(self, value): ...

    # -- public wrappers (mirror reference names) -------------------------
    def get_world_size(self) -> int:
        self.require_init()
        return self._get_world_size()

    def get_rank(self) -> int:
        self.require_init()
        return self._get_rank()

    def get_local_rank(self) -> int:
        self.require_init()
        return self._get_local_rank()

    def is_root_worker(self) -> bool:
        return self.get_rank() == self.ROOT_RANK

    def is_local_root_worker(self) -> bool:
        return self.get_local_rank() == self.ROOT_RANK

    def local_barrier(self):
        self.require_init()
        self._local_barrier()

    def distribute(self, **kw):
        self.require_init()
        return self._distribute(**kw)

    def average_all(self, value):
        self.require_init()
        return self._average_all(value)

    def check_batch_size(self, batch_size: int):
        # reference: batch must be >= world size (distributed_backend.py:56-60)
        assert batch_size >= self.get_world_size(), (
            f"batch size {batch_size} < world size {self.get_world_size()}")


def local_device(local_rank: int, device_count: int) -> int:
    """This rank's card among the ``device_count`` it sees: the local rank
    modulo the count (0 when one card is visible, as when each worker is
    given its own)."""
    return local_rank % max(device_count, 1)


def device_identity(device) -> Optional[tuple]:
    """(host name, card UUID) of a CUDA device; None on the CPU."""
    if device.type != "cuda":
        return None
    import torch
    return socket.gethostname(), str(torch.cuda.get_device_properties(device).uuid)


def choose_wire(identities) -> str:
    """The collective library for the step's tensors, from every rank's
    ``device_identity``: "nccl" when every rank holds a card no other rank
    holds, "gloo" on the CPU or when two ranks share a card."""
    if any(i is None for i in identities) or len(set(identities)) < len(identities):
        return "gloo"
    return "nccl"


class TorchBackend(DistributedBackend):
    """One process a rank over ``torch.distributed``; the mesh over the
    world."""

    BACKEND_NAME = "torch"

    # coordinator-connect retry policy (utils/retry.py); class-level so the
    # elastic runtime / tests can widen or pin it fleet-wide
    connect_retry_kw = {"attempts": 5, "base_delay_s": 0.2,
                        "max_delay_s": 2.0}
    collective_timeout_s = 300.0

    def wrap_arg_parser(self, parser):
        grp = parser.add_argument_group("torch distributed backend")
        grp.add_argument("--coordinator_address", type=str, default=None,
                         help="host:port of process 0 (default: MASTER_ADDR:MASTER_PORT)")
        grp.add_argument("--num_processes", type=int, default=None,
                         help="the world size (default: WORLD_SIZE)")
        grp.add_argument("--process_id", type=int, default=None,
                         help="this process's rank (default: RANK)")
        return parser

    def __init__(self):
        super().__init__()
        self._coordinator_address = None
        self._num_processes = None
        self._process_id = None
        self._local_rank = 0
        self.wire: Optional[str] = None
        self.device = None

    def configure_from_args(self, args):
        """Stash the multi-process flags parsed by wrap_arg_parser (CLI wins
        over env)."""
        self._coordinator_address = getattr(args, "coordinator_address", None)
        self._num_processes = getattr(args, "num_processes", None)
        self._process_id = getattr(args, "process_id", None)
        return self

    def _topology(self):
        """(coordinator "host:port" or None, world, rank, local rank)."""
        env = os.environ
        coord = self._coordinator_address
        if coord is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            coord = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world = self._num_processes or int(env.get("WORLD_SIZE", "1"))
        rank = self._process_id
        if rank is None:
            rank = int(env.get("RANK", "0"))
        local = int(env.get("LOCAL_RANK", str(rank)))
        return coord, int(world), int(rank), local

    def _backend_initialize(self, mesh_config: MeshConfig):
        import torch
        import torch.distributed as dist
        coord, world, rank, local = self._topology()
        self._local_rank = local
        if torch.cuda.is_available():
            torch.cuda.set_device(local_device(local, torch.cuda.device_count()))
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device("cpu")
        if world > 1 and not dist.is_initialized():
            if not coord:
                raise ValueError("a multi-process run needs --coordinator_address "
                                 "(or MASTER_ADDR and MASTER_PORT)")
            timeout = datetime.timedelta(seconds=self.collective_timeout_s)

            def _connect():
                io_hook("coordinator_connect")   # chaos injection point
                try:
                    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                                            world_size=world, rank=rank, timeout=timeout)
                except Exception:  # noqa: BLE001 - a failed dial must leave no
                    # half-made group behind, or the retry fails on "already
                    # initialized" instead of dialing again
                    if dist.is_initialized():
                        dist.destroy_process_group()
                    raise

            with_retry("coordinator_connect", _connect,
                       retry_kw=dict(self.connect_retry_kw,
                                     retry_on=TRANSIENT + (RuntimeError,)))
        ids = [device_identity(self.device)]
        if dist.is_initialized() and dist.get_world_size() > 1:
            ids = [None] * dist.get_world_size()
            dist.all_gather_object(ids, device_identity(self.device))
        self.wire = choose_wire(ids)
        self.mesh = build_mesh(mesh_config, backend=self.wire)

    def _get_world_size(self) -> int:
        import torch.distributed as dist
        return dist.get_world_size() if dist.is_initialized() else 1

    def _get_rank(self) -> int:
        import torch.distributed as dist
        return dist.get_rank() if dist.is_initialized() else 0

    def _get_local_rank(self) -> int:
        return self._local_rank

    def _local_barrier(self):
        from .comm import barrier
        barrier()

    def _distribute(self, *, params=None, optimizer_state=None, train_step=None,
                    module=None, partition_rules=None, **kw):
        """This rank's fsdp slices of ``params`` (a state dict of
        ``module``'s parameters) and of ``optimizer_state`` (the same names),
        and ``train_step`` as it is: the gradient exchange lives in the
        trainer's step (``train/base_trainer.py``), nothing is wrapped."""
        from .partition import shard_params
        out = []
        for tree in (params, optimizer_state):
            if tree is not None:
                out.append(shard_params(self.mesh, module, tree, partition_rules))
        if train_step is not None:
            out.append(train_step)
        return tuple(out) if len(out) != 1 else out[0]

    def _average_all(self, value):
        """Mean over every rank of each rank's mean of ``value``."""
        import torch
        from .comm import all_reduce_, device_of, world_group
        mean = float(np.asarray(value, dtype=np.float64).mean())
        group = world_group()
        if group is None:
            return mean
        t = torch.tensor([mean], dtype=torch.float64, device=device_of(group))
        return float(all_reduce_(t, group).item()) / self.get_world_size()

    def shutdown(self):
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


class DummyBackend(DistributedBackend):
    """1-process no-op backend: parity with the reference's DummyBackend
    (distributed_backends/dummy_backend.py)."""

    BACKEND_NAME = "Dummy"

    def wrap_arg_parser(self, parser):
        return parser

    def _backend_initialize(self, mesh_config: MeshConfig):
        self.mesh = single_device_mesh()

    def _get_world_size(self): return 1
    def _get_rank(self): return self.ROOT_RANK
    def _get_local_rank(self): return self.ROOT_RANK
    def _local_barrier(self): pass

    def _distribute(self, *, params=None, optimizer_state=None, train_step=None, **kw):
        out = [x for x in (params, optimizer_state, train_step) if x is not None]
        return tuple(out) if len(out) != 1 else out[0]

    def _average_all(self, value):
        return float(np.asarray(value, dtype=np.float64).mean())


# --------------------------------------------------------------------------
# Registry + CLI selection (reference: distributed_utils.py:22-96)
# --------------------------------------------------------------------------

BACKENDS = {
    TorchBackend.BACKEND_NAME.lower(): TorchBackend,
    DummyBackend.BACKEND_NAME.lower(): DummyBackend,
    # the JAX CLI's name and the reference's GPU engines: all run on
    # torch.distributed here, which covers their used surface
    # (allreduce/barrier/rank queries/distribute)
    "jax": TorchBackend,
    "deepspeed": TorchBackend,
    "horovod": TorchBackend,
}

is_distributed: Optional[bool] = None
backend: Optional[DistributedBackend] = None


def wrap_arg_parser(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument(
        "--distributed_backend", "--distr_backend", type=str, default=None,
        help=f"which distributed backend to use: {list(BACKENDS)}")
    # aliases map several names onto one class — add each class's flags once
    for cls in dict.fromkeys(BACKENDS.values()):
        cls().wrap_arg_parser(parser)
    return parser


def set_backend_from_args(args) -> DistributedBackend:
    """Select & validate the backend from parsed args (ref distributed_utils.py:48-76)."""
    global is_distributed, backend
    name = (getattr(args, "distributed_backend", None) or "dummy").lower()
    if name not in BACKENDS:
        raise ValueError(f"unknown distributed backend {name!r}; options: {list(BACKENDS)}")
    if (BACKENDS[name] is TorchBackend
            and name != TorchBackend.BACKEND_NAME.lower()):
        print(f"[distributed] backend {name!r} runs on the torch.distributed "
              f"backend here (same collective surface)")
    backend = BACKENDS[name]()
    if not backend.has_backend():
        raise ModuleNotFoundError(f"backend {name} is not available")
    if hasattr(backend, "configure_from_args"):
        backend.configure_from_args(args)
    is_distributed = name != "dummy"
    return backend


def using_backend(test_backend) -> bool:
    """Type-or-name check (ref distributed_utils.py:87-96)."""
    assert backend is not None, "select a backend first"
    if isinstance(test_backend, str):
        return backend.BACKEND_NAME.lower() == test_backend.lower()
    return isinstance(backend, test_backend)
