"""The process mesh and the batch's placement on it.

Port of ``dalle_tpu/parallel/mesh.py``. The JAX package builds one
``jax.sharding.Mesh`` over every device and lets XLA place the collectives;
the port runs one process a rank (``torch.distributed``) and names the same
mesh: the ranks 0..W-1 laid out row-major over the axes ``("dp", "fsdp",
"sp", "tp")``, as ``np.asarray(devices).reshape(shape)`` lays out the
devices. ``ProcessMesh`` gives this rank's coordinate on each axis and one
process group for each axis, for ``(dp, fsdp)``, for the ranks that hold
the same fsdp slice and for the whole mesh: the ranks that differ only
there.

``torch.distributed.device_mesh.init_device_mesh`` is not used: it binds
the mesh to one device type and, for "cuda", to one card a rank and NCCL,
while two ranks that share a card run over gloo with CUDA tensors. The
groups are made here instead, every group by every rank in the same order
(``dist.new_group`` is collective over the whole world).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..config import MeshConfig
from .partition import P

AXES = ("dp", "fsdp", "sp", "tp")
DATA_AXES = ("dp", "fsdp")
# the groups a mesh makes: each axis, the batch's, the replicas of an
# fsdp slice, the whole mesh
GROUPS = tuple((a,) for a in AXES) + (DATA_AXES, ("dp", "sp", "tp"), AXES)


class ProcessMesh:
    """``shape`` {axis: size} over ``world`` ranks, this process at
    ``rank``; ``coords`` {axis: index}. ``group(*axes)`` is the process
    group of the ranks that share this rank's coordinates on every other
    axis, or None when those axes hold one rank (no exchange)."""

    def __init__(self, shape: Dict[str, int], rank: int = 0):
        self.shape = {a: int(shape[a]) for a in AXES}
        self.size = int(np.prod([self.shape[a] for a in AXES]))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside a mesh of {self.size}")
        self.rank = rank
        idx = np.unravel_index(rank, tuple(self.shape[a] for a in AXES))
        self.coords = {a: int(i) for a, i in zip(AXES, idx)}
        self._groups: Dict[Tuple[str, ...], Any] = {}

    @property
    def devices(self) -> np.ndarray:
        """The ranks in mesh order (the JAX mesh's ``devices`` array)."""
        return np.arange(self.size).reshape(tuple(self.shape[a] for a in AXES))

    def ranks_along(self, axes: Tuple[str, ...], rank: Optional[int] = None):
        """The global ranks that share ``rank``'s coordinates off ``axes``,
        in mesh order."""
        rank = self.rank if rank is None else rank
        idx = np.unravel_index(rank, self.devices.shape)
        sl = tuple(slice(None) if a in axes else int(i) for a, i in zip(AXES, idx))
        return [int(r) for r in self.devices[sl].reshape(-1)]

    def make_groups(self, backend: Optional[str] = None):
        """Create the process groups of every axis, of ``(dp, fsdp)``, of
        the axes off fsdp (``(dp, sp, tp)``: the ranks that hold the same
        fsdp slice) and of the whole mesh, on ``backend`` (default: the
        default group's). Collective: every rank calls it, and every rank
        creates every group (its own and the others') in the same order."""
        import torch.distributed as dist
        if dist.get_world_size() != self.size:
            raise ValueError(f"a mesh of {self.size} ranks over a world of "
                             f"{dist.get_world_size()}")
        default = backend is None or backend == dist.get_backend()
        made: Dict[Tuple[int, ...], Any] = {}    # one group per member set
        for axes in GROUPS:
            if self.count(*axes) == 1:
                continue
            for r in range(self.size):
                members = tuple(self.ranks_along(axes, r))
                if members not in made:
                    made[members] = (dist.group.WORLD if default and len(members) == self.size
                                     else dist.new_group(list(members), backend=backend))
                if r == self.rank:
                    self._groups[axes] = made[members]
        return self

    def group(self, *axes: str):
        """The group along ``axes`` (None: one rank, nothing to exchange)."""
        axes = tuple(a for a in AXES if a in axes)
        if int(np.prod([self.shape[a] for a in axes])) == 1:
            return None
        if axes not in self._groups:
            raise ValueError(f"no process group along {axes}: call make_groups() "
                             "after init_process_group")
        return self._groups[axes]

    def index(self, *axes: str) -> int:
        """This rank's index among the ranks along ``axes`` (row-major)."""
        out = 0
        for a in AXES:
            if a in axes:
                out = out * self.shape[a] + self.coords[a]
        return out

    def count(self, *axes: str) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def __repr__(self):
        return f"ProcessMesh({self.shape}, rank={self.rank})"


def _world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def build_mesh(cfg: MeshConfig, world: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None) -> ProcessMesh:
    """The mesh over ``world`` ranks (default: the initialized process
    group's, else 1). When the axes' sizes do not cover the world, ``dp``
    absorbs the remainder, as the JAX ``build_mesh`` does; fixed axes that
    do not divide it raise. Under an initialized multi-process group the
    mesh's process groups are created on ``backend`` (collective)."""
    w, r = _world()
    made_here = world is None
    world = w if world is None else world
    rank = (r if made_here else 0) if rank is None else rank
    sizes = {"dp": cfg.dp, "fsdp": cfg.fsdp, "tp": cfg.tp, "sp": cfg.sp}
    fixed = sizes["fsdp"] * sizes["tp"] * sizes["sp"]
    if cfg.dp * fixed != world:
        if world % fixed != 0:
            raise ValueError(
                f"mesh axes fsdp*tp*sp={fixed} do not divide device count {world}")
        sizes["dp"] = world // fixed
    mesh = ProcessMesh(sizes, rank)
    if made_here and world > 1:
        mesh.make_groups(backend)
    return mesh


def single_device_mesh() -> ProcessMesh:
    return ProcessMesh({a: 1 for a in AXES})


def batch_spec(mesh: ProcessMesh) -> P:
    """Batch dims shard over (dp, fsdp), dp major: fsdp acts as extra data
    parallelism for activations, like ZeRO's data-parallel groups."""
    return P(DATA_AXES)


def replicated(mesh: ProcessMesh) -> P:
    return P()


def _rows(x, lead: int, index: int, parts: int):
    if parts == 1 or np.ndim(x) <= lead:
        return x
    n = x.shape[lead]
    if n % parts:
        raise ValueError(f"batch of {n} rows does not split over {parts} ranks")
    k = n // parts
    sl = (slice(None),) * lead + (slice(index * k, (index + 1) * k),)
    return x[sl]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree if tree is None else fn(tree)


def shard_batch(mesh: ProcessMesh, batch, leading_replicated: int = 0):
    """This rank's rows of a global host (or device) batch: the batch
    dimension split over (dp, fsdp) in the JAX order (``P(("dp",
    "fsdp"))``: block ``dp_index * fsdp + fsdp_index``). Leaves with no
    batch axis past ``leading_replicated`` stay whole, as the JAX package
    replicates them; the sp and tp ranks of a block take the same rows."""
    index, parts = mesh.index(*DATA_AXES), mesh.count(*DATA_AXES)
    return _tree_map(lambda x: _rows(x, leading_replicated, index, parts), batch)


def shard_stacked_batch(mesh: ProcessMesh, batch):
    """(k, b, ...) microbatch stacks: axis 0 the step (whole), axis 1 the
    batch (split)."""
    return shard_batch(mesh, batch, leading_replicated=1)


@contextlib.contextmanager
def use_mesh(mesh: ProcessMesh):
    """The JAX ``with mesh:`` scope. The port's collectives name their
    groups explicitly, so the scope only hands the mesh over."""
    yield mesh


def local_batch_size(mesh: ProcessMesh, global_batch: int) -> int:
    dp = mesh.count(*DATA_AXES)
    if global_batch % dp != 0:
        # reference enforces batch >= world size (distributed_backend.py:56-60)
        raise ValueError(f"global batch {global_batch} not divisible by data-parallel size {dp}")
    return global_batch // dp

