"""Parallelism: the distributed backend (``backend.py``), the process mesh
(``mesh.py``), the fsdp partition rules (``partition.py``), the
collectives (``comm.py``), ring attention over sp ranks
(``ring_attention.py``) and the elastic pod runtime (``elastic.py``).

Port of ``dalle_tpu/parallel``; the names of the JAX ``__all__`` that have a
counterpart. The JAX package's ``jax_threefry_partitionable`` switch has
none: it makes a draw inside a jitted program independent of how GSPMD
shards it, and the port's draws come from each trainer's own explicit
``torch.Generator``, taken for the global batch and cut to this rank's rows
(``train/trainer_dalle.py``), so sharding never changes them. The JAX
exports ``ring_attention`` and ``shard_seq`` stay in their module: here
``parallel.ring_attention`` names the module, as the port's callers import
it.
"""

from .backend import (BACKENDS, DistributedBackend, DummyBackend, TorchBackend,
                      set_backend_from_args, using_backend, wrap_arg_parser)
from .mesh import (ProcessMesh, batch_spec, build_mesh, local_batch_size, replicated,
                   shard_batch, shard_stacked_batch, single_device_mesh, use_mesh)
from .partition import (DEFAULT_RULES, P, PartitionSpec, commit_to_mesh, constrain,
                        make_param_shardings, shard_params, spec_for)

__all__ = [
    "BACKENDS", "DEFAULT_RULES", "DistributedBackend", "DummyBackend", "P",
    "PartitionSpec", "ProcessMesh", "TorchBackend", "batch_spec", "build_mesh",
    "commit_to_mesh", "constrain", "local_batch_size", "make_param_shardings",
    "replicated", "set_backend_from_args",
    "shard_batch", "shard_params", "shard_stacked_batch", "single_device_mesh",
    "spec_for", "use_mesh", "using_backend", "wrap_arg_parser",
]
