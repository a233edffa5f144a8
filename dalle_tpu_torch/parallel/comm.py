"""The collectives the trainers run over a process group, and where their
bytes travel.

Under NCCL (one rank a card) a CUDA tensor is exchanged as it is. Under gloo
(the CPU, or ranks that share one card) every exchange of a CUDA tensor is
staged through pinned host memory: the tensor is copied out, gloo exchanges
the host copy, and the result is copied back. Only the exchange goes
through the host; every arithmetic operation of the step stays on the
device. A ``group`` of None means "no peers" (a mesh axis of size 1), and
every function here is then a no-op.

Gradients and flags travel in flat buckets of one dtype
(``BUCKET_ELEMENTS`` at most), so a step makes a few large exchanges
rather than one per parameter. fsdp's sliced gradients are reduce-scattered
(``reduce_scatter_many``): each rank receives only the sums of its slice.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

BUCKET_ELEMENTS = 1 << 26      # 256 MB of f32 a bucket


def _dist():
    import torch.distributed as dist
    return dist


def size(group) -> int:
    return 1 if group is None else _dist().get_world_size(group)


def staged(t: torch.Tensor, group) -> bool:
    """Whether an exchange of ``t`` over ``group`` goes through host memory:
    a CUDA tensor under gloo."""
    return t.is_cuda and _dist().get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A 2-byte float's bytes as flat uint8 (a view of its storage), for
    exchanges that only move bytes (gathers, sends): gloo's type tables
    cover neither bfloat16 nor int16."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.reshape(-1).view(torch.uint8)
    return t


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place over ``group`` ("sum" or "max")."""
    if group is None:
        return t
    dist = _dist()
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    if staged(t, group):
        host = _host(t)
        dist.all_reduce(host, red, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, red, group=group)
    return t


def buckets(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` grouped by dtype and device, each group cut
    into runs of at most ``BUCKET_ELEMENTS`` elements."""
    by_kind: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        by_kind.setdefault((t.dtype, t.device), []).append(i)
    out = []
    for idx in by_kind.values():
        cur, n = [], 0
        for i in idx:
            if cur and n + tensors[i].numel() > BUCKET_ELEMENTS:
                out.append(cur)
                cur, n = [], 0
            cur.append(i)
            n += tensors[i].numel()
        out.append(cur)
    return out


def all_reduce_many_(tensors: Sequence[torch.Tensor], group, op: str = "sum"):
    """Every tensor reduced in place over ``group``, through flat buckets of
    one dtype."""
    if group is None or not tensors:
        return
    for idx in buckets(tensors):
        ts = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_(flat, group, op)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def reduce_scatter_(out: torch.Tensor, t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (one part a rank along dim 0, in rank order) summed over
    ``group``, this rank's part written into ``out``: each rank receives
    only its part's sums, half an all-reduce's bytes at two ranks."""
    dist = _dist()
    if staged(t, group):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(host, _host(t), group=group)
        out.copy_(host)
    else:
        dist.reduce_scatter_tensor(out, t, group=group)
    return out


def reduce_scatter_many(tensors: Sequence[torch.Tensor], dims: Sequence[int], group,
                        dtype: torch.dtype) -> List[torch.Tensor]:
    """Each tensor summed over ``group`` in ``dtype`` → this rank's part of
    each along its ``dims`` entry (``shard_of``), through flat buckets: a
    bucket holds every tensor's part 0, then every part 1, ..., so one
    ``reduce_scatter_tensor`` leaves each rank its parts. With ``group``
    None the tensors come back whole, as ``dtype``."""
    if group is None:
        return [t.to(dtype) for t in tensors]
    n, me = size(group), _dist().get_rank(group)
    out: List[torch.Tensor] = [None] * len(tensors)
    for idx in buckets(tensors):
        parts = [shard_of(tensors[i], dims[i], me, n) for i in idx]
        flat = torch.cat([shard_of(tensors[i], dims[i], r, n).reshape(-1).to(dtype)
                          for r in range(n) for i in idx])
        mine = reduce_scatter_(flat.new_empty(flat.numel() // n), flat, group)
        del flat
        off = 0
        for i, p in zip(idx, parts):
            out[i] = mine[off:off + p.numel()].view(p.shape)
            off += p.numel()
    return out


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    if group is None:
        return t
    src = t.contiguous()
    stage = staged(src, group)
    buf = _host(src) if stage else src
    parts = [torch.empty_like(buf) for _ in range(size(group))]
    _dist().all_gather([_bits(x) for x in parts], _bits(buf), group=group)
    out = torch.cat(parts, dim)
    return out.to(t.device, non_blocking=True) if stage else out


def shard_of(t: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    """Part ``index`` of ``parts`` equal parts of ``t`` along ``dim``."""
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n)


def agree(flags: Sequence[bool], group) -> List[bool]:
    """Each flag true if it is true on any rank of ``group``, in one small
    exchange: ranks that saw a signal at different steps act together.
    Over a gloo group (the backend's default group) the flags stay on the
    host, so the exchange waits for no kernel; over NCCL it would
    synchronise with the card."""
    if group is None:
        return list(flags)
    t = torch.tensor([float(f) for f in flags], device=device_of(group))
    return [bool(v) for v in all_reduce_(t, group, "max").tolist()]


def barrier(group=None):
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.barrier(group=group)


def send_recv(tensors: Sequence[torch.Tensor], dst: int, src: int,
              group) -> List[torch.Tensor]:
    """Send each tensor to global rank ``dst`` and receive as many of the
    same shapes from global rank ``src``, all posted at once
    (``batch_isend_irecv``). Under gloo a CUDA tensor goes through pinned
    host memory both ways."""
    dist = _dist()
    stage = bool(tensors) and staged(tensors[0], group)
    device = tensors[0].device if tensors else None
    sends = [(_host(t) if stage else t.contiguous()) for t in tensors]
    recvs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if stage
             else torch.empty_like(t, memory_format=torch.contiguous_format)
             for t in tensors]
    ops = []
    for s, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, _bits(s), dst, group))
        ops.append(dist.P2POp(dist.irecv, _bits(r), src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if stage:
        return [r.to(device, non_blocking=True) for r in recvs]
    return recvs


def world_group():
    """The default group when a multi-process run is initialized, else None."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def device_of(group) -> torch.device:
    """Where a small exchange over ``group`` lives: the host under gloo,
    the current card under NCCL."""
    if group is not None and _dist().get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
