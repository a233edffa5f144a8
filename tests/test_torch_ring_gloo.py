"""Ring attention over a ``torch.distributed`` group ≡ all its ranks in one
process, on the CPU.

Two processes join a gloo group (a ``file://`` store, a timeout on every
operation); each runs ``ring_attention_local`` over a ``GroupRing`` on its
slice of the zigzag-permuted inputs, takes the gradient of sum(sin(·)) of
its output, and writes both. The parent holds them against the
``LocalRing`` result of the same chunks, for the kernel body (K6's plain
versions) and the dense body (whose gradient crosses ranks through the
shift's backward). Same arithmetic on the same chunks: 1e-6 absolute, for
BLAS sums that may split otherwise across the processes' threads.

This file imports no JAX at its top: ``torch.multiprocessing.spawn``
imports it again in each child.
"""

import datetime
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from dalle_tpu_torch.parallel import ring_attention as tring

WORLD, N, SEED = 2, 64, 7
LIMIT_S = 60.0                       # the whole two-process run; a deadlock ends at
                                     # the 20 s process-group timeout raises sooner


def _inputs():
    """Global q, k, v (b=1, h=2, n=64, d=16) in the zigzag order."""
    rng = np.random.RandomState(SEED)
    perm = torch.from_numpy(tring.zigzag_perm(WORLD, N // (2 * WORLD)))
    return [torch.from_numpy(rng.standard_normal((1, 2, N, 16)).astype(np.float32))
            .index_select(2, perm) for _ in range(3)]


def _worker(rank, init_file, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=20))
    try:
        n_local = N // WORLD
        sl = slice(rank * n_local, (rank + 1) * n_local)
        res = {}
        for kernel in (True, False):
            q, k, v = (t[:, :, sl].clone().requires_grad_(True) for t in _inputs())
            out = tring.ring_attention_local(q, k, v, n_valid=N, zigzag=True, kernel=kernel)
            out.sin().sum().backward()
            res[kernel] = [out.detach(), q.grad, k.grad, v.grad]
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_group_ring_matches_local_ring(tmp_path):
    ctx = mp.spawn(_worker, args=(str(tmp_path / "store"), str(tmp_path)), nprocs=WORLD,
                   join=False)
    deadline = time.monotonic() + LIMIT_S
    while not ctx.join(timeout=0.5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ring did not finish within {LIMIT_S} s")
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    n_local = N // WORLD
    for kernel in (True, False):
        qkv = [t.clone().requires_grad_(True) for t in _inputs()]
        chunks = [[t[:, :, r * n_local:(r + 1) * n_local] for r in range(WORLD)] for t in qkv]
        outs = tring._run(tring.LocalRing(WORLD), *chunks, causal=True, scale=16 ** -0.5,
                          n_valid=N, zigzag=True, kernel=kernel, mask_spec=None)
        sum(o.sin().sum() for o in outs).backward()
        for r in range(WORLD):
            sl = slice(r * n_local, (r + 1) * n_local)
            want = [outs[r].detach()] + [t.grad[:, :, sl] for t in qkv]
            for name, g, w in zip(("out", "dq", "dk", "dv"), got[r][kernel], want):
                torch.testing.assert_close(g, w, atol=1e-6, rtol=0,
                                           msg=f"kernel={kernel} rank {r} {name}")
