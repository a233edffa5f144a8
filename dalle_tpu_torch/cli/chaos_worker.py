"""One member of an elastic chaos pod: the counterpart of
``scripts/chaos_worker.py``.

Spawned by ``cli/chaos_smoke.py``'s ``ElasticAgent`` (or run by hand):
installs the chaos ``FaultPlan`` from the environment, joins the pod's
current membership epoch over ``torch.distributed`` (``TorchBackend``, the
connect retried), trains with per-step deterministic batches (a small dVAE
by default, a DALL·E of ``--dalle_config`` with ``--model dalle``; on the
card unless ``--device cpu``), heartbeats every step, restores the last durable checkpoint on
(re)start, and on completion writes a digest: the sha256 over the raw bytes
of every tensor of the trainer's gathered state (masters and optimizer),
which the smoke compares bit for bit against an uninterrupted run at the
same step.

Exit protocol (what the agent keys on): 0 reached the target step, digest
written; 77 (``EXIT_RECONFIGURE``) preempted (the SIGTERM save landed) or a
peer died: respawn me into the next epoch; anything else a crash.

Determinism: the batch of host step s is drawn from ``RandomState(seed +
s)`` and the trainer's generator travels in its checkpoint, so re-running
[restore step, crash step] after recovery reproduces the bits of a run
that never crashed.

Run: ``python -m dalle_tpu_torch.cli.chaos_worker --run_dir DIR --reference
--device cpu``
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys


def make_batch(args, cfg, step: int):
    import numpy as np
    rng = np.random.RandomState(args.seed + step)
    if args.model == "dvae":
        return (rng.rand(args.batch, cfg.image_size, cfg.image_size, 3).astype(np.float32),)
    text = rng.randint(1, cfg.num_text_tokens, (args.batch, cfg.text_seq_len))
    img = rng.randint(0, cfg.image_vocab_size, (args.batch, cfg.image_fmap_size ** 2))
    return text.astype(np.int64), img.astype(np.int64)


def _tensors(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def state_digest(state) -> str:
    """sha256 over every tensor of the masters and the optimizer's state,
    in a fixed order: the bit-for-bit resume oracle."""
    import torch
    h = hashlib.sha256()
    for t in _tensors({"model": state["model"], "optimizer": state["optimizer"]}):
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run_dir", required=True,
                    help="the pod's shared directory (epoch file, heartbeats, ckpt)")
    ap.add_argument("--target_steps", type=int, default=8)
    ap.add_argument("--save_every", type=int, default=2, help="0 = never save")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--restore_step", type=int, default=None,
                    help="pin the restore step (reference legs); default: the newest "
                         "durable one, if any")
    ap.add_argument("--reference", action="store_true",
                    help="reference leg: no elastic runtime, no heartbeats")
    ap.add_argument("--peer_timeout_s", type=float, default=0.0)
    ap.add_argument("--sync_ckpt", action="store_true",
                    help="synchronous checkpoints: every save durable at its boundary")
    ap.add_argument("--model", choices=("dvae", "dalle"), default="dvae")
    ap.add_argument("--dalle_config", default="{}",
                    help="DalleConfig keywords as JSON (--model dalle)")
    ap.add_argument("--compute", default="float32", help="the compute dtype")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch
    if args.device == "cpu":
        # one intra-op thread: the CPU's reductions then sum in one order
        # whatever the host's load, which the bitwise oracle needs
        torch.set_num_threads(1)

    from .. import chaos, obs
    obs.configure()
    chaos.install_from_env()

    from ..config import (DalleConfig, DVAEConfig, MeshConfig, OptimConfig, PrecisionConfig,
                          TrainConfig)
    from ..parallel import backend as B
    from ..parallel import elastic

    worker = None
    ns = argparse.Namespace(distributed_backend="torch", coordinator_address=None,
                            num_processes=None, process_id=None)
    if not args.reference and elastic.DIR_ENV in os.environ:
        worker = elastic.ElasticWorker.from_env(hb_interval_s=0.1,
                                                peer_timeout_s=args.peer_timeout_s)
        # start now: the beater covers the no-step phases (dial-in, restore,
        # the first step's kernel builds)
        worker.start()
        ep = worker.epoch
        pid = ep.process_id(worker.worker_id)
        if pid is None:
            print(f"worker {worker.worker_id}: not a member of epoch {ep.epoch}; exiting")
            return 0
        if ep.nproc > 1:
            ns = argparse.Namespace(distributed_backend="torch",
                                    coordinator_address=ep.coordinator_address,
                                    num_processes=ep.nproc, process_id=pid)
    backend = B.set_backend_from_args(ns).initialize(MeshConfig())

    if args.model == "dvae":
        from ..train.trainer_vae import VAETrainer
        model_cfg = DVAEConfig(image_size=16, num_tokens=16, codebook_dim=8, num_layers=1,
                               num_resnet_blocks=0, hidden_dim=8)
    else:
        from ..train.trainer_dalle import DalleTrainer
        model_cfg = DalleConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in json.loads(args.dalle_config).items()})
    tc = TrainConfig(
        batch_size=args.batch, seed=args.seed, log_every=1,
        save_every_steps=args.save_every or 0,
        keep_n_checkpoints=None,           # the fallback needs older steps
        # a leg that neither saves nor restores keeps no checkpoint directory
        checkpoint_dir=(None if args.save_every == 0 and args.restore_step is None
                        else os.path.join(args.run_dir, "ckpt")),
        preflight_checkpoint=False, async_checkpointing=not args.sync_ckpt,
        device_prefetch=0,                 # the resume arithmetic owns the iterator
        precision=PrecisionConfig(compute=args.compute),
        optim=OptimConfig(optimizer="adam", learning_rate=1e-3, grad_clip_norm=0.5),
        mesh=MeshConfig())
    if args.model == "dvae":
        trainer = VAETrainer(model_cfg, tc, device=args.device, backend=backend)
    else:
        trainer = DalleTrainer(model_cfg, tc, device=args.device, backend=backend)
    restored_from = None
    if args.restore_step is not None:
        trainer.restore(args.restore_step)
        restored_from = args.restore_step
    elif trainer.ckpt is not None and trainer.ckpt.latest_step() is not None:
        trainer.restore()
        restored_from = trainer.step
    print(f"worker: world={backend.get_world_size()} wire={getattr(backend, 'wire', None)} "
          f"proc={os.getpid()} start_step={trainer.step} restored_from={restored_from}",
          flush=True)

    def leave_pod():
        """Meet at a barrier, then close the group: symmetric exits (all
        done, or all preempted at one boundary) meet there; an asymmetric
        death is the agent's to handle."""
        try:
            if backend.get_world_size() > 1:
                backend.local_barrier()
                backend.shutdown()
        except Exception as exc:  # noqa: BLE001 - a broken pod cannot barrier
            print(f"worker: leave_pod best-effort failed: {exc!r}")

    trainer.install_preemption_handler()
    batches = (make_batch(args, model_cfg, s) for s in range(trainer.step, args.target_steps))
    on_step = writer = None
    if worker is not None:
        # the straggler signal: the step's device and collective wait
        # (t_dispatch + t_sync) of the record before, one step stale
        last_m: dict = {}

        class _HBWriter:
            def log(self, step, m):
                last_m.clear()
                last_m.update(m)
        writer = _HBWriter()

        def on_step(step):
            blocked = (last_m.get("t_dispatch_s", 0.0) + last_m.get("t_sync_s", 0.0)
                       if "t_dispatch_s" in last_m else None)
            worker.on_step(step, blocked_s=blocked)
    trainer.fit(batches, steps=args.target_steps, metrics_writer=writer, on_step=on_step)
    if worker is not None:
        worker.stop()

    if trainer.preempted and trainer.step < args.target_steps:
        print(f"worker: preempted at step {trainer.step}; requesting reconfiguration")
        leave_pod()
        return elastic.EXIT_RECONFIGURE

    digest = state_digest(trainer.state_dict())
    snap = obs.metrics_snapshot()
    artifact = {
        "worker_id": worker.worker_id if worker is not None else -1,
        "epoch": worker.epoch.epoch if worker is not None else -1,
        "step": int(trainer.step),
        "world_size": int(backend.get_world_size()),
        "restored_from": restored_from,
        "digest": digest,
        "counters": {k: v for k, v in snap.items()
                     if k.startswith(("retry.", "chaos.", "ckpt.", "elastic."))},
    }
    tag = f"w{artifact['worker_id']}" if worker is not None else "ref"
    out = os.path.join(args.run_dir, f"digest_{tag}.json")
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(artifact, fh, indent=2)
    print(f"worker: done at step {artifact['step']} digest={digest[:16]}… → {out}")
    leave_pod()
    return 0


if __name__ == "__main__":
    sys.exit(main())
