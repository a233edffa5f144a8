"""Train a VQGAN image tokenizer on the card from the command line.

Port of ``scripts/train_vqgan.py``: the VQGAN's and the GAN loss's flags,
taming's learning rate (``--base_lr`` × the batch size unless
``--absolute_lr``) for Adam with betas (0.5, 0.9) on both networks, no
clipping, checkpoints (the last step is saved at the end), and with
``--sample_every_steps`` a grid of probe images over their reconstructions
(``<sample_dir>/step{N}_recon.png``). Images are in [-1, 1], taming's
convention. Runs on the CUDA card unless ``--device cpu``.

    python -m dalle_tpu_torch.cli.train_vqgan --image_folder ./images \\
        --resolution 64 --ch 32 --ch_mult 1,2 --n_embed 256 --batch_size 8 \\
        --steps 100 --disc_start 50 --output_dir ./vqgan_ckpt

The images come from a folder (``--image_folder``: an ImageFolder,
resized and centre-cropped, in an order drawn per epoch from
``--seed``; ``data/loaders.py``) or the synthetic shapes.

``--gumbel`` trains taming's GumbelVQ, ``--scan_steps k`` runs k steps a
``train_steps`` call. ``--health``, ``--breach_actions``, ``--trace``, ``--watchdog_deadline_s``
and ``--prometheus_path`` arm the trainer's telemetry (``train/base_trainer.py``);
SIGUSR2 takes a bounded ``torch.profiler`` capture (``--profiler_dir``);
every record read goes to ``<output_dir>/metrics.jsonl``, which
``python -m dalle_tpu_torch.cli.obs_report`` summarises.
Checkpoints are written on a thread (``--sync_checkpointing`` writes them
in the loop). SIGTERM finishes the step in flight, saves, and exits 0;
SIGUSR1 saves at the next step (``--no_preemption_handler`` installs
neither). Not ported, and raising ``NotImplementedError`` with its
``ROADMAP.md`` item: ``--wandb``.
"""

from __future__ import annotations

import argparse
import os
import sys

from ._common import (add_device_arg, add_distributed_args, add_overlap_args, add_telemetry_args,
                      check_unported_train_args, install_resilience, install_sigusr2_profiler,
                      install_telemetry, leave_backend, obs_config, overlap_train_kwargs,
                      start_backend, to_uint8)
from ..data.image_codec import write_png


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    data = ap.add_argument_group("data")
    data.add_argument("--image_folder", type=str, default=None,
                      help="folder of images (not ported yet)")
    data.add_argument("--synthetic", action="store_true",
                      help="the synthetic shapes dataset")

    model = ap.add_argument_group("model")
    model.add_argument("--resolution", type=int, default=256)
    model.add_argument("--n_embed", type=int, default=1024)
    model.add_argument("--embed_dim", type=int, default=256)
    model.add_argument("--z_channels", type=int, default=256)
    model.add_argument("--ch", type=int, default=128)
    model.add_argument("--ch_mult", type=str, default="1,1,2,2,4")
    model.add_argument("--num_res_blocks", type=int, default=2)
    model.add_argument("--attn_resolutions", type=str, default="16")
    model.add_argument("--dropout", type=float, default=0.0)
    model.add_argument("--gumbel", action="store_true", help="taming's GumbelVQ")

    loss = ap.add_argument_group("loss")
    loss.add_argument("--disc_start", type=int, default=10000)
    loss.add_argument("--disc_weight", type=float, default=0.8)
    loss.add_argument("--disc_num_layers", type=int, default=3)
    loss.add_argument("--disc_ndf", type=int, default=64)
    loss.add_argument("--disc_loss", type=str, default="hinge", choices=["hinge", "vanilla"])
    loss.add_argument("--codebook_weight", type=float, default=1.0)
    loss.add_argument("--perceptual_weight", type=float, default=1.0)
    loss.add_argument("--use_actnorm", action="store_true")

    train = ap.add_argument_group("training")
    train.add_argument("--epochs", type=int, default=20)
    train.add_argument("--batch_size", type=int, default=16)
    train.add_argument("--base_lr", type=float, default=4.5e-6,
                       help="scaled by the batch size (taming's rule)")
    train.add_argument("--absolute_lr", type=float, default=None)
    train.add_argument("--output_dir", type=str, default="./vqgan_ckpt")
    train.add_argument("--save_every_steps", type=int, default=1000)
    train.add_argument("--keep_n_checkpoints", type=int, default=None)
    train.add_argument("--resume", action="store_true")
    train.add_argument("--seed", type=int, default=42)
    train.add_argument("--steps", type=int, default=None,
                       help="stop when the step count reaches this")
    train.add_argument("--scan_steps", type=int, default=1)
    train.add_argument("--no_preflight", action="store_true")
    train.add_argument("--sample_every_steps", type=int, default=0,
                       help="write an original/reconstruction grid every N steps")
    train.add_argument("--sample_dir", type=str, default="./vqgan_samples")
    add_overlap_args(ap)
    add_telemetry_args(ap)
    add_distributed_args(ap)
    add_device_arg(ap)
    return ap


def _ints(s: str):
    return tuple(int(x) for x in s.split(","))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_unported_train_args(args)
    if not (args.image_folder or args.synthetic):
        print("error: provide --image_folder or --synthetic", file=sys.stderr)
        return 2
    install_sigusr2_profiler(os.path.join(args.output_dir, "profile"), args)

    import numpy as np

    from ..config import OptimConfig, TrainConfig, VQGANConfig
    from ..models.gan import GANLossConfig
    from ..train.trainer_vqgan import VQGANTrainer

    lr = args.absolute_lr or args.base_lr * args.batch_size
    model_cfg = VQGANConfig(
        resolution=args.resolution, n_embed=args.n_embed, embed_dim=args.embed_dim,
        z_channels=args.z_channels, ch=args.ch, ch_mult=_ints(args.ch_mult),
        num_res_blocks=args.num_res_blocks, attn_resolutions=_ints(args.attn_resolutions),
        dropout=args.dropout, quantizer="gumbel" if args.gumbel else "vq")
    loss_cfg = GANLossConfig(
        disc_start=args.disc_start, disc_weight=args.disc_weight,
        disc_num_layers=args.disc_num_layers, disc_ndf=args.disc_ndf,
        disc_loss=args.disc_loss, codebook_weight=args.codebook_weight,
        perceptual_weight=args.perceptual_weight, use_actnorm=args.use_actnorm)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs, seed=args.seed,
        checkpoint_dir=args.output_dir,
        save_every_steps=args.save_every_steps, keep_n_checkpoints=args.keep_n_checkpoints,
        preflight_checkpoint=not args.no_preflight,
        sample_every_steps=args.sample_every_steps, **overlap_train_kwargs(args),
        runtime_lr_scale=args.breach_actions, obs=obs_config(args),
        optim=OptimConfig(learning_rate=lr, beta1=0.5, beta2=0.9, grad_clip_norm=0.0))
    backend = start_backend(args, args.batch_size)
    root = backend.is_root_worker()
    trainer = VQGANTrainer(model_cfg, train_cfg, loss_cfg, device=args.device, backend=backend)
    if args.resume:
        trainer.restore()
    # images in [-1, 1], taming's convention
    if args.synthetic:
        from ..data.synthetic import ShapesDataset, batch_iterator
        ds = ShapesDataset(image_size=args.resolution)
        raw = batch_iterator(ds, args.batch_size, seed=args.seed, epochs=args.epochs)
        batches = ((imgs * 2.0 - 1.0,) for imgs, _caps in raw)
    else:
        from ..data.loaders import ImageFolderDataset, batch_arrays
        ds = ImageFolderDataset(args.image_folder, image_size=args.resolution)
        rng = np.random.RandomState(args.seed)

        def folder_batches():
            for _ in range(args.epochs):
                order = rng.permutation(len(ds))
                for s in range(0, len(order) - args.batch_size + 1, args.batch_size):
                    imgs, _ = batch_arrays(ds, order[s:s + args.batch_size])
                    yield (imgs * 2.0 - 1.0,)
        batches = folder_batches()
    print(f"VQGAN {model_cfg.quantizer}: {trainer.num_params / 1e6:.2f}M params on "
          f"{trainer.device}; dataset: {len(ds)} samples")

    sample_fn = None
    if args.sample_every_steps:
        os.makedirs(args.sample_dir, exist_ok=True)
        if args.synthetic:
            probe = ds.as_arrays(limit=4)[0] * 2.0 - 1.0
        else:
            probe = batch_arrays(ds, list(range(min(4, len(ds)))))[0] * 2.0 - 1.0

        def sample_fn(step):
            if not root:          # every rank samples alike; rank 0 writes
                return
            recon = trainer.reconstruct(probe).float().cpu().numpy()
            grid = np.concatenate([np.concatenate(list(probe), 1),
                                   np.concatenate(list(recon), 1)], 0)
            write_png(os.path.join(args.sample_dir, f"step{step}_recon.png"),
                      to_uint8((grid[None] + 1.0) * 0.5)[0])
            print(f"[step {step}] recon grid → {args.sample_dir}")

    writer = install_telemetry(args, trainer, args.output_dir)
    install_resilience(args, trainer)
    trainer.fit(batches, steps=args.steps,
                sample_fn=sample_fn, metrics_writer=writer)
    writer.close()
    if root:
        print(f"done at step {trainer.step}; checkpoints in {args.output_dir}")
    leave_backend(backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
