"""Train the discrete VAE on the card from the command line.

Port of ``scripts/train_vae.py``: the dVAE's flags, Adam under the
exponential learning-rate schedule, the gumbel temperature's anneal,
checkpoints (the last step is saved at the end), and with
``--sample_every_steps`` a grid of probe images over their hard
reconstructions (``<sample_dir>/step{N}_recon.png``) and the number of codes
the probe uses. Its checkpoints are what ``train_dalle --vae_path`` reads.
Runs on the CUDA card unless ``--device cpu``.

    python -m dalle_tpu_torch.cli.train_vae --image_folder ./images \\
        --image_size 64 --num_layers 2 --hidden_dim 32 --num_tokens 256 \\
        --batch_size 8 --steps 100 --output_dir ./vae_ckpt

The images come from a folder (``--image_folder``: random square crops,
``data/text_image.py``) or the synthetic shapes (``--synthetic``).

``--scan_steps k`` runs k steps a ``train_steps`` call. ``--health``, ``--breach_actions``, ``--trace``, ``--watchdog_deadline_s``
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
                      help="folder of images")
    data.add_argument("--synthetic", action="store_true",
                      help="the synthetic shapes dataset")

    model = ap.add_argument_group("model")
    model.add_argument("--image_size", type=int, default=128)
    model.add_argument("--num_tokens", type=int, default=8192)
    model.add_argument("--codebook_dim", type=int, default=512)
    model.add_argument("--num_layers", type=int, default=3)
    model.add_argument("--num_resnet_blocks", type=int, default=1)
    model.add_argument("--hidden_dim", type=int, default=64)
    model.add_argument("--smooth_l1_loss", action="store_true")
    model.add_argument("--kl_loss_weight", type=float, default=0.0)
    model.add_argument("--straight_through", action="store_true")

    train = ap.add_argument_group("training")
    train.add_argument("--epochs", type=int, default=20)
    train.add_argument("--batch_size", type=int, default=8)
    train.add_argument("--learning_rate", type=float, default=1e-3)
    train.add_argument("--lr_decay_rate", type=float, default=0.98)
    train.add_argument("--starting_temp", type=float, default=1.0)
    train.add_argument("--temp_min", type=float, default=0.5)
    train.add_argument("--anneal_rate", type=float, default=1e-6)
    train.add_argument("--clip_grad_norm", type=float, default=0.0)
    train.add_argument("--output_dir", type=str, default="./vae_ckpt")
    train.add_argument("--save_every_steps", type=int, default=1000)
    train.add_argument("--keep_n_checkpoints", type=int, default=None)
    train.add_argument("--seed", type=int, default=42)
    train.add_argument("--steps", type=int, default=None,
                       help="stop when the step count reaches this")
    train.add_argument("--scan_steps", type=int, default=1)
    train.add_argument("--no_preflight", action="store_true")
    train.add_argument("--sample_every_steps", type=int, default=0,
                       help="write a reconstruction grid and count the codes used "
                            "every N steps")
    train.add_argument("--sample_dir", type=str, default="./vae_samples")
    add_overlap_args(ap)
    add_telemetry_args(ap)
    add_distributed_args(ap)
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_unported_train_args(args)
    if not (args.image_folder or args.synthetic):
        print("error: provide --image_folder or --synthetic", file=sys.stderr)
        return 2
    install_sigusr2_profiler(os.path.join(args.output_dir, "profile"), args)

    import numpy as np

    from ..config import AnnealConfig, DVAEConfig, OptimConfig, TrainConfig
    from ..train.trainer_vae import VAETrainer

    model_cfg = DVAEConfig(
        image_size=args.image_size, num_tokens=args.num_tokens,
        codebook_dim=args.codebook_dim, num_layers=args.num_layers,
        num_resnet_blocks=args.num_resnet_blocks, hidden_dim=args.hidden_dim,
        smooth_l1_loss=args.smooth_l1_loss, kl_div_loss_weight=args.kl_loss_weight,
        straight_through=args.straight_through)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs, seed=args.seed,
        checkpoint_dir=args.output_dir,
        save_every_steps=args.save_every_steps,
        keep_n_checkpoints=args.keep_n_checkpoints,
        preflight_checkpoint=not args.no_preflight,
        sample_every_steps=args.sample_every_steps, **overlap_train_kwargs(args),
        runtime_lr_scale=args.breach_actions, obs=obs_config(args),
        optim=OptimConfig(learning_rate=args.learning_rate,
                          grad_clip_norm=args.clip_grad_norm,
                          lr_scheduler="exponential", lr_decay_rate=args.lr_decay_rate))
    anneal = AnnealConfig(starting_temp=args.starting_temp, temp_min=args.temp_min,
                          anneal_rate=args.anneal_rate)
    if args.synthetic:
        from ..data.synthetic import ShapesDataset, batch_iterator
        ds = ShapesDataset(image_size=args.image_size)
        raw = batch_iterator(ds, args.batch_size, seed=args.seed, epochs=args.epochs)
    else:
        from ..data.text_image import TextImageDataset
        ds = TextImageDataset(args.image_folder, image_size=args.image_size, shuffle=True,
                              seed=args.seed, text_from_filename=True)
        raw = ds.batches(args.batch_size, epochs=args.epochs)
    backend = start_backend(args, args.batch_size)
    root = backend.is_root_worker()
    trainer = VAETrainer(model_cfg, train_cfg, anneal, device=args.device, backend=backend)
    print(f"dVAE: {trainer.num_params / 1e6:.2f}M params on {trainer.device}; "
          f"dataset: {len(ds)} samples")

    sample_fn = None
    if args.sample_every_steps:
        os.makedirs(args.sample_dir, exist_ok=True)
        # the JAX script's probe: a folder's first shuffled batch, drawn from
        # the dataset's generator before training
        probe = (ds.as_arrays(limit=8)[0] if args.synthetic
                 else next(iter(ds.batches(min(args.batch_size, 8), epochs=1)))[0])

        def sample_fn(step):
            if not root:          # every rank samples alike; rank 0 writes
                return
            recons = trainer.reconstruct(probe, hard=True).float().cpu().numpy()
            grid = np.concatenate([np.concatenate(list(probe), 1),
                                   np.concatenate(list(recons), 1)], 0)
            write_png(os.path.join(args.sample_dir, f"step{step}_recon.png"),
                      to_uint8(grid[None])[0])
            used = int((trainer.codebook_histogram(probe) > 0).sum())
            print(f"[step {step}] recon grid → {args.sample_dir}; codebook codes used: "
                  f"{used}/{model_cfg.num_tokens}")

    writer = install_telemetry(args, trainer, args.output_dir)
    install_resilience(args, trainer)
    trainer.fit(((images,) for images, _captions in raw), steps=args.steps,
                sample_fn=sample_fn, metrics_writer=writer)
    writer.close()
    if root:
        print(f"done at step {trainer.step}; checkpoints in {args.output_dir}")
    leave_backend(backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
