"""Train a CLIP reranker on the card from the command line.

Port of ``scripts/train_clip.py``: captions through the tokenizer, the
contrastive step (``CLIPTrainer``), checkpoints (the last step is saved at
the end). Its checkpoints are what ``generate --clip_path`` reads; the
image size must be the dVAE's. Runs on the CUDA card unless ``--device
cpu``.

    python -m dalle_tpu_torch.cli.train_clip --image_text_folder ./pairs \\
        --image_size 128 --patch_size 16 --dim 512 --depth 6 --batch_size 8 \\
        --steps 100 --output_dir ./clip_ckpt

The (caption, image) pairs come from a folder (``--image_text_folder``,
captions from ``.txt`` files or ``--text_from_filename``;
``data/text_image.py``) or the synthetic shapes.

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

from ._common import (add_device_arg, add_overlap_args, add_telemetry_args,
                      check_unported_train_args, install_resilience, install_sigusr2_profiler,
                      install_telemetry, obs_config, overlap_train_kwargs)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    data = ap.add_argument_group("data")
    data.add_argument("--image_text_folder", type=str, default=None,
                      help="folder pairing images with .txt captions (or filename "
                           "captions with --text_from_filename)")
    data.add_argument("--synthetic", action="store_true",
                      help="the synthetic shapes dataset")
    data.add_argument("--text_from_filename", action="store_true")
    data.add_argument("--image_size", type=int, default=256)

    tok = ap.add_argument_group("tokenizer")
    tok.add_argument("--tokenizer", type=str, default="simple",
                     choices=["simple", "yttm", "hug", "chinese"])
    tok.add_argument("--bpe_path", type=str, default=None)

    model = ap.add_argument_group("model")
    model.add_argument("--dim", type=int, default=512,
                       help="the text and image towers' width and the latent's")
    model.add_argument("--depth", type=int, default=6)
    model.add_argument("--heads", type=int, default=8)
    model.add_argument("--text_seq_len", type=int, default=256)
    model.add_argument("--patch_size", type=int, default=32)
    model.add_argument("--num_text_tokens", type=int, default=None,
                       help="default: tokenizer vocab size")

    train = ap.add_argument_group("training")
    train.add_argument("--epochs", type=int, default=20)
    train.add_argument("--batch_size", type=int, default=32)
    train.add_argument("--learning_rate", type=float, default=3e-4)
    train.add_argument("--clip_grad_norm", type=float, default=0.5)
    train.add_argument("--output_dir", type=str, default="./clip_ckpt")
    train.add_argument("--save_every_n_steps", type=int, default=1000)
    train.add_argument("--seed", type=int, default=42)
    train.add_argument("--steps", type=int, default=None,
                       help="stop when the step count reaches this")
    train.add_argument("--scan_steps", type=int, default=1)
    train.add_argument("--no_preflight", action="store_true")
    add_overlap_args(ap)
    add_telemetry_args(ap)
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_unported_train_args(args)
    if not (args.image_text_folder or args.synthetic):
        print("error: provide --image_text_folder or --synthetic", file=sys.stderr)
        return 2
    install_sigusr2_profiler(os.path.join(args.output_dir, "profile"), args)

    import numpy as np

    from ..config import ClipConfig, OptimConfig, TrainConfig
    from ..text.tokenizer import get_tokenizer
    from ..train.trainer_clip import CLIPTrainer

    tok_kw = {"bpe_path": args.bpe_path} if args.bpe_path else {}
    tokenizer = get_tokenizer(args.tokenizer, **tok_kw)
    num_text_tokens = args.num_text_tokens or max(tokenizer.vocab_size, 256)
    if num_text_tokens < tokenizer.vocab_size:
        print(f"error: --num_text_tokens {num_text_tokens} < tokenizer vocab "
              f"{tokenizer.vocab_size}", file=sys.stderr)
        return 2
    model_cfg = ClipConfig(
        dim_text=args.dim, dim_image=args.dim, dim_latent=args.dim,
        num_text_tokens=num_text_tokens, text_enc_depth=args.depth,
        text_seq_len=args.text_seq_len, text_heads=args.heads,
        visual_enc_depth=args.depth, visual_heads=args.heads,
        visual_image_size=args.image_size, visual_patch_size=args.patch_size)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs, seed=args.seed,
        checkpoint_dir=args.output_dir,
        save_every_steps=args.save_every_n_steps,
        preflight_checkpoint=not args.no_preflight, **overlap_train_kwargs(args),
        runtime_lr_scale=args.breach_actions, obs=obs_config(args),
        optim=OptimConfig(learning_rate=args.learning_rate,
                          grad_clip_norm=args.clip_grad_norm))
    trainer = CLIPTrainer(model_cfg, train_cfg, device=args.device)

    def encode_batch(images, captions):
        text = tokenizer.tokenize(list(captions), args.text_seq_len, truncate_text=True)
        return text, np.asarray(images, np.float32)

    if args.synthetic:
        from ..data.synthetic import ShapesDataset, batch_iterator
        ds = ShapesDataset(image_size=args.image_size)
        raw = batch_iterator(ds, args.batch_size, seed=args.seed, epochs=args.epochs)
    else:
        from ..data.text_image import TextImageDataset
        ds = TextImageDataset(args.image_text_folder, image_size=args.image_size,
                              shuffle=True, seed=args.seed,
                              text_from_filename=args.text_from_filename)
        raw = ds.batches(args.batch_size, epochs=args.epochs)
    print(f"CLIP: {trainer.num_params / 1e6:.1f}M params on {trainer.device}")
    writer = install_telemetry(args, trainer, args.output_dir)
    install_resilience(args, trainer)
    trainer.fit((encode_batch(imgs, caps) for imgs, caps in raw), steps=args.steps,
                metrics_writer=writer)
    writer.close()
    print(f"done at step {trainer.step}; checkpoints in {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
