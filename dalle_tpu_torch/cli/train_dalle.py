"""Train DALL·E on the card from the command line.

Port of ``scripts/train_dalle.py``: tokenizer selection, the VAE chain,
(caption, image) data from a folder (``--image_text_folder``, captions
from ``.txt`` files or ``--text_from_filename``), from tar shards
(``--wds``: a directory, glob, brace range or ``pipe:`` command) or the
synthetic shapes, each batch encoded by the VAE on the card; resume,
checkpoint rotation. Runs on the CUDA card unless ``--device cpu``.

    python -m dalle_tpu_torch.cli.train_dalle --image_text_folder ./pairs \\
        --untrained_vae --image_size 64 --dim 128 --depth 2 --batch_size 8 \\
        --steps 20 --text_seq_len 32 --output_dir ./dalle_ckpt

``--scan_steps k`` runs k steps a ``DalleTrainer.train_steps`` call,
``--ga_steps k`` averages k batches' gradients into each update,
``--lr_scheduler plateau`` scales the rate down on a plateau of the loss,
``--attn_dropout`` and ``--ff_dropout`` train with dropout, and
``--device_prefetch`` / ``--defer_metrics`` set the loop's host overlap,
``--shift_tokens`` trains with token shift and ``--reversible`` with
reversible blocks (``models/reversible.py``). The VAE may be a taming VQGAN
from local files (``--vqgan_model_path`` and ``--vqgan_config_path``) or
OpenAI's (``--openai_vae_dir``).

``--health``, ``--breach_actions``, ``--trace``, ``--watchdog_deadline_s``
and ``--prometheus_path`` arm the trainer's telemetry (``train/base_trainer.py``);
SIGUSR2 takes a bounded ``torch.profiler`` capture (``--profiler_dir``);
every record read goes to ``<output_dir>/metrics.jsonl``, which
``python -m dalle_tpu_torch.cli.obs_report`` summarises. Checkpoints are
written on a thread (``--sync_checkpointing`` writes them in the loop).
SIGTERM finishes the step in flight, saves, and exits 0; SIGUSR1 saves at
the next step (``--no_preemption_handler`` installs neither).

Not ported, and raising ``NotImplementedError`` with its ``ROADMAP.md``
item: ``--wandb`` and ``--log_artifacts``.
"""

from __future__ import annotations

import argparse
import os
import sys

from ._common import (add_device_arg, add_distributed_args, add_overlap_args, add_telemetry_args,
                      add_vae_args, build_vae_from_args, check_unported_train_args,
                      install_resilience, install_sigusr2_profiler, install_telemetry,
                      leave_backend, load_vae_sidecar, obs_config, overlap_train_kwargs,
                      save_vae_sidecar, start_backend, upload_images)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    data = ap.add_argument_group("data")
    data.add_argument("--image_text_folder", type=str, default=None,
                      help="folder pairing images with .txt captions (or filename "
                           "captions with --text_from_filename)")
    data.add_argument("--wds", type=str, default=None,
                      help="tar shards: a directory, glob, brace range or pipe:")
    data.add_argument("--synthetic", action="store_true",
                      help="the synthetic shapes dataset")
    data.add_argument("--text_from_filename", action="store_true")
    data.add_argument("--image_size", type=int, default=128)

    tok = ap.add_argument_group("tokenizer")
    tok.add_argument("--tokenizer", type=str, default="simple",
                     choices=["simple", "yttm", "hug", "chinese"])
    tok.add_argument("--bpe_path", type=str, default=None)

    model = ap.add_argument_group("model")
    model.add_argument("--dim", type=int, default=512)
    model.add_argument("--depth", type=int, default=2)
    model.add_argument("--heads", type=int, default=8)
    model.add_argument("--dim_head", type=int, default=64)
    model.add_argument("--text_seq_len", type=int, default=256)
    model.add_argument("--num_text_tokens", type=int, default=None,
                       help="default: tokenizer vocab size")
    model.add_argument("--attn_types", type=str, default="full",
                       help="comma list: full,axial_row,axial_col,conv_like,sparse")
    model.add_argument("--reversible", action="store_true")
    model.add_argument("--stable", action="store_true")
    model.add_argument("--shift_tokens", action="store_true")
    model.add_argument("--no_rotary", action="store_true")
    model.add_argument("--loss_img_weight", type=float, default=7.0)
    model.add_argument("--attn_dropout", type=float, default=0.0)
    model.add_argument("--ff_dropout", type=float, default=0.0)
    add_vae_args(ap)

    train = ap.add_argument_group("training")
    train.add_argument("--epochs", type=int, default=20)
    train.add_argument("--batch_size", type=int, default=16)
    train.add_argument("--learning_rate", type=float, default=3e-4)
    train.add_argument("--clip_grad_norm", type=float, default=0.5)
    train.add_argument("--ga_steps", type=int, default=1)
    train.add_argument("--null_cond_prob", type=float, default=0.0)
    train.add_argument("--output_dir", type=str, default="./dalle_ckpt")
    train.add_argument("--save_every_n_steps", type=int, default=1000)
    train.add_argument("--keep_n_checkpoints", type=int, default=None)
    train.add_argument("--resume", action="store_true")
    train.add_argument("--seed", type=int, default=42)
    train.add_argument("--lr_scheduler", type=str, default="constant",
                       choices=["constant", "cosine", "exponential", "plateau"])
    train.add_argument("--steps", type=int, default=None,
                       help="stop when the step count reaches this")
    train.add_argument("--scan_steps", type=int, default=1)
    train.add_argument("--no_preflight", action="store_true")
    train.add_argument("--log_artifacts", action="store_true",
                       help="not ported (uploads to wandb)")
    add_overlap_args(ap)
    add_telemetry_args(ap)
    add_distributed_args(ap)
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_unported_train_args(args)
    if not (args.image_text_folder or args.wds or args.synthetic):
        print("error: provide --image_text_folder, --wds or --synthetic", file=sys.stderr)
        return 2
    install_sigusr2_profiler(os.path.join(args.output_dir, "profile"), args)

    import numpy as np

    from ..config import OptimConfig, TrainConfig
    from ..device import resolve_device
    from ..models.wrapper import dalle_config_for_vae
    from ..text.tokenizer import get_tokenizer
    from ..train.trainer_dalle import DalleTrainer

    device = resolve_device(args.device)
    tok_kw = {"bpe_path": args.bpe_path} if args.bpe_path else {}
    tokenizer = get_tokenizer(args.tokenizer, **tok_kw)
    vae = (load_vae_sidecar(args.output_dir, device) if args.resume else None) \
        or build_vae_from_args(args, device)
    if vae.image_size != args.image_size:
        print(f"error: --image_size {args.image_size} != vae.image_size "
              f"{vae.image_size}", file=sys.stderr)
        return 2
    num_text_tokens = args.num_text_tokens or max(tokenizer.vocab_size, 256)
    if num_text_tokens < tokenizer.vocab_size:
        print(f"error: --num_text_tokens {num_text_tokens} < tokenizer vocab "
              f"{tokenizer.vocab_size} (ids would index out of range)", file=sys.stderr)
        return 2
    model_cfg = dalle_config_for_vae(
        vae, num_text_tokens=num_text_tokens, text_seq_len=args.text_seq_len,
        dim=args.dim, depth=args.depth, heads=args.heads, dim_head=args.dim_head,
        attn_types=tuple(args.attn_types.split(",")), stable=args.stable,
        rotary_emb=not args.no_rotary, shift_tokens=args.shift_tokens,
        reversible=args.reversible,
        loss_img_weight=args.loss_img_weight,
        attn_dropout=args.attn_dropout, ff_dropout=args.ff_dropout)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs, seed=args.seed,
        checkpoint_dir=args.output_dir, save_every_steps=args.save_every_n_steps,
        keep_n_checkpoints=args.keep_n_checkpoints,
        preflight_checkpoint=not args.no_preflight, log_artifacts=args.log_artifacts,
        **overlap_train_kwargs(args), runtime_lr_scale=args.breach_actions,
        obs=obs_config(args),
        optim=OptimConfig(learning_rate=args.learning_rate,
                          grad_clip_norm=args.clip_grad_norm,
                          grad_accum_steps=args.ga_steps,
                          lr_scheduler=args.lr_scheduler))
    backend = start_backend(args, args.batch_size)
    root = backend.is_root_worker()
    trainer = DalleTrainer(model_cfg, train_cfg, device=device,
                           null_cond_prob=args.null_cond_prob, backend=backend)
    vae_cfg = getattr(getattr(vae, "model", None), "cfg", None)
    trainer.extra_meta = {"vae_class_name": type(vae).__name__,
                          "vae_hparams": None if vae_cfg is None else vae_cfg.to_dict()}
    if root:
        save_vae_sidecar(args.output_dir, vae)
    if args.resume:
        meta = trainer.restore()
        print(f"resumed at step {trainer.step} "
              f"(ckpt model_class={meta and meta.get('model_class')})")

    # -- data → (text ids, image ids) batches; the ids stay on the card
    def encode_batch(images, captions):
        text = tokenizer.tokenize(list(captions), args.text_seq_len, truncate_text=True)
        return text, vae.get_codebook_indices(upload_images(images, device))

    if args.synthetic:
        from ..data.synthetic import ShapesDataset, batch_iterator
        ds = ShapesDataset(image_size=args.image_size)
        raw = batch_iterator(ds, args.batch_size, seed=args.seed, epochs=args.epochs)
        batches = (encode_batch(imgs, caps) for imgs, caps in raw)
    elif args.wds:
        from ..data.webdataset import WebDataset
        wds = (WebDataset(args.wds, shuffle_shards=True, repeat=args.epochs, seed=args.seed)
               .decode(image_size=args.image_size)
               .map(lambda s: (next(s[k] for k in ("jpg", "jpeg", "png") if k in s),
                               next(s[k] for k in ("txt", "text", "caption") if k in s)))
               .shuffle(256)
               .batched(args.batch_size))
        batches = (encode_batch(np.stack(imgs), caps) for imgs, caps in wds.prefetch())
    else:
        from ..data.text_image import TextImageDataset
        ds = TextImageDataset(args.image_text_folder, image_size=args.image_size,
                              shuffle=True, seed=args.seed,
                              text_from_filename=args.text_from_filename)
        raw = ds.batches(args.batch_size, epochs=args.epochs)
        batches = (encode_batch(imgs, caps) for imgs, caps in raw)
    if root:
        print(f"DALLE: {trainer.num_params / 1e6:.1f}M params on {device}; "
              f"vae {type(vae).__name__}; mesh {trainer.mesh.shape}")
    writer = install_telemetry(args, trainer, args.output_dir)
    install_resilience(args, trainer)
    trainer.fit(batches, steps=args.steps, metrics_writer=writer)
    writer.close()
    if trainer.preempted:
        print(f"preempted at step {trainer.step}; checkpoint durable")
    if root:
        print(f"done at step {trainer.step}; checkpoints in {args.output_dir}")
    leave_backend(backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
