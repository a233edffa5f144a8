"""Train DALL·E on the card from the command line.

Port of ``scripts/train_dalle.py``: tokenizer selection, the VAE chain,
synthetic (caption, image) data encoded by the dVAE, resume, checkpoint
rotation. Runs on the CUDA card unless ``--device cpu``.

    python -m dalle_tpu_torch.cli.train_dalle --synthetic --untrained_vae \\
        --image_size 64 --dim 128 --depth 2 --batch_size 8 --steps 20 \\
        --text_seq_len 32 --output_dir ./dalle_ckpt

``--scan_steps k`` runs k steps a ``DalleTrainer.train_steps`` call,
``--ga_steps k`` averages k batches' gradients into each update,
``--lr_scheduler plateau`` scales the rate down on a plateau of the loss,
``--attn_dropout`` and ``--ff_dropout`` train with dropout, and
``--device_prefetch`` / ``--defer_metrics`` set the loop's host overlap,
and ``--shift_tokens`` trains with token shift.

Not ported yet, and raising ``NotImplementedError`` with their
``ROADMAP.md`` item: ``--image_text_folder`` and ``--wds`` (the card's
machine has no image decoder), ``--reversible`` and the telemetry flags.
"""

from __future__ import annotations

import argparse
import sys

from ._common import (add_device_arg, add_overlap_args, add_vae_args, build_vae_from_args,
                      load_vae_sidecar, overlap_train_kwargs, save_vae_sidecar, unported)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    data = ap.add_argument_group("data")
    data.add_argument("--image_text_folder", type=str, default=None,
                      help="folder of images with .txt captions (not ported yet)")
    data.add_argument("--wds", type=str, default=None,
                      help="WebDataset shards (not ported yet)")
    data.add_argument("--synthetic", action="store_true",
                      help="the synthetic shapes dataset")
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
    add_overlap_args(ap)

    tel = ap.add_argument_group("telemetry (not ported yet)")
    tel.add_argument("--trace", action="store_true")
    tel.add_argument("--watchdog_deadline_s", type=float, default=0.0)
    tel.add_argument("--prometheus_path", type=str, default="")
    add_device_arg(ap)
    return ap


def _check_ported(args):
    if args.image_text_folder or args.wds:
        raise unported("--image_text_folder / --wds (no image decoder on the card's "
                       "machine)", "3")
    if args.reversible:
        raise unported("--reversible", "9")
    if args.trace or args.watchdog_deadline_s or args.prometheus_path:
        raise unported("the telemetry flags (--trace, --watchdog_deadline_s, "
                       "--prometheus_path)", "12")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _check_ported(args)
    if not args.synthetic:
        print("error: provide --synthetic", file=sys.stderr)
        return 2

    from ..config import OptimConfig, TrainConfig
    from ..data.synthetic import ShapesDataset, batch_iterator
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
        loss_img_weight=args.loss_img_weight,
        attn_dropout=args.attn_dropout, ff_dropout=args.ff_dropout)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, seed=args.seed,
        checkpoint_dir=args.output_dir, save_every_steps=args.save_every_n_steps,
        keep_n_checkpoints=args.keep_n_checkpoints,
        preflight_checkpoint=not args.no_preflight, **overlap_train_kwargs(args),
        optim=OptimConfig(learning_rate=args.learning_rate,
                          grad_clip_norm=args.clip_grad_norm,
                          grad_accum_steps=args.ga_steps,
                          lr_scheduler=args.lr_scheduler))
    trainer = DalleTrainer(model_cfg, train_cfg, device=device,
                           null_cond_prob=args.null_cond_prob)
    trainer.extra_meta = {"vae_class_name": type(vae).__name__,
                          "vae_hparams": vae.model.cfg.to_dict()}
    save_vae_sidecar(args.output_dir, vae)
    if args.resume:
        meta = trainer.restore()
        print(f"resumed at step {trainer.step} "
              f"(ckpt model_class={meta and meta.get('model_class')})")

    def encode_batch(images, captions):
        text = tokenizer.tokenize(list(captions), args.text_seq_len, truncate_text=True)
        return text, vae.get_codebook_indices(images)

    ds = ShapesDataset(image_size=args.image_size)
    raw = batch_iterator(ds, args.batch_size, seed=args.seed, epochs=args.epochs)
    batches = (encode_batch(imgs, caps) for imgs, caps in raw)
    print(f"DALLE: {trainer.num_params / 1e6:.1f}M params on {device}; "
          f"vae {type(vae).__name__}")
    trainer.fit(batches, steps=args.steps)
    print(f"done at step {trainer.step}; checkpoints in {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
