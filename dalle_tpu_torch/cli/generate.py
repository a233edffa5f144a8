"""Generate images from a DALL·E checkpoint on the card.

Port of ``scripts/generate.py``: rebuild the model from the checkpoint's
embedded hparams and the VAE from its sidecar, tokenize the prompts (split
on ``|``), sample with top-k filtering, and write PNGs, one directory per
prompt. Sampling draws from a ``torch.Generator`` seeded by ``--seed``.
With ``--clip_path`` (a ``train_clip`` checkpoint) every batch of a prompt
is kept and scored by the CLIP; the scores are printed best first and the
images written as ``img_{i}.png`` in that order, the scores beside them in
``clip_scores.json``. Runs on the CUDA card unless ``--device cpu``.
``--int8w`` decodes with int8 weights and an int8 KV cache,
``--speculative GAMMA`` (with ``--draft row|repeat``) through the
draft-and-verify sampler, and ``--gentxt`` first completes each prompt
with ``generate_texts`` from its tokens and prints
``gentxt: 'prompt' → 'completion'``. ``--trace DIR`` turns the obs tracer
on: a ``generate/prompt`` span around each prompt, the wrapper's
``decode/*`` spans and per-token latency inside, written to ``DIR`` as
``trace.json`` (Perfetto) and ``spans.jsonl`` with the last per-token
latency printed.

    python -m dalle_tpu_torch.cli.generate --dalle_path ./dalle_ckpt \\
        --text "red circle|blue square" --num_images 8 --batch_size 8 --int8w \\
        --speculative 2 --clip_path ./clip_ckpt

``--fast_topk`` (the TPU's approximate top-k unit) raises
``NotImplementedError`` with its ``ROADMAP.md`` item.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..train.checkpoints import load_clip, load_model_checkpoint
from ._common import (add_device_arg, add_vae_args, build_vae_from_args,
                      load_vae_sidecar, save_image_grid, unported)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dalle_path", type=str, required=True,
                    help="checkpoint dir from dalle_tpu_torch.cli.train_dalle")
    ap.add_argument("--text", type=str, required=True, help="prompt(s), split on |")
    ap.add_argument("--num_images", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--top_k_thres", type=float, default=0.9,
                    help="top-k filter threshold: keeps max(int((1 - thres)·vocab), 1)")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--cond_scale", type=float, default=1.0,
                    help="classifier-free guidance scale")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 weights and KV cache in the decode loop")
    ap.add_argument("--kv_int8", action="store_true",
                    help="bf16 weights and an int8 KV cache")
    ap.add_argument("--int8w", action="store_true",
                    help="int8 weights (per-channel scales) and an int8 KV cache")
    ap.add_argument("--speculative", type=int, default=0, metavar="GAMMA",
                    help="draft-and-verify decode with GAMMA drafts a round "
                         "(sampling-exact; needs cond_scale=1.0)")
    ap.add_argument("--draft", type=str, default="row", choices=("row", "repeat"),
                    help="speculative draft prior: the token one grid row above | "
                         "the last token")
    ap.add_argument("--gentxt", action="store_true",
                    help="complete the caption with generate_texts first")
    ap.add_argument("--outputs_dir", type=str, default="./outputs")
    ap.add_argument("--tokenizer", type=str, default="simple")
    ap.add_argument("--bpe_path", type=str, default=None)
    ap.add_argument("--image_size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clip_path", type=str, default=None,
                    help="checkpoint dir from dalle_tpu_torch.cli.train_clip: rerank "
                         "the images, best first")
    ap.add_argument("--trace", type=str, default=None, metavar="DIR",
                    help="trace the run: per-prompt and decode spans and the per-token "
                         "latency, written to DIR as trace.json (Perfetto) and spans.jsonl")
    unp = ap.add_argument_group("not ported")
    unp.add_argument("--fast_topk", action="store_true")
    add_vae_args(ap)
    add_device_arg(ap)
    return ap


def _check_ported(args):
    for flag, item, on in (("--fast_topk", "6", args.fast_topk),):
        if on:
            raise unported(flag, item)


def load_dalle(ckpt_dir: str, device):
    """The DALLE of a checkpoint, rebuilt from its hparams → (model, meta)."""
    from ..config import DalleConfig
    from ..models.dalle import init_dalle
    return load_model_checkpoint(ckpt_dir, "DALLE", DalleConfig, init_dalle, device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _check_ported(args)

    import numpy as np
    import torch

    from .. import obs
    from ..device import resolve_device
    from ..models.wrapper import DalleWithVae
    from ..text.tokenizer import get_tokenizer

    if args.trace:
        obs.configure()
    device = resolve_device(args.device)
    tok_kw = {"bpe_path": args.bpe_path} if args.bpe_path else {}
    tokenizer = get_tokenizer(args.tokenizer, **tok_kw)
    model, meta = load_dalle(args.dalle_path, device)
    if tokenizer.vocab_size > model.cfg.num_text_tokens:
        print(f"error: tokenizer vocab {tokenizer.vocab_size} > checkpoint "
              f"num_text_tokens {model.cfg.num_text_tokens}: pass the "
              f"--tokenizer/--bpe_path the model was trained with", file=sys.stderr)
        return 2
    explicit_vae = (args.vae_path or args.taming or args.vqgan_model_path or args.untrained_vae
                    or args.openai_vae_dir)
    vae = None if explicit_vae else load_vae_sidecar(args.dalle_path, device)
    if vae is None:
        vae = build_vae_from_args(args, device)
    want = meta.get("vae_class_name")
    if want and want != type(vae).__name__:
        raise ValueError(f"checkpoint was trained with {want}, got "
                         f"{type(vae).__name__}: pass the matching vae flags")
    clip = None
    if args.clip_path:
        clip, _ = load_clip(args.clip_path, device)
    dv = DalleWithVae(model, vae, clip)
    precision = ("int8w" if args.int8w else "bf16_int8kv" if args.kv_int8
                 else "bfloat16" if args.bf16 else "float32")
    generator = torch.Generator(device=device).manual_seed(args.seed)

    prompts = [t.strip() for t in args.text.split("|") if t.strip()]
    for prompt in prompts:
        with obs.span("generate/prompt", prompt=prompt[:64]):
            text_str = prompt
            if args.gentxt:
                prime = tokenizer.tokenize([prompt], model.cfg.text_seq_len, truncate_text=True)
                prime = prime[:, :max(1, int((prime != 0).sum()))]
                out_ids = dv.generate_texts(prime, generator=generator)
                text_str = tokenizer.decode(out_ids[0].tolist())
                print(f"gentxt: {prompt!r} → {text_str!r}")
            text = tokenizer.tokenize([text_str], model.cfg.text_seq_len, truncate_text=True)
            outdir = os.path.join(args.outputs_dir, text_str.replace(" ", "_")[:64])
            os.makedirs(outdir, exist_ok=True)
            made, kept, scores = 0, [], []
            while made < args.num_images:
                n = min(args.batch_size, args.num_images - made)
                out = dv.generate_images(
                    text.repeat(n, 1), generator=generator, filter_thres=args.top_k_thres,
                    temperature=args.temperature, cond_scale=args.cond_scale,
                    precision=precision, clip=clip, speculative=args.speculative,
                    draft=args.draft)
                if clip is None:
                    save_image_grid(out, os.path.join(outdir, f"img_{made}_{{}}.png"))
                else:
                    # the rerank needs the whole set of the prompt
                    kept.append(out[0].float().cpu())
                    scores.append(out[1].float().cpu())
                made += n
            if clip is not None:
                scores = torch.cat(scores).numpy()
                order = np.argsort(-scores, kind="stable")
                print("clip scores (best first): "
                      + " ".join(f"{scores[i]:.4f}" for i in order))
                save_image_grid(torch.cat(kept)[torch.from_numpy(order)],
                                os.path.join(outdir, "img_{}.png"))
                with open(os.path.join(outdir, "clip_scores.json"), "w", encoding="utf-8") as f:
                    json.dump([float(scores[i]) for i in order], f)
            print(f"wrote {made} images for {text_str!r} → {outdir}")
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        n = obs.export_chrome_trace(os.path.join(args.trace, "trace.json"))
        obs.export_spans_jsonl(os.path.join(args.trace, "spans.jsonl"))
        snap = obs.metrics_snapshot()
        if "obs.decode_per_token_ms" in snap:
            print(f"[trace] last per-token decode latency: "
                  f"{snap['obs.decode_per_token_ms']:.3f} ms")
        print(f"[trace] {n} spans → {args.trace}/trace.json (Perfetto), spans.jsonl")
    return 0


if __name__ == "__main__":
    sys.exit(main())
