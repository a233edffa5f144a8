#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (dalle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. env       card name and power limit (nvidia-smi), torch/CUDA versions,
             TF32 off for every comparison, the kernels' build (one nvcc per
             csrc/*.cu, all in parallel) and its time.
2. kernel    each CUDA kernel against its plain PyTorch version on the card,
             per cache dtype, at the main path's shape (b=8, h=14, d=128,
             S=512, lengths 1/257/512) and a ragged one (b=3, h=6, d=64,
             S=300), with and without static-mask rows (axial, conv_like);
             then the kernel's time beside its byte bound, the plain
             version's and one library call's (SDPA over the dequantized
             cache, a yardstick the port never calls).
3. decode    at full DALL·E-1.4B width and depth 2, in f32: the cached
             prefill + decode logits equal the uncached forward's at every
             image position.
4. generate  the main path: DalleWithVae.generate_images on DALL·E-1.4B
             (24 layers, dim 1792) + its dVAE, batch 8, random weights from a
             seeded torch.Generator on the card, for float32, bfloat16 and
             bf16_int8kv, plus one classifier-free-guidance run; images must
             be (8, 128, 128, 3) and finite, and the decode kernel's launch
             count must rise by exactly 24·255 per pass (×2 with CFG). Then a
             profiled window of decode steps gives the device's busy share.

Then the card line (nvidia-smi), the kernels line, and last
{"ok": true, "device": {...}}. Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
SMOKE_SEED = 0


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, iters: int, flush=None) -> float:
    """Median device time of ``fn`` over ``iters`` runs, each timed alone
    with CUDA events; ``flush`` (a large buffer) is overwritten before
    every run so the cache reads come from HBM as in the decode loop, where
    other layers' weights evict L2 between two calls of one layer."""
    import torch
    fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_env(torch):
    from dalle_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in _build.build_logs.items()}
    card = card_line()
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         kernels_built=sorted(libs), build_s=round(build_s, 3), ptxas=ptxas)
    return card


def _kernel_cases(torch):
    """(name, b, h, d, S, lengths, mask rows) for the comparison phase."""
    import numpy as np
    from dalle_tpu_torch.ops.attn_masks import build_mask
    text_len, fmap = 257, 16          # DALL·E-1.4B: 256 text + <bos>, 16x16 grid
    masks = {"none": None}
    for t in ("axial_row", "conv_like"):
        masks[t] = torch.from_numpy(
            build_mask(t, text_len, fmap).astype(np.int32)).cuda()
    return [("main", 8, 14, 128, 512, (1, 257, 512), masks),
            ("ragged", 3, 6, 64, 300, (1, 150, 300), masks)]


# the kernel and the plain version compute in f32 from the same inputs; f32
# output differs by summation order only; bf16/int8 caches run with a bf16
# query and output (as on the main path), so the two differ by up to one
# bf16 rounding of an O(1) value
TOL = {"float32": 2e-5, "bfloat16": 1.6e-2, "int8": 1.6e-2}


def _cache(torch, b, h, d, S, dtype, gen):
    from dalle_tpu_torch.ops.attention import KVCache
    cache = KVCache.init(b, h, S, d, dtype, device="cuda")
    k = torch.randn(b, h, S, d, device="cuda", generator=gen)
    v = torch.randn(b, h, S, d, device="cuda", generator=gen)
    return cache.append(k, v, 0)


def phase_kernel(torch):
    import torch.nn.functional as F
    from dalle_tpu_torch.ops import decode_attention as dec
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED)
    errs = {}
    for name, b, h, d, S, lengths, masks in _kernel_cases(torch):
        for dt in ("float32", "bfloat16", "int8"):
            dtype = getattr(torch, dt)
            qdt = torch.float32 if dt == "float32" else torch.bfloat16
            cache = _cache(torch, b, h, d, S, dtype, gen)
            q = torch.randn(b, h, 1, d, device="cuda", generator=gen).to(qdt)
            for mname, mask in masks.items():
                for length in lengths:
                    row = None if mask is None else mask[length - 1]
                    out = dec.decode_attend(q, cache, length, mask_row=row)
                    ref = dec.decode_attend_plain(q, cache.kv, cache.scale, length,
                                                  mask_row=row)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    key = f"{name}/{dt}/{mname}/L{length}"
                    errs[key] = err
                    check(err <= TOL[dt], f"decode_attend {key}: max abs err "
                                          f"{err} > {TOL[dt]}")
    by_dtype = {dt: max(v for k, v in errs.items() if f"/{dt}/" in k) for dt in TOL}
    emit("kernel", kernel="decode_attend", cases=len(errs), tolerance=TOL,
         max_abs_err=by_dtype)

    # timing at the main path's shape over the full cache (length 512, the
    # longest step of the decode loop)
    b, h, d, S = 8, 14, 128, 512
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    timing = {}
    for dt in ("float32", "bfloat16", "int8"):
        dtype = getattr(torch, dt)
        qdt = torch.float32 if dt == "float32" else torch.bfloat16
        cache = _cache(torch, b, h, d, S, dtype, gen)
        q = torch.randn(b, h, 1, d, device="cuda", generator=gen).to(qdt)
        kd, vd = (t.contiguous() for t in cache.read_kv(dtype=qdt))
        saved = dec.launches
        ms = median_ms(lambda: dec.decode_attend(q, cache, S), 50, flush)
        dec.launches = saved          # timing launches are not the main path's
        plain_ms = median_ms(lambda: dec.decode_attend_plain(
            q, cache.kv, cache.scale, S), 20, flush)
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(q, kd, vd), 50, flush)
        itemsize = cache.kv.element_size()
        nbytes = (q.numel() * q.element_size() * 2            # q in, out
                  + b * S * 2 * h * d * itemsize                # K and V
                  + (b * 2 * h * S * 4 if cache.scale is not None else 0))
        ops = 4 * b * h * S * d + 5 * b * h * S
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        timing[dt] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "bytes": nbytes, "roofline_share": max(t_bytes, t_ops) / ms}
    emit("kernel_timing", kernel="decode_attend", shape=dict(b=b, h=h, d=d, S=S, length=S),
         library="torch.nn.functional.scaled_dot_product_attention on the "
                 "dequantized (b,h,S,d) cache", by_cache_dtype=timing)
    return by_dtype, timing


def phase_decode_vs_forward(torch):
    from dalle_tpu_torch import dalle_1p4b, init_dalle
    from dalle_tpu_torch.ops import decode_attention as dec
    cfg = dalle_1p4b(depth=2)
    model = init_dalle(cfg, seed=SMOKE_SEED + 1)
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED + 1)
    b = 2
    text = torch.randint(1, cfg.num_text_tokens, (b, cfg.text_seq_len),
                         device="cuda", generator=gen)
    img = torch.randint(0, cfg.image_vocab_size, (b, cfg.image_seq_len),
                        device="cuda", generator=gen)
    before = dec.launches
    with torch.no_grad():
        full = model(text, img)[:, cfg.text_seq_len:]
        logits, cache, plen = model._prefill(text, None, b)
        steps = [logits]
        for i in range(cfg.image_seq_len - 1):
            logits, cache = model._decode_one(img[:, i], i, plen + i, cache)
            steps.append(logits)
        steps = torch.stack(steps, 1)
    torch.cuda.synchronize()
    err = (steps - full).abs().max().item()
    # the image-token band: the text band holds the -1e9 logits-mask fill
    scale = full[..., model.num_text_tokens:].abs().max().item()
    tol = 1e-3
    check(dec.launches - before == cfg.depth * (cfg.image_seq_len - 1),
          "decode did not launch the kernel once per layer and step")
    check(err <= tol, f"cached decode vs forward: max abs err {err} > {tol}")
    emit("decode_vs_forward", depth=cfg.depth, dim=cfg.dim, heads=cfg.heads,
         positions=cfg.image_seq_len, max_abs_err=err, max_abs_logit=scale,
         tolerance=tol)
    del model, cache


def phase_generate(torch, card):
    from dalle_tpu_torch import (DalleWithVae, DiscreteVAEAdapter, DVAEConfig,
                                 dalle_1p4b, init_dalle, init_dvae)
    from dalle_tpu_torch.ops import decode_attention as dec
    cfg = dalle_1p4b()
    t0 = time.perf_counter()
    model = init_dalle(cfg, seed=SMOKE_SEED)
    vae = init_dvae(DVAEConfig(), seed=SMOKE_SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit("init", params=n_params, seconds=time.perf_counter() - t0)
    wrapper = DalleWithVae(model, DiscreteVAEAdapter(vae))
    b = 8
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED)
    text = torch.randint(1, cfg.num_text_tokens, (b, cfg.text_seq_len),
                         device="cuda", generator=gen)
    text[:, 200:] = 0                                  # padded tail
    per_pass = cfg.depth * (cfg.image_seq_len - 1)
    runs = [("float32", 1.0), ("bfloat16", 1.0), ("bf16_int8kv", 1.0),
            ("float32", 3.0)]
    wrapper._resolve_precision("bfloat16")              # the one-time bf16 cast
    total = 0
    results = []
    dec.launches = 0                     # the main path starts here
    for precision, cond_scale in runs:
        torch.cuda.reset_peak_memory_stats()
        before = dec.launches
        t0 = time.perf_counter()
        images = wrapper.generate_images(
            text, generator=torch.Generator("cuda").manual_seed(SMOKE_SEED),
            precision=precision, cond_scale=cond_scale)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dec.launches - before
        want = per_pass * (2 if cond_scale != 1.0 else 1)
        check(tuple(images.shape) == (b, 128, 128, 3),
              f"images {tuple(images.shape)} != {(b, 128, 128, 3)}")
        check(bool(torch.isfinite(images).all()), f"{precision}: non-finite pixels")
        check(launched == want, f"{precision} cfg={cond_scale}: decode kernel "
                                f"launched {launched} times, expected {want}")
        total += launched
        row = dict(precision=precision, cond_scale=cond_scale, batch=b,
                   wall_s=wall, ms_per_token=wall * 1e3 / cfg.image_seq_len,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   kernel_launches=launched, card=card)
        results.append(row)
        emit("generate", **row)
    launches_main = dec.launches
    check(launches_main == total, "launch count drifted outside the main path")

    # device busy share over a window of bf16 decode steps
    fast, cache_dtype = wrapper._resolve_precision("bfloat16")
    with torch.no_grad():
        logits, cache, plen = fast._prefill(text, None, b, cache_dtype)
        tok = logits[:, fast.num_text_tokens:].argmax(-1)
        steps = 16
        for i in range(3):
            fast._decode_one(tok, i, plen + i, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(3, 3 + steps):
            fast._decode_one(tok, i, plen + i, cache)
        torch.cuda.synchronize()
        bare = time.perf_counter() - t0
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(3 + steps, 3 + 2 * steps):
                fast._decode_one(tok, i, plen + i, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    # device time from the kernel events only (a CPU op's event repeats the
    # time of the kernels it launched); busy time is the union of their
    # intervals, so overlapping kernels count once
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel, spans = {}, []
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
    dev_us, end = 0.0, float("-inf")
    for a, z in sorted(spans):
        dev_us += max(0.0, z - max(a, end))
        end = max(end, z)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("profile", precision="bfloat16", batch=b, decode_steps=steps,
         wall_ms_per_step_unprofiled=bare * 1e3 / steps,
         wall_ms_per_step_profiled=wall * 1e3 / steps,
         device_ms_per_step=dev_us / 1e3 / steps if dev_us else "not measured",
         # device time per step over the unprofiled wall time per step
         device_busy_share=(dev_us / 1e6) / bare if dev_us else "not measured",
         top_device_ms_per_step={k[:80]: v / 1e3 / steps for k, v in top}, card=card)
    return launches_main, results


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs the GPU",
              file=sys.stderr)
        return 2
    try:
        import dalle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2

    card = phase_env(torch)
    errs, timing = phase_kernel(torch)
    phase_decode_vs_forward(torch)
    launches, _ = phase_generate(torch, card)

    f32 = timing["float32"]
    kernels = [{
        "name": "decode_attend", "route": "cuda",
        "source": "dalle_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dalle_tpu/ops/decode_attention.py:94",
        "launches": launches,
        "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs,
        "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
        "timed_at": "b=8 h=14 d=128 S=512 length=512, float32 cache",
        "by_cache_dtype": timing, "tolerance": TOL,
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
