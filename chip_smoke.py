#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (dalle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. env          card name and power limit (nvidia-smi), torch/CUDA versions,
                TF32 off for every comparison, the kernels' build (one nvcc
                per csrc/*.cu, all in parallel) and its time.
2. kernel       K2 (decode attention: a cluster of nsplit CTAs per (b, h)
                over a cp.async ring, decode_plan's split and stages)
                against its plain PyTorch version on the card, per cache
                dtype, at the serving path's shape (b=8, h=14, d=128, S=512,
                lengths 0/1/257/512), a ragged one (b=3, h=6, d=64, S=300),
                with and without static-mask rows (axial, conv_like), the
                long-sequence model's cache (b=2, h=8, d=64, S=4352) and
                S=65536 (b=h=1, d=64) with a holed mask row; length 0 gives
                0, two runs the same bits, the kernel's shared memory equals
                decode_plan's; nvcc's registers and spills of K2's and K7's
                kernels beside K3/K5's. Then its time beside its byte bound,
                the plain version's, K3's cluster split on the same cache
                (starts = S - 1) and one library call's (SDPA over the
                dequantized cache, a yardstick the port never calls, with
                the kernels it ran).
3. train_kernel K1 (fused attention, forward and backward; mma.sync tiles,
                a cp.async ring, a two-pass softmax) against its plain
                versions on the card: the training shape (b=8, n=512, h=14,
                d=128), a ragged one (b=3, n=77, h=6, d=64) and n=513 at the
                main widths, f32 and bf16 qkv, with no table and with
                axial_row, conv_like and sparse tables; the long-sequence
                layer (b=2, n=4352, h=8, d=64, bf16) with no table and with
                axial_row on its 64x64 grid; and a peaked softmax (q scaled
                by 8) at the training shape, held to flip_tolerance. Then
                both kernels' times at the training shape and at 4,352
                tokens beside their bounds, the plain versions', SDPA's
                forward and backward on the split (b, h, n, d) layout (the
                library yardstick) and, as a constant, the earlier wmma
                design's.
4. decode       at full DALL·E-1.4B width and depth 2, in f32, dense
                attention: the cached prefill + decode logits equal the
                uncached forward's at every image position, and K1 is not
                launched.
5. train_parity at full width and depth 2, f32 compute: the loss and every
                parameter's gradient of one training step through K1's
                kernels equal the same step through K1's plain version.
6. generate     the serving path: DalleWithVae.generate_images on DALL·E-1.4B
                (24 layers, dim 1792) + its dVAE, batch 8, random weights
                from a seeded torch.Generator on the card, for float32,
                bfloat16 and bf16_int8kv, plus one classifier-free-guidance
                run; images must be (8, 128, 128, 3) and finite, and K2's
                launch count must rise by exactly 24·255 per pass (×2 with
                CFG). Then a profiled window of decode steps gives the
                device's busy share and K2's device ms per step.
7. train        the training path: DalleTrainer.train_step on DALL·E-1.4B,
                batch 8, bf16 compute over f32 masters, Adam (lr 3e-4,
                clip 0.5), loss_chunk 128, 6 steps on one fixed batch;
                losses finite and falling, K1's forward and backward each
                launched exactly 24 times per step. Then ms/step, tokens/s,
                peak memory, one profiled step's busy share and top kernels,
                and, for the record, the step with dense attention.
8. serve_kernel K3 (windowed decode attention over the dense slab) and K5
                (the same over a paged pool) against their plain versions on
                every route of window_plan (tensor-core tiles of 64 rows
                for a refill window over a bf16 or int8 cache, a
                cluster split for a decode step, f32 FMA for an f32 cache at
                w > 1): f32, bf16 and int8 caches, windows of 1, 2, 15, 16,
                17, 63, 64, 65 and 257 queries, ragged starts (S-w, 0, a
                parked row at S), the serving shape (b=8, h=14, d=128,
                S=512), the same at b=1 and a ragged one (b=3, h=6, d=64,
                S=300); a peaked softmax (q × 8) at w=1 and 257; all within
                window_tolerance; K5 with 16-token blocks, pages in a
                random order and some unmapped. K5 must equal K3 on the
                gathered slab bit for bit on every row that is not parked,
                and a second call must give the same bits; every route must
                have run. Reports the plans, the route counters and nvcc's
                registers and spills per kernel. Then both kernels' times
                at the serving shape (w=1 and 257 at b=8, 257 at b=1, and
                the paged engine's 16-query prefill chunks at b=8 and b=1)
                beside their bounds, the plain versions', SDPA's with a
                boolean mask on the dequantized cache (the library
                yardstick), and a decode step on each split of 2, 4, 8.
9. serve_parity at full width and depth 2, in f32: the dense engine's tokens
                for four requests (one ragged) equal the sequential
                generate_images_tokens' (K2) under the same generator seeds,
                and a paged engine (16-token blocks, a pool that evicts,
                repeated prompts that hit the radix cache) gives the dense
                engine's tokens.
10. serve       the serving engine: DalleWithVae.serve_engine on DALL·E-1.4B,
                8 slots, bf16_int8kv, dense then paged, 16 requests (10 full,
                3 ragged, 1 CFG, a 2-member shared-prefix cohort; half of
                them from a producer thread while the engine runs), the paged
                run with 4 repeated prompts and one that shares 128 text
                tokens with another. Every request completes with in-range
                tokens of its length; K3 launches 24 times per attending
                dispatch in the dense run and never in the paged one, K5 the
                other way round; the refill windows run on the tensor-core
                route and the decode steps on the cluster split, none on
                the f32 route. Then requests/s, tokens/s, TTFT, ms per
                step, the radix ledger, peak memory and a profiled window's
                busy share.

11. flash_kernel K4 (block-sparse flash attention: forward, dq, dk/dv) against
                its plain versions, f32 operands on the f32 route (the TPU's
                arithmetic, kernel_tolerance) and bf16 operands on the
                tensor-core route (against operands="bf16",
                tc_kernel_tolerance; and its cost against the f32
                arithmetic, rounding_tolerance), each launch counted by
                route, comparing o, lse, dq, dk and
                dv per element: the long-sequence slice's shape (b=2, h=8,
                n=4352, d=64) with no mask, the axial_row, axial_col and
                conv_like specs and sparse through ("block", 128); the
                DALL·E-1.4B attention shape (b=8, h=14, n=512, d=128) causal
                and axial_row; a ragged one (b=3, h=6, n=77, d=64) with a
                tabled 16-block sparse mask and a fully masked row; and a
                non-causal one (n=300, d=32); the route's tiles, shared
                memory and nvcc's registers and spills. Then the three
                kernels' times in bf16 at the slice's layer kinds and the
                1.4B shape beside their bounds (visible pairs at the bf16
                tensor rate, or bytes), the plain versions', SDPA's and the
                f32 route's on the same values.
12. flash_parity at the long-sequence model's full width (dim 512, 8 × 64,
                4,352 tokens), depth 4, batch 1, f32 compute: the loss and
                every parameter's gradient of one step through K4's kernels
                (f32 route) equal the same step through its plain versions;
                the same step in bf16 compute through the tensor-core route
                against the plain versions with operands="bf16" (loss within
                2^-8, gradients within 2^-4 of their largest entry); and
                DALL·E-1.4B at depth 2 in "flash" mode against "off", f32
                logits.
13. train_long  the long-sequence training path: DalleTrainer.train_step on
                scripts/bench_sweep.py's longseq config, batch 2, defaults
                (use_pallas "auto", remat on, loss_chunk 0), bf16 compute,
                Adam (lr 3e-4, clip 0.5), 6 steps on one fixed batch; losses
                finite and falling, K4's forward launched 8 times per step
                (remat recomputes it) and dq, dk/dv 4 times each, every one
                on the tensor-core route, K1 never.
                Then ms/step, tokens/s, model FLOP/s, peak memory, one
                profiled step's busy share and top kernels, and for the
                record the same step with dense attention and with K1.

14. persist_kernel K8 (whole-sequence attention: forward, and the backward's
                dq and dk/dv kernels; mma.sync tiles, a cp.async ring, a
                two-pass softmax, K1's design) against its plain versions,
                comparing o, dq, dk and dv per element with
                fused_attention.kernel_tolerance (K1's arithmetic): the
                DALL·E-1.4B layer (b=8, h=14, n=512, d=128) causal and with
                its axial_row MaskTable, the DALL·E-small layer (b=64, h=8,
                n=512, d=64), a ragged one (n=77) with a row that sees
                nothing and a conv_like table, n=513 causal and axial_row,
                f32 inputs (q rounded twice), n=2,048 at d=128, and a peaked
                softmax (q scaled by 8) held to flip_tolerance; the backward
                from the forward's (m, l) equals the one that recomputes
                them, bit for bit; the head views of a (b, n, 3·h·d)
                projection equal contiguous copies and two runs the same
                bits; nvcc's registers and spills per instance. Then both
                kernels' times in bf16 at the 1.4B and small layers beside
                their bounds, the plain versions', SDPA's (with the kernels
                it ran) and K1's on the same data in its merged (b, n, 3·h·d)
                layout.
15. chunked_kernel K7 (chunked long-cache decode attention, one kernel on K2's
                cluster split) against its plain version within
                decode_attention.chunked_tolerance: the JAX
                package's bench shapes (b=64 h=8 S=1280 d=64, b=16 h=14 S=2560
                d=128) and the long-sequence model's cache (b=2 h=8 S=4352
                d=64), f32, bf16 and int8 caches, lengths at 25, 50 and 100 %
                of S, a mask row, and length 0 (o = 0); two runs the same
                bits, and one call runs exactly one kernel (profiled). Then
                its time over the whole cache beside its byte bound, K2's on
                the same inputs, the plain version's and SDPA's on the
                dequantized cache (with its kernels). No path selects K7
                (opt-in in both packages).
16. persist_parity at full width and depth 2, f32 compute, use_pallas
                "persist": the loss and every parameter's gradient of one step
                through K8's kernels equal the same step through its plain
                versions.
17. train_persist the persist training path: phase train's recipe with
                use_pallas "persist", 6 steps; losses finite and falling, K8's
                forward and backward each launched exactly 24 times per step,
                K1 never; ms/step, tokens/s, peak memory, one profiled step's
                busy share and top kernels, beside phase train's K1 step (the
                step-1 losses agree within 1e-2 relative).

18. ring_kernel K6 (the ring's chunk kernels: forward, dq, dk/dv over one
                (q-chunk, k-chunk) pair at global offsets) against its plain
                versions, comparing o, lse, dq, dk and dv per element: f32
                operands on the f32 route (the TPU's arithmetic,
                kernel_tolerance), bf16 operands on the tensor-core route
                (K4's design, tc_*_kernel, against operands="bf16",
                tc_kernel_tolerance; and its cost against the f32
                arithmetic, rounding_tolerance), each launch counted by
                route: the slice's pair (b=2, h=8, c=1088, d=64) on the
                diagonal, wholly before and wholly in the future (o = 0, lse
                = -1e9, zero gradients), and a peaked softmax (q x 8) on the
                diagonal; a ragged pair (c=544, d=128) with n_valid inside
                the k chunk; axial_row, axial_col and conv specs on global
                positions; non-causal; and the zigzag ring's strided
                sub-chunk views, bit for bit their contiguous copies; the
                route's shared memory and nvcc's registers and spills. Then
                the three kernels' times in bf16 at the slice's pair
                (diagonal, before, future) beside their bounds (visible
                pairs at the bf16 tensor rate, or bytes), the plain
                versions', SDPA's with the pair's boolean mask and the f32
                route's on the same values; and the whole ring at the layer
                (b=2, h=8, n=4,352, P=2, zigzag) beside K4 and SDPA on the
                whole sequence.
19. ring_parity  the long-sequence model at full width, depth 2, batch 1, f32,
                sp=2 and sp=4 (P ranks in this process): the loss and every
                parameter's gradient of one step through K6 equal the same
                step through K6's plain versions and through the dense ring
                body.
20. train_ring  the sequence-parallel training path: phase train_long's recipe
                with TrainConfig(mesh=MeshConfig(sp=2)), 6 steps; losses
                finite and falling, K6 launched 128 / 64 / 64 times per step
                (forward / dq / dk-dv; remat recomputes the forward), every
                one on the tensor-core route, K1, K4 and K8 never; step-1
                loss within 1e-2 relative of train_long's; ms/step,
                tokens/s, peak memory, one profiled step's busy share and
                top kernels.

21. cli       the command-line flow at DALL·E-1.4B's widths (dim 1792, 14
                heads of 128, 256 text tokens over the 49,408-token CLIP BPE,
                256 image tokens over an 8,192-entry dVAE codebook at 128 px),
                depth cut to 2: the native BPE core's build and the
                tokenizer's µs per prompt; ``cli.train_dalle --synthetic`` for
                3 steps at batch 8 into build/cli_smoke/ (one finalized step
                left, no tmp directory), a fresh trainer's restore of it
                equal bit for bit to the checkpoint's tensors, timed with a
                save beside the reckoned bytes; a ``--resume`` run for one
                step more; ``cli.generate --bf16`` of two prompts × 8 images,
                16 PNGs of 128 × 128 equal bit for bit to an in-process
                DalleWithVae.generate_images with the same seed and weights.
                K1 and K2 counted from zero around each entry point and
                checked launched. Each entry point's wall seconds, generate's
                ms per image token.
22. paper     the paper's three models through their entry points, in
                build/paper_smoke/: ``cli.train_vae`` at the full-width dVAE
                (8,192 codes, codebook 512, 3 layers, hidden 64) for 30
                steps at batch 8 with a reconstruction grid every 15;
                ``cli.train_dalle --vae_path`` on its checkpoint at the 1.4B
                widths, depth 2, 2 steps (K1 launched; the VAE sidecar equal
                bit for bit to train_vae's last step); ``cli.train_clip`` at
                the full-width CLIP (dim 512, depth 6, 8 heads, 256 text
                tokens) on 128 px with 16 px patches, 5 steps; ``cli.generate
                --clip_path --bf16`` of 8 images (K2 launched 2 · 255 times):
                the 8 PNGs best first and their scores equal bit for bit to
                an in-process generate_images(clip=…). CLIP launches none of
                K1, K2 and K4. Then CLIP's ms to score 8 images, 10 timed
                steps each of the dVAE and CLIP trainers, the codes the
                trained dVAE uses; and NaN rollback: VAETrainer.fit over three
                batches, the second poisoned, saving every step: right after
                the NaN step the masters and the optimizer state (its count
                included) equal step 1's checkpoint bit for bit, the run ends
                at step 3 with no step 2 written, and step 3 replayed from
                step 1's checkpoint gives the same bits; the snapshot's mode,
                bytes and ms.

23. recipe    bench.py's training recipe: DalleTrainer.train_steps on
                DALL·E-1.4B, batch 8, bf16 compute over f32 masters,
                Adafactor with clipping at 0.5, k = 5 steps a call,
                metrics_every 1000 (no step reads the host), the same
                batch stacked five times as bench.py does; two warm-up calls
                and two timed ones, each ending in a read of one master
                element; loss_mean finite and falling between the timed
                calls, K1's forward and backward each launched 24 times a
                step. Then ms/step, tokens/s, bench.py's model TFLOP/s
                (6·N + 12·L·h·d·n a token), peak memory beside phase train's
                Adam peak, Adafactor's state bytes beside Adam's moments, the
                optimizer's step alone (CUDA events) for Adafactor and Adam on
                the same gradients, a profiled call's device ms and busy
                share, and the synchronising calls of one call under
                set_sync_debug_mode("warn") (none may be in the training
                loop's own files). At depth 2 and full width: train_steps
                (k = 3) ≡ three train_step calls ≡ fit (scan_steps 3, host
                batches through the prefetcher's side stream) bit for bit,
                masters and the whole optimizer state, for Adafactor with
                dropout 0.1 and CFG nulls, and for accumulation over 2 with
                the plateau schedule (the first mini-step moves no master);
                Optimizer.step for both under set_sync_debug_mode("error").
                Then ``cli.train_dalle`` at phase cli's shapes with
                --scan_steps 2 --ga_steps 2 --lr_scheduler plateau
                --device_prefetch 2 --defer_metrics --attn_dropout 0.1 for 4
                steps and --resume for 2 more, in build/recipe_cli/.

24. decode_surface the JAX package's decode surface at DALL·E-1.4B, batch 8:
                W8 (int8-weight product, csrc/int8w_linear.cu: mma.sync
                with the weights converted in registers for bf16 x, f32 FMA
                for f32 x) against its plain version at every QLinear shape
                and 1, 8, 16, 24, 40, 64 rows (1-4 tiles of 16 rows) within
                int8w_tolerance, rows 0, M/2 and M-1 alone equal to the
                same rows inside M; its times at 8-64 rows beside its
                bound, the matmul route (dequantize, torch.matmul), the
                plain version and torch.matmul on the bf16 weight, and
                both routes summed over a decode step's QLinears; nvcc's
                report; K3 on the speculative verify's caches (S = 514-516,
                w = 2, 3, 5, distinct starts; tc and fma routes) within
                window_tolerance; generate_images in int8w at full depth
                beside phase generate's bf16_int8kv run, and with CFG at
                depth 2 (finite images, K2 depth·255 per pass, W8 launches
                per route: the prefills' projections on the matmul route,
                every decode step's QLinears on the kernel), the first
                decode step's logits within 0.1 of the bf16 model's
                largest; the speculative sampler at depth 2 (full width)
                at gamma 0, 1, 2, 4 (bf16) and 0, 2 (f32), and at full
                depth at gamma 0, 2 (bf16), each on one draw table: rounds,
                ms per image, K3 per round on its route, and each against
                gamma=0 "equal" or its first divergence, whose score gap
                must lie within 2^-5 of the row's largest logit;
                generate_texts from 4 tokens to 256 (K2 24·251); the int8w
                engine (the new default) dense and paged with 8 requests,
                K3/K5 and W8 counted, and one request against sequential
                int8w generation (agreement and the first divergence's
                score gap reported, not checked); a depth-2 model overfit
                to a constant image, gamma=3 "repeat" equal to gamma=0 in
                at most 128 rounds; token shift: cached decode ≡ forward at
                depth 2 in f32, a DalleTrainer step through K1, full-depth
                bf16 generation (K2 24·255).

Phases 11-20, 23 and 24 run beside their kin: flash_kernel, persist_kernel,
chunked_kernel and ring_kernel after serve_kernel; flash_parity,
persist_parity and ring_parity after serve_parity; decode_surface after
serve; recipe and then train_persist after train; train_long and then
train_ring, then cli and paper last. Each prints its seconds.

Then the card line (nvidia-smi), the kernels line, and last
{"ok": true, "device": {...}}. Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor cores
SMOKE_SEED = 0


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def check_same_tree(torch, live, saved, what):
    """Nested dicts and lists of tensors (an optimizer's ``state_dict``)
    equal bit for bit, structure and plain values included."""
    if isinstance(live, torch.Tensor):
        check(isinstance(saved, torch.Tensor)
              and torch.equal(live, saved.to(live.device)), f"{what} differs")
    elif isinstance(live, dict):
        check(isinstance(saved, dict) and live.keys() == saved.keys(), f"{what}: keys")
        for k in live:
            check_same_tree(torch, live[k], saved[k], f"{what}.{k}")
    elif isinstance(live, (list, tuple)):
        check(len(live) == len(saved), f"{what}: length")
        for i, (a, b) in enumerate(zip(live, saved)):
            check_same_tree(torch, a, b, f"{what}[{i}]")
    else:
        check(live == saved, f"{what}: {live!r} != {saved!r}")


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


def host_us_per_call(torch, fn, calls: int = 500) -> float:
    """Median over three runs of the host's µs per call of ``fn`` issued back
    to back without a synchronise (the launch queue does not fill at this
    count, so this is the enqueue cost the host pays per call)."""
    runs = []
    for _ in range(3):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return statistics.median(runs)


def device_time(torch, prof):
    """(busy µs, {kernel name's first 80 characters: µs}) of a profile. Device time comes from the
    kernel events only (a CPU op's event repeats the time of the kernels it
    launched); busy time is the union of their intervals, so overlapping
    kernels count once."""
    by_kernel, spans = {}, []
    for e in prof.events():
        # user annotations (e.g. "Optimizer.step#Adam.step") are spans on the
        # device timeline, not kernels: they would count idle gaps as busy.
        # (Kernel names may hold "#" too, as in "{lambda(int)#1}".)
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or re.fullmatch(r"[\w.]+#[\w.]+", e.name)):
            continue
        name = e.name[:80]
        by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
    dev_us, end = 0.0, float("-inf")
    for a, z in sorted(spans):
        dev_us += max(0.0, z - max(a, end))
        end = max(end, z)
    return dev_us, by_kernel


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
    """(name, b, h, d, S, lengths, masks) for the comparison phase: a mask is
    a (rows, S) int32 table whose row min(length, rows) - 1 the query uses."""
    import numpy as np
    from dalle_tpu_torch.ops.attn_masks import build_mask
    text_len, fmap = 257, 16          # DALL·E-1.4B: 256 text + <bos>, 16x16 grid
    masks = {"none": None}
    for t in ("axial_row", "conv_like"):
        masks[t] = torch.from_numpy(
            build_mask(t, text_len, fmap).astype(np.int32)).cuda()

    def holes(S):                      # one row with every fifth position masked
        return {"none": None, "holes": (torch.arange(S, device="cuda") % 5 != 2).int()[None]}
    return [("main", 8, 14, 128, 512, (0, 1, 257, 512), masks),
            ("ragged", 3, 6, 64, 300, (1, 150, 300), masks),
            # the long-sequence model's cache, and a cache far past one CTA's
            # shared memory (the split's does not grow with S)
            ("longseq", 2, 8, 64, 4352, (1, 1467, 4352), holes(4352)),
            ("S65536", 1, 1, 64, 65536, (1, 21862, 65536), holes(65536))]


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


def k2_build():
    """nvcc's report (registers, spills) of K2's and K7's kernels and, beside
    them, of K3/K5's, whose source they must leave unmoved."""
    return {"decode_split_kernel": ptxas_report("decode_attention", "decode_split_kernel"),
            "chunked_split_kernel": ptxas_report("decode_chunked_attention",
                                                 "chunked_split_kernel"),
            "K3_K5": ptxas_report("decode_window_attention", "window_kernel")}


def phase_kernel(torch, card):
    import torch.nn.functional as F
    from dalle_tpu_torch.ops import _build
    from dalle_tpu_torch.ops import decode_attention as dec
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED)
    smem_fn = _build.library("decode_attention").decode_attend_smem_bytes
    smem_fn.argtypes = [ctypes.c_int] * 5
    smem_fn.restype = ctypes.c_longlong
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    errs, plans = {}, {}
    saved = dec.launches
    for name, b, h, d, S, lengths, masks in _kernel_cases(torch):
        for dt in ("float32", "bfloat16", "int8"):
            dtype = getattr(torch, dt)
            qdt = torch.float32 if dt == "float32" else torch.bfloat16
            plan = dec.decode_plan(b, h, S, d, dtype, sm_count)
            lib_smem = smem_fn(dec._DTYPE_CODE[dtype], d, plan.rows, plan.stages, plan.nsplit)
            check(lib_smem == plan.smem, f"decode_plan's shared memory {plan.smem} != the "
                                         f"kernel's {lib_smem} ({name}/{dt})")
            plans[f"{name}/{dt}"] = plan._asdict()
            cache = _cache(torch, b, h, d, S, dtype, gen)
            q = torch.randn(b, h, 1, d, device="cuda", generator=gen).to(qdt)
            for mname, mask in masks.items():
                for length in lengths:
                    row = None if mask is None else mask[max(1, min(length, mask.shape[0])) - 1]
                    out = dec.decode_attend(q, cache, length, mask_row=row)
                    ref = dec.decode_attend_plain(q, cache.kv, cache.scale, length,
                                                  mask_row=row)
                    torch.cuda.synchronize()
                    key = f"{name}/{dt}/{mname}/L{length}"
                    if length == 0:
                        check(not out.any(), f"decode_attend {key}: length 0 does not give 0")
                    err = (out.float() - ref.float()).abs().max().item()
                    errs[key] = err
                    check(err <= TOL[dt], f"decode_attend {key}: max abs err "
                                          f"{err} > {TOL[dt]}")
            if name == "main":         # two runs, the same bits
                for length in (1, 300, 512):
                    again = [dec.decode_attend(q, cache, length) for _ in range(2)]
                    torch.cuda.synchronize()
                    check(torch.equal(*again), f"decode_attend {name}/{dt}/L{length}: two "
                                               "runs differ")
            del cache
    dec.launches = saved              # the comparison launches are not the main path's
    by_dtype = {dt: max(v for k, v in errs.items() if f"/{dt}/" in k) for dt in TOL}
    # the host's side of a launch (length 1: the card's side is shorter)
    b, h, d, S = 8, 14, 128, 512
    cache = _cache(torch, b, h, d, S, torch.bfloat16, gen)
    q = torch.randn(b, h, 1, d, device="cuda", generator=gen).to(torch.bfloat16)
    host_us = host_us_per_call(torch, lambda: dec.decode_attend(q, cache, 1))
    dec.launches = saved
    del cache
    emit("kernel", kernel="decode_attend", cases=len(errs), tolerance=TOL,
         max_abs_err=by_dtype, plans=plans, deterministic=True, build=k2_build(),
         host_us_per_call=host_us)

    # timing at the main path's shape over the full cache (length 512, the
    # longest step of the decode loop), beside K3's cluster split on the
    # same cache (a decode step, starts = S - 1) and SDPA
    b, h, d, S = 8, 14, 128, 512
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    timing = {}
    for dt in ("float32", "bfloat16", "int8"):
        dtype = getattr(torch, dt)
        qdt = torch.float32 if dt == "float32" else torch.bfloat16
        cache = _cache(torch, b, h, d, S, dtype, gen)
        q = torch.randn(b, h, 1, d, device="cuda", generator=gen).to(qdt)
        kd, vd = (t.contiguous() for t in cache.read_kv(dtype=qdt))
        starts = torch.full((b,), S - 1, dtype=torch.int32, device="cuda")
        saved, saved_w = dec.launches, window_counts(dec)
        ms = median_ms(lambda: dec.decode_attend(q, cache, S), 50, flush)
        k3 = median_ms(lambda: dec.decode_attend_window(q, cache, starts), 50, flush)
        dec.launches = saved          # timing launches are not the main path's
        window_set_counts(dec, saved_w)
        plain_ms = median_ms(lambda: dec.decode_attend_plain(
            q, cache.kv, cache.scale, S), 20, flush)
        sdpa = lambda: F.scaled_dot_product_attention(q, kd, vd)  # noqa: E731
        lib_ms = median_ms(sdpa, 50, flush)
        itemsize = cache.kv.element_size()
        nbytes = (q.numel() * q.element_size() * 2            # q in, out
                  + b * S * 2 * h * d * itemsize                # K and V
                  + (b * 2 * h * S * 4 if cache.scale is not None else 0))
        ops = 4 * b * h * S * d + 5 * b * h * S
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        timing[dt] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound,
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "bytes": nbytes, "roofline_share": bound / ms,
                      "k3_split_ms": k3, "k3_split_roofline_share": bound / k3,
                      "library_roofline_share": bound / lib_ms,
                      "plan": dec.decode_plan(b, h, S, d, dtype, sm_count)._asdict(),
                      "library_kernels": sdpa_kernels(torch, sdpa)}
        del cache, kd, vd
    emit("kernel_timing", kernel="decode_attend", shape=dict(b=b, h=h, d=d, S=S, length=S),
         library="torch.nn.functional.scaled_dot_product_attention on the "
                 "dequantized (b,h,S,d) cache",
         k3_split="decode_attend_window (K3) with starts = S - 1: w = 1 on its cluster "
                  "split, the same cache", card=card, by_cache_dtype=timing)
    return by_dtype, timing


def phase_decode_vs_forward(torch):
    from dalle_tpu_torch import dalle_1p4b, init_dalle
    from dalle_tpu_torch.ops import decode_attention as dec
    from dalle_tpu_torch.ops import fused_attention as fa
    # dense full forward: "auto" would send it through K1, whose bf16
    # roundings the f32 cached path does not share
    cfg = dalle_1p4b(depth=2, use_pallas="off")
    model = init_dalle(cfg, seed=SMOKE_SEED + 1)
    k1_before = fa.fwd_launches
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
    check(fa.fwd_launches == k1_before, "the dense forward launched K1")
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
    dev_us, by_kernel = device_time(torch, prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    k2_us = sum(v for k, v in by_kernel.items() if "decode_split_kernel" in k)
    emit("profile", precision="bfloat16", batch=b, decode_steps=steps,
         wall_ms_per_step_unprofiled=bare * 1e3 / steps,
         wall_ms_per_step_profiled=wall * 1e3 / steps,
         device_ms_per_step=dev_us / 1e3 / steps if dev_us else "not measured",
         k2_device_ms_per_step=k2_us / 1e3 / steps if dev_us else "not measured",
         # device time per step over the unprofiled wall time per step
         device_busy_share=(dev_us / 1e6) / bare if dev_us else "not measured",
         top_device_ms_per_step={k: v / 1e3 / steps for k, v in top}, card=card)
    return launches_main, results



# ---------------------------------------------------------------------------
# K1 and the training path
# ---------------------------------------------------------------------------

# K1 against its plain version: each element within
# fused_attention.kernel_tolerance (2e-3 of the largest output, plus 2^-7 of
# the element itself for bf16); the row max m within 1e-5 absolute and the
# row sum l within 1e-5 relative (f32 sums in another order)
K1_TOL = {"out_and_dqkv": "2e-3*max(1,max|want|) + (2^-7*|want| for bf16), per element",
          "m_abs": 1e-5, "l_rel": 1e-5}
# the peaked case (q scaled by 8): p near 1, where one flipped bf16 rounding
# costs 2^-8*|v|, more than kernel_tolerance's margin, and |m| near 50, where
# f32 sums of s in another order differ by a few ulps; held to
# fused_attention.flip_tolerance and m relative to max(1, |m|)
K1_PEAKED_TOL = {"out_and_dqkv": "fused_attention.flip_tolerance: 2^-7*rounding_bound + "
                                 "kernel_tolerance, per element",
                 "m_rel": 1e-5, "l_rel": 1e-5}


def k1_bounds(b, n, h, d, itemsize, table):
    """Least card time of K1's forward and backward for these inputs:
    {"fwd"|"bwd": (bound ms, "bytes"|"operations")}. Operations count the
    visible pairs (the table's ones, causality included): 2 products of
    2·d flops each forward (s, p·v), 6 backward (s, o, dp, dq, dk, dv), at
    the bf16 tensor-core rate. Bytes count each input read once and each
    output written once: forward qkv in, out and (m, l) out; backward qkv,
    dO and (m, l) in, dqkv out; plus the table and tile map."""
    nt = -(-n // 64)
    pairs = b * h * (n * (n + 1) // 2 if table is None else int(table.table.long().sum()))
    tbl = 0 if table is None else n * n + nt * nt
    qkv, out, stats = b * n * 3 * h * d * itemsize, b * n * h * d * itemsize, 2 * b * h * n * 4
    work = {"fwd": (2 * 2 * d * pairs, qkv + out + stats + tbl),
            "bwd": (6 * 2 * d * pairs, qkv + out + stats + qkv + tbl)}
    res = {}
    for k, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        res[k] = (max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
                  ops, nbytes)
    return res


# K1's earlier design (wmma 16x16x16 tiles with the scores through shared
# memory, synchronous loads) at the training shape, bf16 causal, for the
# record beside this run's times: its range on an NVIDIA H100 80GB HBM3 at
# 700 W, as PERF.md section 6 gives it
K1_WMMA_DESIGN_MS = {"fwd": "0.382-0.387", "bwd": "0.937-0.943",
                     "source": "PERF.md section 6 (chip_smoke.py train_kernel_timing "
                               "on the wmma design)"}


def _k1_cases():
    """(name, b, n, h, d, table kinds, dtypes, q multiplier, grid width) of
    the K1 comparisons: the training shape, a ragged one and n=513 with
    every table kind in both dtypes; the long-sequence layer (4,352 tokens,
    the 64x64 grid) in bf16; and a peaked softmax at the training shape
    (q scaled by 8, so one key dominates each row)."""
    kinds, both = ("full", "axial_row", "conv_like", "sparse"), ("float32", "bfloat16")
    return [("main", 8, 512, 14, 128, kinds, both, 1.0, None),
            ("ragged", 3, 77, 6, 64, kinds, both, 1.0, None),
            ("n513", 4, 513, 14, 128, kinds, both, 1.0, None),
            ("long", 2, 4352, 8, 64, ("full", "axial_row"), ("bfloat16",), 1.0, 64),
            ("peaked", 8, 512, 14, 128, ("full",), both, 8.0, None)]


def _k1_timing(torch, fa, b, n, h, d, gen, flush):
    """K1's forward and backward times (bf16 qkv, full causal) beside their
    bounds, the plain versions' and SDPA's forward and backward on the split
    (b, h, n, d) layout (the library yardstick)."""
    import torch.nn.functional as F
    qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).bfloat16()
    do = torch.randn(b, n, h * d, device="cuda", generator=gen).bfloat16()
    _, m, l = fa.fused_attention_fwd(qkv, h)
    saved = fa.fwd_launches, fa.bwd_launches
    fwd_ms = median_ms(lambda: fa.fused_attention_fwd(qkv, h), 30, flush)
    bwd_ms = median_ms(lambda: fa.fused_attention_bwd(qkv, do, m, l, h), 30, flush)
    fa.fwd_launches, fa.bwd_launches = saved    # timing launches are not the main path's
    plain_fwd = median_ms(lambda: fa.fused_attention_fwd_plain(qkv, h), 5, flush)
    plain_bwd = median_ms(lambda: fa.fused_attention_bwd_plain(qkv, do, m, l, h), 5, flush)
    q, k, v = (t.contiguous().requires_grad_(True) for t in
               qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4))
    do_split = do.view(b, n, h, d).transpose(1, 2).contiguous()
    with torch.no_grad():
        lib_fwd = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                            30, flush)
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    lib_bwd = median_ms(lambda: torch.autograd.grad(o, (q, k, v), do_split, retain_graph=True),
                        30, flush)
    bounds = k1_bounds(b, n, h, d, 2, None)
    timing = {}
    for w, ms, plain, lib in (("fwd", fwd_ms, plain_fwd, lib_fwd),
                              ("bwd", bwd_ms, plain_bwd, lib_bwd)):
        bound, by_what, ops, nbytes = bounds[w]
        timing[w] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                     "bound_by": by_what, "flops": ops, "bytes": nbytes,
                     "roofline_share": bound / ms, "library_factor": ms / lib}
    return timing


def k1_build(source="fused_attention"):
    """K1's kernels (or K8's copy of their design, ``source``
    "persistent_attention") as nvcc reported them, by instance
    ("fwd_kernel<bf16,128>": registers, spills), and their shared memory per
    CTA from the formulas of the source (*_smem, the same in both)."""
    ptxas = {}
    for fn, lines in ptxas_report(source, "_kernelI").items():
        m = re.search(r"(fwd_kernel|dq_kernel|dkv_kernel)I(f|13__nv_bfloat16)Li(\d+)E", fn)
        name = f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'},{m.group(3)}>" if m else fn
        ptxas[name] = lines
    tile = {d: 64 * (d + 8) * 2 for d in (64, 128)}
    return {"threads_per_cta": {"fwd": 128, "dq": 256, "dkv": 256},
            "smem_bytes_per_cta": {d: {"fwd": 4 * t, "dq": 6 * t + 256, "dkv": 6 * t + 1536}
                                   for d, t in tile.items()},
            "ptxas": ptxas or "no build log in this process"}


def phase_train_kernel(torch, card):
    from dalle_tpu_torch.ops import fused_attention as fa
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED + 2)
    errs, shares, stats = {}, {}, {}
    for name, b, n, h, d, kinds, dtypes, q_mult, fmap in _k1_cases():
        for kind in kinds:
            table = fa.layer_table(kind, n, device="cuda", fmap=fmap)
            for dt in dtypes:
                dtype = getattr(torch, dt)
                qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).to(dtype)
                qkv[..., :h * d] *= q_mult
                do = torch.randn(b, n, h * d, device="cuda", generator=gen).to(dtype)
                out, m, l = fa.fused_attention_fwd(qkv, h, table)
                dqkv = fa.fused_attention_bwd(qkv, do, m, l, h, table)
                ro, rm, rl = fa.fused_attention_fwd_plain(qkv, h, table)
                rdq = fa.fused_attention_bwd_plain(qkv, do, rm, rl, h, table)
                peaked = q_mult != 1.0
                bounds = fa.rounding_bound(qkv, do, rm, rl, h, table) if peaked else None
                torch.cuda.synchronize()
                key = f"{name}/{kind}/{dt}"
                m_err = (m - rm).abs().max().item()
                m_rel = ((m - rm).abs() / rm.abs().clamp(min=1.0)).max().item()
                l_err = ((l - rl).abs() / rl).max().item()
                stats[key] = {"m_abs": m_err, "m_rel": m_rel, "l_rel": l_err}
                m_ok = m_rel <= K1_PEAKED_TOL["m_rel"] if peaked else m_err <= K1_TOL["m_abs"]
                check(m_ok and l_err <= K1_TOL["l_rel"],
                      f"K1 {key}: row max err {m_err} ({m_rel} of |m|), row sum rel err {l_err}")
                for i, (which, got, want) in enumerate((("fwd", out, ro), ("bwd", dqkv, rdq))):
                    diff = (got.float() - want.float()).abs()
                    # the worst element's share of its own bound
                    tol = (fa.flip_tolerance(want, bounds[i]) if peaked
                           else fa.kernel_tolerance(want))
                    share = (diff / tol).max().item()
                    if peaked:    # for the record: kernel_tolerance does not hold p near 1
                        stats[key][f"{which}_share_of_kernel_tolerance"] = (
                            diff / fa.kernel_tolerance(want)).max().item()
                    errs[f"{which}/{key}"] = diff.max().item()
                    shares[f"{which}/{key}"] = share
                    check(math.isfinite(share) and share <= 1.0,
                          f"K1 {which}/{key}: an element is {share} of its bound "
                          f"(max abs err {diff.max().item()})")
                del qkv, do, out, dqkv, ro, rdq, bounds
    by = {f"{w}/{dt}": max(v for k, v in errs.items() if k.startswith(w + "/")
                           and k.endswith("/" + dt))
          for w in ("fwd", "bwd") for dt in ("float32", "bfloat16")}
    share_by = {f"{w}/{dt}": max(v for k, v in shares.items() if k.startswith(w + "/")
                                 and k.endswith("/" + dt))
                for w in ("fwd", "bwd") for dt in ("float32", "bfloat16")}
    share_by_case = {c: max(v for k, v in shares.items() if k.split("/")[1] == c)
                     for c in {k.split("/")[1] for k in shares}}
    emit("train_kernel", kernels=["fused_attention_fwd", "fused_attention_bwd"],
         cases=len(errs), tolerance=K1_TOL, peaked_tolerance=K1_PEAKED_TOL, max_abs_err=by,
         worst_share_of_bound=share_by,
         worst_share_by_shape=share_by_case,
         worst_m_abs=max(v["m_abs"] for k, v in stats.items() if not k.startswith("peaked/")),
         worst_l_rel=max(v["l_rel"] for v in stats.values()),
         peaked={k: v for k, v in stats.items() if k.startswith("peaked/")},
         build=k1_build())
    torch.cuda.empty_cache()

    # times, bf16 qkv, full causal: the training shape, and the long-sequence
    # layer (train_long_others' K1 step)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    timing = _k1_timing(torch, fa, 8, 512, 14, 128, gen, flush)
    long_timing = _k1_timing(torch, fa, 2, 4352, 8, 64, gen, flush)
    emit("train_kernel_timing", shape=dict(b=8, n=512, h=14, d=128, dtype="bfloat16",
                                           mask="causal"),
         library="torch.nn.functional.scaled_dot_product_attention(is_causal=True) on "
                 "the split (b,h,n,d) bf16 layout: forward, and its backward alone",
         wmma_design_ms=K1_WMMA_DESIGN_MS, long=dict(shape=dict(b=2, n=4352, h=8, d=64), **long_timing),
         card=card, **timing)
    del flush
    torch.cuda.empty_cache()
    return errs, timing


def _train_batch(cfg, b, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    text = rng.randint(1, cfg.num_text_tokens, (b, cfg.text_seq_len))
    text[:, 200:] = 0                                  # padded tail
    img = rng.randint(0, cfg.image_vocab_size, (b, cfg.image_seq_len))
    return text, img


def phase_train_parity(torch):
    from dalle_tpu_torch import (DalleTrainer, OptimConfig, PrecisionConfig, TrainConfig,
                                 dalle_1p4b)
    from dalle_tpu_torch.ops import fused_attention as fa
    cfg = dalle_1p4b(depth=2)
    tc = TrainConfig(batch_size=8, seed=SMOKE_SEED + 3,
                     optim=OptimConfig(learning_rate=3e-4, grad_clip_norm=0.5),
                     precision=PrecisionConfig(compute="float32"))
    tr = DalleTrainer(cfg, tc)
    text, img = _train_batch(cfg, 8, SMOKE_SEED + 3)
    text = torch.from_numpy(text).cuda()
    img = torch.from_numpy(img).cuda()

    def grads():
        tr.optimizer.zero_grad()
        before = fa.fwd_launches, fa.bwd_launches
        loss, _ = tr.loss_and_backward(text, img)
        torch.cuda.synchronize()
        launched = (fa.fwd_launches - before[0], fa.bwd_launches - before[1])
        return loss.item(), {n: p.grad.clone() for n, p in tr.model.named_parameters()}, launched

    loss_k, g_k, launched_k = grads()
    kernels = fa.fused_attention_fwd, fa.fused_attention_bwd
    fa.fused_attention_fwd, fa.fused_attention_bwd = (fa.fused_attention_fwd_plain,
                                                      fa.fused_attention_bwd_plain)
    try:
        loss_p, g_p, launched_p = grads()
    finally:
        fa.fused_attention_fwd, fa.fused_attention_bwd = kernels
    check(launched_k == (cfg.depth, cfg.depth), f"kernel step launched K1 {launched_k}")
    check(launched_p == (0, 0), f"plain step launched K1 {launched_p}")
    # f32 compute, the same inputs: K1's bf16 roundings match except where
    # the kernel's summation order flips one (see kernel_tolerance); a weight's
    # gradient sums such terms over every position: 1e-2 of each tensor's
    # largest gradient, 1e-4 of the loss
    worst, worst_name = 0.0, ""
    for name, gp in g_p.items():
        scale = gp.abs().max().item()
        share = (g_k[name] - gp).abs().max().item() / max(scale, 1e-30)
        if share > worst or not math.isfinite(share):
            worst, worst_name = share, name
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(math.isfinite(loss_k) and loss_err <= 1e-4, f"loss {loss_k} vs plain {loss_p}")
    check(worst <= 1e-2, f"gradient of {worst_name}: {worst} of its largest entry")
    emit("train_parity", depth=cfg.depth, dim=cfg.dim, heads=cfg.heads, batch=8,
         compute="float32", loss_kernel=loss_k, loss_plain=loss_p, loss_rel_err=loss_err,
         tensors=len(g_p), worst_grad_err_share=worst, worst_grad_tensor=worst_name,
         tolerance=dict(loss_rel=1e-4, grad_share_of_largest=1e-2))
    del tr, g_k, g_p
    torch.cuda.empty_cache()


def phase_train(torch, card):
    from dalle_tpu_torch import DalleTrainer, OptimConfig, TrainConfig, dalle_1p4b
    from dalle_tpu_torch.ops import fused_attention as fa
    torch.cuda.empty_cache()
    cfg = dalle_1p4b()
    b, steps = 8, 6
    tc = TrainConfig(batch_size=b, seed=SMOKE_SEED,
                     optim=OptimConfig(optimizer="adam", learning_rate=3e-4, grad_clip_norm=0.5))
    t0 = time.perf_counter()
    tr = DalleTrainer(cfg, tc)
    torch.cuda.synchronize()
    emit("train_init", params=tr.num_params, seconds=time.perf_counter() - t0,
         compute=tc.precision.compute, optimizer=tc.optim.optimizer)
    text, img = _train_batch(cfg, b, SMOKE_SEED)
    text = torch.from_numpy(text).cuda()
    img = torch.from_numpy(img).cuda()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    fa.fwd_launches = fa.bwd_launches = 0          # the training path starts here
    for _ in range(steps):
        t0 = time.perf_counter()
        m = tr.train_step(text, img)               # ends in a host read of the metrics
        walls.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    launches = {"fused_attention_fwd": fa.fwd_launches, "fused_attention_bwd": fa.bwd_launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over {steps} steps: {losses}")
    for name, n in launches.items():
        check(n == steps * cfg.depth, f"{name} launched {n} times in {steps} steps, "
                                      f"expected {steps * cfg.depth}")
    ms = statistics.median(walls[1:]) * 1e3
    tokens = b * cfg.total_seq_len
    row = dict(batch=b, steps=steps, losses=losses, grad_norm_last=m["grad_norm"],
               ms_per_step_first=walls[0] * 1e3, ms_per_step=ms,
               tokens_per_s=tokens / ms * 1e3, samples_per_s=b / ms * 1e3,
               model_tflops_per_s=tr.flops_per_step / ms / 1e9,
               peak_gib=peak, launches=launches, card=card)
    emit("train", **row)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.train_step(text, img)
        wall = time.perf_counter() - t0
    dev_us, by_kernel = device_time(torch, prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    k1_us = {w: sum(v for k, v in by_kernel.items() if f"::{w}_kernel<" in k)
             for w in ("fwd", "dq", "dkv")}
    emit("train_profile", wall_ms_profiled=wall * 1e3,
         device_ms=dev_us / 1e3 if dev_us else "not measured",
         device_busy_share=(dev_us / 1e3) / ms if dev_us else "not measured",
         k1_device_ms={w: v / 1e3 for w, v in k1_us.items()},
         k1_device_share=sum(k1_us.values()) / dev_us if dev_us else "not measured",
         top_device_ms={k: v / 1e3 for k, v in top},
         kernel_launches=sum(1 for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA),
         card=card)

    # for the record: the same step with dense attention (cuBLAS + softmax)
    tcfg = tr.model.transformer.cfg
    tr.model.transformer.cfg = dataclasses.replace(tcfg, use_pallas="off")
    dense = []
    for _ in range(3):
        t0 = time.perf_counter()
        tr.train_step(text, img)
        dense.append(time.perf_counter() - t0)
    tr.model.transformer.cfg = tcfg
    emit("train_dense", ms_per_step=statistics.median(dense[1:]) * 1e3,
         ms_per_step_fused=ms, card=card)
    del tr
    torch.cuda.empty_cache()
    return launches, row


# ---------------------------------------------------------------------------
# bench.py's recipe: Adafactor, k steps a call, the metrics cadence
# ---------------------------------------------------------------------------

RECIPE_K = 5                     # bench.py: train_steps with k = 5 per dispatch
RECIPE_METRICS_EVERY = 1000      # bench.py: no step waits on the host
# this package's own files: a synchronising call in one of them is a fault
RECIPE_OWN = ("train_state.py", "base_trainer.py", "trainer_dalle.py", "device_prefetch.py")


def _stacked(torch, cfg, k, b, seed):
    """k copies of one ``_train_batch`` on the card, as bench.py stacks them."""
    text, img = _train_batch(cfg, b, seed)
    return (torch.from_numpy(text).cuda()[None].repeat(k, 1, 1),
            torch.from_numpy(img).cuda()[None].repeat(k, 1, 1))


def _sync_calls(torch, fn):
    """Run ``fn`` under ``set_sync_debug_mode("warn")`` → (the synchronising
    calls made inside the port: one (innermost frame in ``dalle_tpu_torch/``,
    innermost frame) pair of "path:line" places each, from the Python stack
    at the warning; and the places of any made outside it, such as by the
    mode's own switch)."""
    import os
    import traceback
    import warnings
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dalle_tpu_torch") + os.sep
    places, outside = [], []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()
                 if not f.filename.endswith(os.sep + "warnings.py")]
        ours = [f for f in stack if f.filename.startswith(root)]
        inner = f"{stack[-1].filename}:{stack[-1].lineno}"
        if ours:
            places.append((f"{ours[-1].filename[len(root):]}:{ours[-1].lineno}", inner))
        else:
            outside.append(inner)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return places, outside


def _recipe_parity(torch, card):
    """At depth 2 and full width, f32 masters and bf16 compute:
    train_steps(k=3) ≡ three train_step calls ≡ fit with scan_steps=3 over
    host batches through the prefetcher (its side stream), bit for bit, for
    Adafactor with attention and feed-forward dropout 0.1 and CFG nulls; and
    for Adafactor with grad_accum_steps=2 and the plateau schedule, whose
    first mini-step moves no master. Then Optimizer.step under
    set_sync_debug_mode("error") for Adafactor, accumulation and plateau."""
    import numpy as np

    from dalle_tpu_torch import DalleTrainer, OptimConfig, TrainConfig, dalle_1p4b

    cases = {"adafactor_dropout": (dalle_1p4b(depth=2, attn_dropout=0.1, ff_dropout=0.1),
                                   OptimConfig(optimizer="adafactor", grad_clip_norm=0.5)),
             "accumulate_plateau": (dalle_1p4b(depth=2),
                                    OptimConfig(optimizer="adafactor", grad_clip_norm=0.5,
                                                grad_accum_steps=2, lr_scheduler="plateau",
                                                plateau_patience=0))}
    k, b = 3, 8
    out = {}
    for name, (cfg, optim) in cases.items():
        tc = TrainConfig(batch_size=b, seed=SMOKE_SEED + 5, optim=optim, scan_steps=k,
                         metrics_every=k, device_prefetch=2, nan_rollback=False)
        host = [_train_batch(cfg, b, SMOKE_SEED + 10 + i) for i in range(k)]
        texts = torch.from_numpy(np.stack([t for t, _ in host])).cuda()
        imgs = torch.from_numpy(np.stack([i for _, i in host])).cuda()
        scanned = DalleTrainer(cfg, tc, null_cond_prob=0.2)
        m_scan = scanned.train_steps(texts, imgs)
        single = DalleTrainer(cfg, tc, null_cond_prob=0.2)
        start = {n: p.detach().clone() for n, p in single.model.named_parameters()}
        singles = []
        for i in range(k):
            singles.append(single.train_step(texts[i], imgs[i]))
            if i == 0 and optim.grad_accum_steps > 1:
                for n, p in single.model.named_parameters():
                    check(torch.equal(p, start[n]),
                          f"{name}: the first mini-step moved {n}")
        del start
        _same_train_state(torch, single, scanned.state_dict(), f"{name}: train_step × {k}")
        check(m_scan["loss"] == singles[-1]["loss"] and math.isfinite(m_scan["loss"]),
              f"{name}: loss {m_scan['loss']} != {singles[-1]['loss']}")
        del single
        looped = DalleTrainer(cfg, tc, null_cond_prob=0.2)
        looped.fit(iter(host), log=lambda *a: None)
        _same_train_state(torch, looped, scanned.state_dict(), f"{name}: fit")
        del looped
        # the optimizer alone reads nothing back to the host
        opt = scanned.optimizer
        scanned.loss_and_backward(texts[0], imgs[0])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(optim.grad_accum_steps):
                opt.step(torch.ones((), device="cuda"))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        out[name] = {"loss_last": singles[-1]["loss"],
                     "loss_mean": m_scan["loss_mean"], "count": opt.count,
                     "plateau_scale": (None if opt.plateau is None
                                       else float(opt.plateau.scale))}
        del scanned, opt
        torch.cuda.empty_cache()
    emit("recipe_parity", depth=2, k=k, batch=b, cases=out, bit_for_bit=True,
         sync_free_optimizer=sorted(cases), card=card)


def _cli_recipe(torch, card):
    """``train_dalle`` at phase cli's shapes with the loop's flags, then
    ``--resume`` for one more group."""
    import os
    import shutil

    from dalle_tpu_torch.cli import train_dalle
    from dalle_tpu_torch.ops import fused_attention as fa
    from dalle_tpu_torch.train.checkpoints import CheckpointManager

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "recipe_cli")
    shutil.rmtree(work, ignore_errors=True)
    argv = ["--synthetic", "--image_size", "128", "--untrained_vae",
            "--untrained_vae_tokens", "8192", "--untrained_vae_layers", "3",
            "--dim", "1792", "--depth", str(CLI_DEPTH), "--heads", "14",
            "--dim_head", "128", "--text_seq_len", "256", "--batch_size", "8",
            "--keep_n_checkpoints", "1", "--output_dir", work, "--seed", str(SMOKE_SEED),
            "--no_preflight", "--scan_steps", "2", "--ga_steps", "2",
            "--lr_scheduler", "plateau", "--device_prefetch", "2", "--defer_metrics",
            "--attn_dropout", "0.1"]
    try:
        walls, launches = [], []
        for extra in (["--steps", "4"], ["--steps", "6", "--resume"]):
            fa.fwd_launches = fa.bwd_launches = 0
            t0 = time.perf_counter()
            rc = train_dalle.main(argv + extra)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append((fa.fwd_launches, fa.bwd_launches))
            check(rc == 0, f"train_dalle {' '.join(extra)} returned {rc}")
        state, meta = CheckpointManager(work).restore(map_location="cuda")
        opt = state["optimizer"]
        check(state["step"] == 6 and opt["count"] == 3 and opt["mini_step"] == 0
              and opt["plateau"] is not None and opt["acc"] is not None,
              f"after --resume: step {state['step']}, count {opt['count']}")
        check(meta["train"]["scan_steps"] == 2 and meta["train"]["defer_metrics"]
              and meta["hparams"]["attn_dropout"] == 0.1, "the flags reached the config")
        check(min(launches[0]) >= 4 * CLI_DEPTH and min(launches[1]) >= 2 * CLI_DEPTH,
              f"K1 launches {launches}")
        del state
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("recipe_cli", depth=CLI_DEPTH, wall_s=walls, k1_launches=launches,
         plateau_scale=float(opt["plateau"]["scale"]), card=card)


def phase_recipe(torch, card, adam_row):
    """bench.py's recipe on DALL·E-1.4B: Adafactor with clipping at 0.5,
    batch 8, k = 5 steps a train_steps call, metrics_every 1000, no
    checkpoints; two warm-up calls and two timed ones, each ending in a read
    of one master element (bench.py's sync); then the optimizer alone, a
    profiled call, the synchronising calls, the depth-2 parity and the
    command line."""

    from dalle_tpu_torch import DalleTrainer, OptimConfig, TrainConfig, dalle_1p4b
    from dalle_tpu_torch.ops import fused_attention as fa
    from dalle_tpu_torch.train import train_state as tts

    import os

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = dalle_1p4b()
    b, k = 8, RECIPE_K
    tc = TrainConfig(batch_size=b, seed=SMOKE_SEED, metrics_every=RECIPE_METRICS_EVERY,
                     optim=OptimConfig(optimizer="adafactor", grad_clip_norm=0.5))
    tr = DalleTrainer(cfg, tc)
    texts, imgs = _stacked(torch, cfg, k, b, SMOKE_SEED)
    master = next(tr.model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.fwd_launches = fa.bwd_launches = 0          # the recipe's path starts here
    walls, loss_means = [], []
    for _ in range(4):                             # 2 warm-up calls, 2 timed
        t0 = time.perf_counter()
        tr.train_steps(texts, imgs)
        master.view(-1)[0].item()                   # bench.py's sync: one master element
        walls.append(time.perf_counter() - t0)
        loss_means.append(tr.fetch_metrics()["loss_mean"])
    launches = {"fused_attention_fwd": fa.fwd_launches, "fused_attention_bwd": fa.bwd_launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 4 * k
    check(all(math.isfinite(x) for x in loss_means), f"non-finite loss_mean {loss_means}")
    check(loss_means[3] < loss_means[2],
          f"loss_mean did not fall between the timed calls: {loss_means}")
    for name, n in launches.items():
        check(n == steps * cfg.depth, f"{name} launched {n} times in {steps} steps, "
                                      f"expected {steps * cfg.depth}")
    ms = statistics.median(walls[2:]) * 1e3 / k
    n_tok = cfg.total_seq_len
    flops_per_token = (6.0 * tr.num_params + 12.0 * cfg.depth * cfg.heads * cfg.dim_head
                       * n_tok)
    core = tr.optimizer.core
    state_bytes = sum(t.numel() * t.element_size() for k_ in core.STATE
                      for t in getattr(core, k_) if t is not None)
    adam_bytes = 2 * 4 * tr.num_params
    row = dict(batch=b, k=k, metrics_every=RECIPE_METRICS_EVERY, optimizer="adafactor",
               calls_ms=[w * 1e3 for w in walls], ms_per_step=ms,
               tokens_per_s=b * n_tok / ms * 1e3,
               model_tflops_per_s_bench=flops_per_token * b * n_tok / ms / 1e9,
               peak_gib=peak, peak_gib_adam_phase_train=adam_row["peak_gib"],
               ms_per_step_adam_phase_train=adam_row["ms_per_step"],
               loss_mean=loss_means, launches=launches,
               adafactor_state_bytes=state_bytes, adam_moment_bytes=adam_bytes, card=card)
    emit("recipe", **row)

    # -- the optimizer alone, on one step's gradients (CUDA events; each
    # call clips the same .grad again, which changes no cost) ---------------
    loss, _ = tr.loss_and_backward(texts[0], imgs[0])

    ada_ms = median_ms(lambda: tr.optimizer.step(loss), 5)
    adam = tts.Optimizer(OptimConfig(optimizer="adam", learning_rate=3e-4, grad_clip_norm=0.5),
                         tr.optimizer.params)
    adam_ms = median_ms(lambda: adam.step(loss), 5)
    del adam
    torch.cuda.empty_cache()

    # -- one profiled call, and the synchronising calls of one call ----------
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.train_steps(texts, imgs)
        master.view(-1)[0].item()
        wall = time.perf_counter() - t0
    dev_us, by_kernel = device_time(torch, prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    syncs, outside = _sync_calls(torch, lambda: tr.train_steps(texts, imgs))
    torch.cuda.synchronize()
    own = [s for s in syncs if os.path.basename(s[0].split(":")[0]) in RECIPE_OWN]
    check(not own, f"synchronising calls in the training loop's own code: {own}")
    emit("recipe_profile", optimizer_ms_adafactor=ada_ms, optimizer_ms_adam=adam_ms,
         optimizer_ms_adam_phase_train_pr8=43.5, wall_ms_profiled=wall * 1e3,
         device_ms=dev_us / 1e3 if dev_us else "not measured",
         device_ms_per_step=dev_us / 1e3 / k if dev_us else "not measured",
         # against an unprofiled call's wall: the profiler slows the host
         device_busy_share=(dev_us / 1e3) / (ms * k) if dev_us else "not measured",
         top_device_ms={kk: v / 1e3 for kk, v in top},
         sync_calls_in_a_call=len(syncs), sync_places=sorted(set(syncs)),
         sync_places_outside_the_port=sorted(set(outside)), card=card)
    del tr, texts, imgs, master, loss
    torch.cuda.empty_cache()

    _recipe_parity(torch, card)
    _cli_recipe(torch, card)
    emit("recipe_done", seconds=time.perf_counter() - t_phase, card=card)
    return launches, row


# ---------------------------------------------------------------------------
# K3 / K5 and the serving engine
# ---------------------------------------------------------------------------

def window_bounds(b, h, w, d, starts, S, itemsize, qsize, scaled):
    """Least card time of K3/K5 for these inputs (row i at ``starts[i]``):
    (bound ms, "bytes" or "operations", flops, bytes). Bytes: q in and out
    once, and the cache rows (K and V, and their f32 scales for int8) that
    the window can see, once. Operations: 4·d flops per visible (query,
    position) pair (the q·k and p·v products), at the f32 rate for an f32
    cache and the bf16 tensor rate otherwise (the products' operands are
    bf16 there)."""
    seen = sum(min(S, st + w) for st in starts)
    pairs = h * sum(min(S, st + j + 1) for st in starts for j in range(w))
    nbytes = (2 * b * h * w * d * qsize + seen * 2 * h * d * itemsize
              + (seen * 2 * h * 4 if scaled else 0) + b * 4)
    ops = 4 * d * pairs
    rate = F32_FLOPS if itemsize == 4 else BF16_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", ops, nbytes


def _paged_copy(torch, cache, bt, gen):
    """The dense cache's content in a block pool behind a shuffled page
    table, with one page per row left unmapped and a few spare blocks."""
    import numpy as np
    from dalle_tpu_torch.ops.paged_kv import PagedKVCache
    b, S, _ = cache.kv.shape
    h = cache.heads
    d = cache.kv.shape[2] // (2 * h)
    mb = -(-S // bt)
    nb = b * mb + 7
    perm = torch.randperm(nb, generator=gen)[:b * mb].view(b, mb).int().numpy().copy()
    perm[np.arange(b), np.arange(b) % mb] = -1
    pc = PagedKVCache.init(nb, bt, h, S, d, cache.kv.dtype, device="cuda").bind(perm)
    k, v = (t.float().contiguous() for t in cache.read_kv(dtype=torch.float32))
    pc.append_rows(k, v, np.zeros(b, np.int64))
    return pc


WINDOW_COUNTERS = ("window_launches", "paged_launches", "window_tc_launches",
                   "window_split_launches", "window_fma_launches")
# the widths phase serve_kernel holds: a decode step, the tile edges of the
# tensor-core route (16, 64 rows) and a refill window
WINDOW_WIDTHS = (1, 2, 15, 16, 17, 63, 64, 65, 257)


def window_counts(dec):
    return {c: getattr(dec, c) for c in WINDOW_COUNTERS}


def window_set_counts(dec, counts):
    for c, x in counts.items():
        setattr(dec, c, x)


def phase_serve_kernel(torch, card):
    import torch.nn.functional as F
    from dalle_tpu_torch.ops import decode_attention as dec
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED + 4)
    hgen = torch.Generator().manual_seed(SMOKE_SEED + 4)
    sms = dec._sm_count(torch.device("cuda"))
    shares, errs, plans, cases = {}, {}, {}, 0
    saved = window_counts(dec)
    window_set_counts(dec, dict.fromkeys(WINDOW_COUNTERS, 0))
    shapes = (("main", 8, 14, 128, 512), ("b1", 1, 14, 128, 512), ("ragged", 3, 6, 64, 300))
    for name, b, h, d, S in shapes:
        for dt in ("float32", "bfloat16", "int8"):
            dtype = getattr(torch, dt)
            qdt = torch.float32 if dt == "float32" else torch.bfloat16
            cache = _cache(torch, b, h, d, S, dtype, gen)
            pc = _paged_copy(torch, cache, 16, hgen)
            dense = pc.gather_dense()
            runs = [(w, False) for w in WINDOW_WIDTHS]
            if name != "ragged":                  # a peaked softmax (q × 8) on both routes
                runs += [(1, True), (257, True)]
            for w, peaked in runs:
                q = torch.randn(b, h, w, d, device="cuda", generator=gen)
                q = (q * (8.0 if peaked else 1.0)).to(qdt)
                st = [S - w, 0, S] + torch.randint(0, S - w + 1, (b,), generator=hgen).tolist()
                starts = torch.tensor(st[:b], dtype=torch.int32, device="cuda")
                tag = f"{name}/{dt}/w{w}" + ("/peaked" if peaked else "")
                plans[tag] = dec.window_plan(b, h, w, S, dtype, sms)
                outs = {"K3": dec.decode_attend_window(q, cache, starts),
                        "K5": dec.decode_attend_window_paged(q, pc, starts)}
                for kname, slab in (("K3", cache), ("K5", dense)):
                    got = outs[kname]
                    want = dec.decode_attend_window_plain(q, slab.kv, slab.scale, starts)
                    torch.cuda.synchronize()
                    diff = (got.float() - want.float()).abs()
                    share = dec.window_share(got, want, dtype)
                    key = f"{kname}/{tag}"
                    errs[key], shares[key] = diff.max().item(), share
                    cases += 1
                    check(math.isfinite(share) and share <= 1.0,
                          f"{key}: an element is {share} of its bound "
                          f"(max abs err {diff.max().item()})")
                again = dec.decode_attend_window(q, cache, starts)
                slab = dec.decode_attend_window(q, dense, starts)
                torch.cuda.synchronize()
                check(torch.equal(again, outs["K3"]), f"K3 is not repeatable: {tag}")
                live = starts < S
                check(torch.equal(outs["K5"][live], slab[live]),
                      f"K5 != K3 on the gathered slab: {tag}")
    routes = {c: getattr(dec, c) for c in WINDOW_COUNTERS[2:]}
    window_set_counts(dec, saved)
    check(all(routes.values()), f"serve_kernel: a route never ran ({routes})")
    by = {f"{k}/{dt}": max(v for key, v in errs.items()
                           if key.startswith(k + "/") and f"/{dt}/" in key)
          for k in ("K3", "K5") for dt in ("float32", "bfloat16", "int8")}
    worst = {f"{k}/{dt}": max(v for key, v in shares.items()
                              if key.startswith(k + "/") and f"/{dt}/" in key)
             for k in ("K3", "K5") for dt in ("float32", "bfloat16", "int8")}
    peaked = {k: v for k, v in shares.items() if "/peaked" in k}
    build = {k: ptxas_report("decode_window_attention", k)
             or "no build log in this process"
             for k in ("tc_window_kernel", "split_window_kernel", "fma_window_kernel")}
    emit("serve_kernel", kernels=["decode_attend_window", "decode_attend_window_paged"],
         cases=cases, widths=list(WINDOW_WIDTHS), sm_count=sms,
         tolerance="decode_attention.window_tolerance, per element",
         max_abs_err=by, worst_share_of_bound=worst, peaked_shares=peaked,
         plans=plans, route_launches=routes, k5_equals_k3_on_slab=True,
         repeatable=True, build=build)

    # times at the serving shape: a decode step (w=1, every position
    # visible) and a refill window (w=257 from position 0) at b=8, the b=1
    # refill of DecodeEngine._refill_row, and the paged engine's prefill
    # chunks (w = block_tokens = 16 at position 128): at b=8 with the other
    # rows parked at S, as serve_refill_window launches them, and at b=1
    h, d, S = 14, 128, 512
    cases = {"w1": (8, 1, [S - 1] * 8), "w257": (8, 257, [0] * 8),
             "w257/b1": (1, 257, [0]), "w16": (8, 16, [128] + [S] * 7),
             "w16/b1": (1, 16, [128])}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    timing, sweep = {}, {}
    saved = window_counts(dec)
    for dt in ("float32", "bfloat16", "int8"):
        dtype = getattr(torch, dt)
        qdt = torch.float32 if dt == "float32" else torch.bfloat16
        for case, (b, w, sts) in cases.items():
            cache = _cache(torch, b, h, d, S, dtype, gen)
            pc = _paged_copy(torch, cache, 16, hgen)
            pc.bind(torch.arange(b * (S // 16), dtype=torch.int32).view(b, -1).numpy())
            kd, vd = (t.contiguous() for t in cache.read_kv(dtype=qdt))
            q = torch.randn(b, h, w, d, device="cuda", generator=gen).to(qdt)
            starts = torch.tensor(sts, dtype=torch.int32, device="cuda")
            pos = torch.arange(S, device="cuda")
            qpos = starts[:, None].long() + torch.arange(w, device="cuda")[None, :]
            mask = pos[None, :] <= qpos[0][:, None]                     # (w, S)
            if len(set(sts)) > 1:                                       # (b, 1, w, S)
                mask = (pos[None, None, :] <= qpos[:, :, None])[:, None]
            k3 = median_ms(lambda: dec.decode_attend_window(q, cache, starts), 50, flush)
            k5 = median_ms(lambda: dec.decode_attend_window_paged(q, pc, starts), 50, flush)
            plain = median_ms(lambda: dec.decode_attend_window_plain(
                q, cache.kv, cache.scale, starts), 10, flush)
            plain5 = median_ms(lambda: dec.decode_attend_window_paged_plain(q, pc, starts),
                               10, flush)
            lib = median_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask),
                            50, flush)
            bound, by_what, ops, nbytes = window_bounds(
                b, h, w, d, sts, S, cache.kv.element_size(), q.element_size(),
                cache.scale is not None)
            key = f"{dt}/{case}"
            timing[key] = {
                "plan": dec.window_plan(b, h, w, S, dtype, sms),
                "K3_ms": k3, "K5_ms": k5, "plain_ms": plain, "K5_plain_ms": plain5,
                "library_ms": lib, "bound_ms": bound, "bound_by": by_what, "flops": ops,
                "bytes": nbytes, "K3_roofline_share": bound / k3,
                "K5_roofline_share": bound / k5}
            # a decode step on every split, for the record (the plan's
            # choice beside the others)
            if w == 1:
                sweep[key] = {f"split/1/{n}": median_ms(lambda: dec._launch_window(
                    q, cache.kv, cache.scale, None, starts, S, 0, 0, None, ("split", 1, n)),
                    50, flush) for n in (2, 4, 8)}
    window_set_counts(dec, saved)
    emit("serve_kernel_timing", shape=dict(h=h, d=d, S=S),
         cases={"w1": "b=8, starts = S-1 (a decode step over the full cache)",
                "w257": "b=8, starts = 0 (a refill window)",
                "w257/b1": "b=1, starts = 0 (DecodeEngine._refill_row)",
                "w16": "b=8, starts = [128, S x 7] (a paged prefill chunk, "
                       "the other rows parked)",
                "w16/b1": "b=1, starts = 128 (a paged prefill chunk)"},
         library="torch.nn.functional.scaled_dot_product_attention with a boolean "
                 "(w, S) mask on the dequantized (b,h,S,d) cache",
         card=card, by_case=timing, k3_ms_by_plan=sweep)
    return errs, timing


def _serve_text(cfg, n, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    text = rng.randint(1, cfg.num_text_tokens, (n, cfg.text_seq_len)).astype(np.int32)
    text[:, 200:] = 0                                   # padded tail
    return text


def phase_serve_parity(torch):
    from dalle_tpu_torch import DalleWithVae, dalle_1p4b, init_dalle
    from dalle_tpu_torch.ops import decode_attention as dec
    from dalle_tpu_torch.serve import RequestQueue
    cfg = dalle_1p4b(depth=2)
    model = init_dalle(cfg, seed=SMOKE_SEED + 5)
    wrapper = DalleWithVae(model, None)
    texts = _serve_text(cfg, 4, SMOKE_SEED + 5)
    subs = [dict(text=texts[i], seed=100 + i, request_id=i,
                 max_tokens=40 if i == 2 else None) for i in range(4)]
    refs = {}
    for s in subs:
        toks = model.generate_images_tokens(
            torch.from_numpy(s["text"][None]).cuda(),
            generator=torch.Generator("cuda").manual_seed(s["seed"]))[0].cpu().numpy()
        refs[s["request_id"]] = toks[:s["max_tokens"] or cfg.image_seq_len]

    def serve(eng, items):
        q = RequestQueue()
        for it in items:
            q.submit(**it)
        q.close()
        return {c.request_id: c.tokens for c in eng.run(q)}

    before = dec.window_launches, dec.paged_launches
    dense_eng = wrapper.serve_engine(slots=2, precision="float32")
    dense = serve(dense_eng, subs)
    for rid, want in refs.items():
        check(dense[rid].shape == want.shape and (dense[rid] == want).all(),
              f"serve_parity: dense engine request {rid} differs from generate_images_tokens")
    # repeats of 0 and 1 (full radix hits), a pool of 72 blocks of 16 (two
    # full rows and 8 more), so residents are evicted
    order = [subs[0], dict(subs[0], seed=200), subs[1], subs[2], dict(subs[1], seed=201),
             subs[3]]
    paged_subs = [dict(s, request_id=i) for i, s in enumerate(order)]
    dense_all = serve(wrapper.serve_engine(slots=2, precision="float32"), paged_subs)
    peng = wrapper.serve_engine(slots=2, precision="float32", kv_block_tokens=16,
                                kv_pool_blocks=72)
    paged = serve(peng, paged_subs)
    check(sorted(paged) == sorted(dense_all) == list(range(6)), "serve_parity: lost requests")
    for rid in dense_all:
        check((paged[rid] == dense_all[rid]).all(),
              f"serve_parity: paged request {rid} differs from dense")
    st = peng.stats
    check(st.radix_full_hits >= 1 and st.pages_evicted > 0 and st.cow_forks >= 1,
          f"serve_parity: the paged run missed radix hits or eviction ({st})")
    emit("serve_parity", depth=cfg.depth, dim=cfg.dim, precision="float32",
         requests=len(subs), dense_equals_sequential=True, paged_equals_dense=True,
         paged_requests=len(paged_subs), radix_full_hits=st.radix_full_hits,
         radix_partial_hits=st.radix_partial_hits, cow_forks=st.cow_forks,
         pages_evicted=st.pages_evicted,
         launches=dict(K3=dec.window_launches - before[0], K5=dec.paged_launches - before[1]))
    del model, wrapper, dense_eng, peng
    torch.cuda.empty_cache()


def _serve_traffic(cfg, paged: bool):
    """16 requests: a 2-member cohort (one group_id, one prompt), 1 CFG
    (cond_scale 3), 3 ragged (40, 100, 180 tokens), 10 full-length. The
    first eight fill the 8 slots in one admission pass (the cohort shares
    one prefill). The paged run puts 4 repeats of prompts that pass is
    still decoding (full radix hits) and one prompt that shares its first
    128 text tokens with one of them (a partial hit) ahead of the rest."""
    texts = _serve_text(cfg, 16, SMOKE_SEED + 6)
    subs = [dict(text=texts[0], seed=1000 + i, group_id=7) for i in range(2)]
    subs.append(dict(text=texts[1], seed=1002, cond_scale=3.0))
    subs += [dict(text=texts[2 + i], seed=1003 + i, max_tokens=n)
             for i, n in enumerate((40, 100, 180))]
    full = [dict(text=texts[5 + i], seed=1010 + i) for i in range(10)]
    subs += full[:2]
    if paged:
        subs += [dict(text=texts[t], seed=2000 + i) for i, t in enumerate((0, 1, 5, 5))]
        partial = texts[15].copy()
        partial[:128] = texts[5][:128]
        subs.append(dict(text=partial, seed=2015))
    return subs + full[2:]


def _run_served(torch, eng, subs):
    """Half the requests queued at once, the rest from a producer thread
    while the engine runs. Returns (completions, wall seconds)."""
    import threading
    from dalle_tpu_torch.serve import RequestQueue
    q = RequestQueue()
    half = len(subs) // 2
    for i, s in enumerate(subs[:half]):
        q.submit(request_id=i, **s)

    def producer():
        for i, s in enumerate(subs[half:], start=half):
            time.sleep(0.05)
            q.submit(request_id=i, **s)
        q.close()

    t = threading.Thread(target=producer)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.start()
    done = eng.run(q)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t.join()
    return done, wall


def phase_serve(torch, card):
    import numpy as np
    from dalle_tpu_torch import DalleWithVae, dalle_1p4b, init_dalle
    from dalle_tpu_torch.ops import decode_attention as dec
    from dalle_tpu_torch.serve import RequestQueue
    torch.cuda.empty_cache()
    cfg = dalle_1p4b()
    model = init_dalle(cfg, seed=SMOKE_SEED)
    wrapper = DalleWithVae(model, None)
    wrapper._resolve_precision("bf16_int8kv")          # the one-time bf16 cast
    launches, rows = {}, {}
    for mode in ("dense", "paged"):
        kw = dict(kv_block_tokens=16) if mode == "paged" else {}
        eng = wrapper.serve_engine(slots=8, precision="bf16_int8kv", **kw)
        subs = _serve_traffic(cfg, mode == "paged")
        torch.cuda.reset_peak_memory_stats()
        window_set_counts(dec, dict.fromkeys(WINDOW_COUNTERS, 0))   # the main path starts here
        done, wall = _run_served(torch, eng, subs)
        k3, k5 = dec.window_launches, dec.paged_launches
        routes = {c: getattr(dec, c) for c in WINDOW_COUNTERS[2:]}
        st = eng.stats
        check(sorted(c.request_id for c in done) == list(range(len(subs))),
              f"serve {mode}: {len(done)} of {len(subs)} requests completed")
        for c in done:
            n = subs[c.request_id].get("max_tokens") or cfg.image_seq_len
            check(c.tokens.shape == (n,) and c.tokens.min() >= 0
                  and c.tokens.max() < cfg.image_vocab_size,
                  f"serve {mode}: request {c.request_id} tokens {c.tokens.shape}")
        want = cfg.depth * st.window_dispatches
        mine, other = (k3, k5) if mode == "dense" else (k5, k3)
        check(mine == want and other == 0,
              f"serve {mode}: K3 launched {k3}, K5 {k5}, expected {want} for "
              f"{st.window_dispatches} attending dispatches and 0")
        # the int8 cache of bf16_int8kv: refill windows on the tensor cores,
        # decode steps on the cluster split, nothing on the f32 route
        check(routes["window_tc_launches"] > 0 and routes["window_split_launches"] > 0
              and routes["window_fma_launches"] == 0
              and sum(routes.values()) == k3 + k5,
              f"serve {mode}: route launches {routes} for K3 {k3} + K5 {k5}")
        if mode == "paged":
            check(st.radix_full_hits >= 4 and st.radix_partial_hits >= 1,
                  f"serve paged: radix hits {st.radix_full_hits} full, "
                  f"{st.radix_partial_hits} partial")
        launches[mode] = {"decode_attend_window": k3, "decode_attend_window_paged": k5,
                          **routes}
        ttft = sorted(c.ttft_s for c in done)
        tokens = sum(int(c.tokens.shape[0]) for c in done)
        rows[mode] = dict(
            mode=mode, slots=8, precision="bf16_int8kv", requests=len(done),
            wall_s=wall, requests_per_s=len(done) / wall, image_tokens_per_s=tokens / wall,
            ttft_p50_s=float(np.percentile(ttft, 50)), ttft_p95_s=float(np.percentile(ttft, 95)),
            ms_per_step=st.step_seconds * 1e3 / max(st.steps, 1), steps=st.steps,
            refills=st.refills, prefill_chunks=st.prefill_chunks,
            shared_refills=st.shared_refills, window_dispatches=st.window_dispatches,
            radix_full_hits=st.radix_full_hits, radix_partial_hits=st.radix_partial_hits,
            cow_forks=st.cow_forks, pages_evicted=st.pages_evicted,
            occupancy_while_queued=st.occupancy_while_queued,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches=launches[mode], card=card)
        emit("serve", **rows[mode])

    # device busy share over a window of steady decode steps (8 active rows)
    eng = wrapper.serve_engine(slots=8, precision="bf16_int8kv")
    q = RequestQueue()
    for i, s in enumerate(_serve_traffic(cfg, False)[:8]):
        q.submit(request_id=i, **s)
    q.close()
    eng.run(q, max_steps=8)                 # admitted and warm; rows stay active
    saved = window_counts(dec)
    steps = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng._multi_step()
    bare = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng._multi_step()
        wall = time.perf_counter() - t0
    window_set_counts(dec, saved)
    dev_us, by_kernel = device_time(torch, prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("serve_profile", precision="bf16_int8kv", slots=8, decode_steps=steps,
         wall_ms_per_step_unprofiled=bare * 1e3 / steps,
         wall_ms_per_step_profiled=wall * 1e3 / steps,
         device_ms_per_step=dev_us / 1e3 / steps if dev_us else "not measured",
         device_busy_share=(dev_us / 1e6) / bare if dev_us else "not measured",
         top_device_ms_per_step={k: v / 1e3 / steps for k, v in top}, card=card)
    del model, wrapper, eng
    torch.cuda.empty_cache()
    return launches, rows


# ---------------------------------------------------------------------------
# the decode surface: W8 (int8 weights), speculative decoding, text
# generation and token shift
# ---------------------------------------------------------------------------

W8_COUNTERS = ("launches", "tc_launches", "fma_launches", "matmul_calls")
W8_ROWS = (1, 8, 16, 24, 40, 64)        # 1-4 tiles of 16 rows on the tensor-core route
W8_TIMED = (8, 16, 24, 32, 40, 48, 64)
# the logits of the first decode step of the int8w model against the bf16
# model's on the same inputs: int8 per-channel quantization moves each weight
# by up to half its channel's scale (amax/254), through 24 layers and the
# head; 0.1 of the largest |logit|
INT8W_LOGIT_TOL = 0.1
# a speculative run's first token that differs from gamma=0's: the two
# scores (logits/T + the shared draw) at that step, from a teacher-forced
# f32-cache replay, must lie within 2^-5 of the row's largest |logit| (a few
# bf16 roundings), else the divergence is a fault
SPEC_GAP_TOL = 2.0 ** -5


class _ReadFlush:
    """An L2 flush for ``median_ms`` that reads 512 MiB instead of writing
    them: a written flush leaves L2 full of dirty lines whose write-back
    lands inside the timed launch, which a decode step's weight reads never
    pay for."""

    def __init__(self, torch):
        self.buf = torch.ones(512 * 2 ** 20, dtype=torch.int8, device="cuda")

    def zero_(self):
        self.buf.max()


def w8_counts(w8):
    return {c: getattr(w8, c) for c in W8_COUNTERS}


def w8_set_counts(w8, counts):
    for c, x in counts.items():
        setattr(w8, c, x)


def w8_shapes(cfg):
    """{layer: (N, K, bias)} of every QLinear of the 1.4B model."""
    inner = cfg.heads * cfg.dim_head
    total = cfg.num_text_tokens + cfg.text_seq_len + cfg.image_vocab_size
    return {"to_qkv": (3 * inner, cfg.dim, False), "to_out": (cfg.dim, inner, True),
            "w1": (2 * cfg.ff_mult * cfg.dim, cfg.dim, True),
            "w2": (cfg.dim, cfg.ff_mult * cfg.dim, True), "to_logits": (total, cfg.dim, True)}


def w8_bounds(M, N, K, xsize):
    """Least card time of W8 for x (M, K) of ``xsize`` bytes: x, the int8
    weights, the f32 scales and y once (bytes), or 2·M·N·K operations at the
    bf16 tensor rate (bf16 x) or the f32 rate (f32 x)."""
    nbytes = M * K * xsize + N * K + N * 4 + M * N * xsize
    ops = 2 * M * N * K
    rate = BF16_FLOPS if xsize == 2 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _w8_timing(torch, cfg, rows=W8_TIMED):
    """W8's two routes at every QLinear shape of the 1.4B model and each row
    count of ``rows``, bf16 x: the kernel (``ms``), the route above
    ``MAX_ROWS`` (the weight dequantized, then torch.matmul:
    ``matmul_route_ms``), the plain version, torch.matmul on the bf16 weight
    (``library_ms``) and the bound; then per row count the sums over a
    decode step's QLinears (depth × the four layer shapes, plus to_logits)
    for each route."""
    from dalle_tpu_torch.ops import int8w_linear as w8
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED + 22)
    flush = _ReadFlush(torch)
    timing = {}
    for name, (N, K, bias) in w8_shapes(cfg).items():
        q = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand(N, generator=gen, device="cuda") * 0.02 + 1e-3
        wbf = w8.dequantize(q, s, torch.bfloat16)
        b = (torch.randn(N, generator=gen, device="cuda") * 0.5).bfloat16() if bias else None
        for M in rows:
            x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
            bound, by = w8_bounds(M, N, K, 2)
            row = dict(
                ms=median_ms(lambda: w8.int8w_linear_kernel(x, q, s, b), 30, flush),
                matmul_route_ms=median_ms(lambda: w8.int8w_linear_matmul(x, q, s, b), 30,
                                          flush),
                plain_ms=median_ms(lambda: w8.int8w_linear_plain(x, q, s, b), 10, flush),
                library_ms=median_ms(lambda: torch.matmul(x, wbf.t()), 30, flush),
                bound_ms=bound, bound_by=by)
            row["share_of_bound"] = bound / row["ms"]
            timing[f"{name}/M{M}"] = row
    del flush
    per_step = {name: (1 if name == "to_logits" else cfg.depth) for name in w8_shapes(cfg)}
    step = {}
    for M in rows:
        step[M] = {k: sum(n * timing[f"{name}/M{M}"][k] for name, n in per_step.items())
                   for k in ("ms", "matmul_route_ms", "library_ms", "bound_ms")}
    return timing, step


def _w8_kernel(torch, card, cfg):
    """W8 against its plain version at every QLinear shape of the 1.4B model
    and every row count of W8_ROWS (each tile-row instantiation of the
    tensor-core route), bf16 and f32 x, within int8w_tolerance; rows 0,
    M/2 and M-1 alone equal the same rows inside M; then the times of both
    routes (``_w8_timing``)."""
    from dalle_tpu_torch.ops import int8w_linear as w8
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED + 20)
    shares, invariant, max_abs = {}, {}, 0.0
    for name, (N, K, bias) in w8_shapes(cfg).items():
        q = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand(N, generator=gen, device="cuda") * 0.02 + 1e-3
        for dt in (torch.bfloat16, torch.float32):
            b = (torch.randn(N, generator=gen, device="cuda") * 0.5).to(dt) if bias else None
            for M in W8_ROWS:
                x = torch.randn(M, K, generator=gen, device="cuda").to(dt)
                got = w8.int8w_linear_kernel(x, q, s, b)
                want = w8.int8w_linear_plain(x, q, s, b)
                torch.cuda.synchronize()
                share = ((got.float() - want.float()).abs()
                         / w8.int8w_tolerance(x, q, s, b, want)).max().item()
                key = f"{name}/{str(dt)[6:]}/M{M}"
                shares[key] = share
                max_abs = max(max_abs, (got.float() - want.float()).abs().max().item())
                check(share <= 1.0, f"W8 {key}: {share} of int8w_tolerance")
                if M > 1:
                    picked = sorted({0, M // 2, M - 1})
                    alone = torch.cat([w8.int8w_linear_kernel(x[r:r + 1], q, s, b)
                                       for r in picked])
                    invariant[key] = torch.equal(alone, got[picked])
                    check(invariant[key], f"W8 {key}: a row alone differs from the row in {M}")
    emit("w8_kernel", shapes={k: list(v) for k, v in w8_shapes(cfg).items()},
         rows=list(W8_ROWS), max_abs_err=max_abs, worst_share=max(shares.values()),
         shares=shares,
         row_invariant=invariant, tolerance="int8w_linear.int8w_tolerance, per element",
         ptxas=ptxas_report("int8w_linear", "kernel"), card=card)
    timing, step = _w8_timing(torch, cfg)
    emit("w8_kernel_timing", timing=timing, flush="a 512 MiB read before each launch",
         library="torch.matmul on the dequantized bf16 weight",
         matmul_route="int8w_linear_matmul: dequantize, then torch.matmul", card=card)
    emit("w8_routes", max_rows=w8.MAX_ROWS, per_decode_step=step,
         kernel_faster_at=[M for M in step if step[M]["ms"] <= step[M]["matmul_route_ms"]],
         card=card)
    return max_abs, max(shares.values()), timing


def _first_divergence(torch, model, text, base, out, noise, temperature, filter_thres,
                      cache_dtype=None):
    """The first (row, step) where ``out`` differs from ``base`` and the gap
    between the two tokens' scores there, replayed teacher-forced over a
    cache of ``cache_dtype`` (f32 by default) from ``base``'s prefix; None
    when they are equal."""
    from dalle_tpu_torch.ops.sampling import top_k_filter
    diff = (out != base).nonzero()
    if diff.shape[0] == 0:
        return None
    r, t = (int(v) for v in diff[0])
    with torch.no_grad():
        logits, cache, plen = model._prefill(text[r:r + 1], None, 1,
                                             cache_dtype or torch.float32)
        for i in range(t):
            logits, cache = model._decode_one(base[r:r + 1, i], i, plen + i, cache)
    band = logits[0, model.num_text_tokens:].float()
    score = band / temperature + noise[t, r]
    a, z = int(base[r, t]), int(out[r, t])
    # a near-tie of the two scores, or of either token with the top-k cut
    kth = top_k_filter(band, thres=filter_thres)
    kth = kth[torch.isfinite(kth)].min()
    gap = min(abs(score[a] - score[z]).item(), abs(band[a] - kth).item(),
              abs(band[z] - kth).item())
    scale = band.abs().max().item()
    return dict(row=r, step=t, tokens=[a, z], gap=gap, max_abs_logit=scale,
                gap_share=gap / (SPEC_GAP_TOL * scale))


def _k3_ragged(torch):
    """K3 on the speculative verify's caches: total_seq_len + gamma positions
    (not a multiple of the 64-key tile), w = gamma + 1 queries at distinct
    per-row starts (a finished row idling at its last step, one past the
    end), on the tensor-core route (bf16, int8) and the fma route (f32);
    each within window_tolerance of the plain version."""
    import numpy as np
    from dalle_tpu_torch.ops import decode_attention as dec
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED + 21)
    b, h, d = 8, 14, 128
    shares = {}
    for S, w in ((514, 3), (515, 2), (516, 5), (514, 5)):
        for dt in (torch.int8, torch.bfloat16, torch.float32):
            cache = _cache(torch, b, h, d, S, dt, gen)
            starts = np.array([S - w, S - w - 1, 300, 257, 0, S - 1, S - w - 63, S], np.int64)
            qdt = torch.float32 if dt == torch.float32 else torch.bfloat16
            q = torch.randn(b, h, w, d, device="cuda", generator=gen).to(qdt)
            got = dec.decode_attend_window(q, cache, starts)
            want = dec.decode_attend_window_plain(q, cache.kv, cache.scale,
                                                  torch.from_numpy(starts).cuda())
            torch.cuda.synchronize()
            key = f"S{S}/w{w}/{str(dt)[6:]}"
            # the parked row (start S) sees the whole cache, as the plain version
            shares[key] = dec.window_share(got, want, dt)
            check(shares[key] <= 1.0, f"K3 ragged {key}: {shares[key]} of window_tolerance")
    return shares


def phase_decode_surface(torch, card, gen_rows):
    """The JAX package's decode surface on the card (see the module
    docstring, phase 24). ``gen_rows``: phase generate's rows, whose
    bf16_int8kv run (the same model, text and draws) stands beside int8w."""
    from dalle_tpu_torch import (DalleTrainer, DalleWithVae, DiscreteVAEAdapter, DVAEConfig,
                                 OptimConfig, TrainConfig, dalle_1p4b, init_dalle, init_dvae)
    from dalle_tpu_torch.ops import decode_attention as dec
    from dalle_tpu_torch.ops import fused_attention as fa
    from dalle_tpu_torch.ops import int8w_linear as w8
    from dalle_tpu_torch.ops.sampling import gumbel_noise
    from dalle_tpu_torch.serve import RequestQueue
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = dalle_1p4b()
    w8_err, w8_share, w8_timing = _w8_kernel(torch, card, cfg)
    k3_shares = _k3_ragged(torch)
    emit("k3_ragged", shares=k3_shares, worst_share=max(k3_shares.values()),
         tolerance="decode_attention.window_tolerance, per element")

    model = init_dalle(cfg, seed=SMOKE_SEED)
    vae = DiscreteVAEAdapter(init_dvae(DVAEConfig(), seed=SMOKE_SEED))
    wrapper = DalleWithVae(model, vae)
    m8, _ = wrapper._resolve_precision("int8w")        # the one-time derivations
    mb, _ = wrapper._resolve_precision("bf16_int8kv")
    cfg2 = dalle_1p4b(depth=2)                          # full width, depth cut to 2
    wrapper2 = DalleWithVae(init_dalle(cfg2, seed=SMOKE_SEED), vae)
    b = 8
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED)
    text = torch.randint(1, cfg.num_text_tokens, (b, cfg.text_seq_len), device="cuda",
                         generator=gen)
    text[:, 200:] = 0
    per_pass = cfg.depth * (cfg.image_seq_len - 1)
    launches = {"decode_attend": 0, "w8": dict.fromkeys(W8_COUNTERS, 0)}

    # int8w generation: at full depth beside phase generate's bf16_int8kv
    # run, and with CFG at depth 2
    rows = [dict(r, phase="generate") for r in gen_rows if r["precision"] == "bf16_int8kv"]
    for wr, c, cond_scale in ((wrapper, cfg, 1.0), (wrapper2, cfg2, 3.0)):
        torch.cuda.reset_peak_memory_stats()
        dec.launches = 0
        w8_set_counts(w8, dict.fromkeys(W8_COUNTERS, 0))     # this path starts here
        t0 = time.perf_counter()
        images = wr.generate_images(
            text, generator=torch.Generator("cuda").manual_seed(SMOKE_SEED),
            precision="int8w", cond_scale=cond_scale)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        caches = 2 if cond_scale != 1.0 else 1
        got = w8_counts(w8)
        check(tuple(images.shape) == (b, 128, 128, 3) and bool(torch.isfinite(images).all()),
              f"int8w depth {c.depth}: images {tuple(images.shape)} not finite or of the "
              "wrong shape")
        want_k2 = c.depth * (c.image_seq_len - 1) * caches
        check(dec.launches == want_k2, f"int8w depth {c.depth} cfg={cond_scale}: K2 "
                                       f"launched {dec.launches}, expected {want_k2}")
        # a prefill's projections take the matmul route (b·257 rows) but its
        # head the kernel (the last position's b rows); every decode step
        # runs every QLinear through the kernel
        linears = 4 * c.depth + 1                   # QLinears a forward runs
        want = {"launches": (1 + (c.image_seq_len - 1) * linears) * caches,
                "matmul_calls": (linears - 1) * caches}
        check(got["launches"] == want["launches"] == got["tc_launches"]
              and got["matmul_calls"] == want["matmul_calls"] and got["fma_launches"] == 0,
              f"int8w depth {c.depth} cfg={cond_scale}: W8 counts {got}, expected {want}")
        launches["w8"] = {k: launches["w8"][k] + got[k] for k in W8_COUNTERS}
        launches["decode_attend"] += dec.launches
        row = dict(precision="int8w", depth=c.depth, cond_scale=cond_scale, batch=b,
                   wall_s=wall, ms_per_token=wall * 1e3 / c.image_seq_len,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   k2_launches=dec.launches, w8_launches=got, card=card)
        rows.append(row)
        emit("int8w_generate", **row)
    emit("int8w_beside_bf16_int8kv", rows=rows)
    with torch.no_grad():
        tok = torch.randint(0, cfg.image_vocab_size, (b,), device="cuda", generator=gen)
        first = []
        for m in (m8, mb):
            _, cache, plen = m._prefill(text, None, b, torch.int8)
            first.append(m._decode_one(tok, 0, plen, cache)[0][:, m.num_text_tokens:].float())
    scale = first[1].abs().max().item()
    logit_err = (first[0] - first[1]).abs().max().item()
    check(logit_err <= INT8W_LOGIT_TOL * scale,
          f"int8w first-step logits {logit_err} from bf16's (largest {scale})")
    emit("int8w_logits", max_abs_err=logit_err, max_abs_logit=scale,
         tolerance=f"{INT8W_LOGIT_TOL} of the largest |logit|")

    # speculative: gamma > 0 against gamma = 0 on one draw table; the sweep
    # at depth 2 (full width), one gamma > 0 at full depth
    spec = {}
    for wr, c, precision, gammas in ((wrapper2, cfg2, "bfloat16", (0, 1, 2, 4)),
                                     (wrapper2, cfg2, "float32", (0, 2)),
                                     (wrapper, cfg, "bfloat16", (0, 2))):
        mp, cdt = wr._resolve_precision(precision)
        noise = gumbel_noise((c.image_seq_len, b, c.image_vocab_size),
                             generator=torch.Generator("cuda").manual_seed(SMOKE_SEED + 2),
                             device="cuda")
        base = None
        for gamma in gammas:
            window_set_counts(dec, dict.fromkeys(WINDOW_COUNTERS, 0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, rounds, committed = mp.generate_images_tokens_speculative(
                text, gamma=gamma, noise=noise, cache_dtype=cdt, return_stats=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            routes = window_counts(dec)
            what = f"speculative depth {c.depth} {precision} gamma={gamma}"
            check(committed == b * c.image_seq_len and routes["window_launches"]
                  == c.depth * rounds, f"{what}: {committed} committed, K3 {routes}, "
                                       f"{rounds} rounds")
            route = "split" if gamma == 0 else ("fma" if cdt == torch.float32 else "tc")
            check(routes[f"window_{route}_launches"] == routes["window_launches"],
                  f"{what}: routes {routes}")
            if base is None:
                base, verdict = out, "equal"
            else:
                div = _first_divergence(torch, mp, text, base, out, noise, 1.0, 0.5)
                verdict = "equal" if div is None else div
                check(div is None or div["gap_share"] <= 1.0, f"{what}: divergence {div}")
            key = f"d{c.depth}/{precision}/g{gamma}"
            spec[key] = dict(
                depth=c.depth, rounds=rounds, committed=committed, wall_s=wall,
                ms_per_image=wall * 1e3 / b, against_gamma0=verdict,
                k3_launches=routes["window_launches"], route=route)
            emit("speculative", precision=precision, gamma=gamma, draft="row",
                 **spec[key], card=card)
        del mp
    # text generation from a 4-token prefix
    prefix = text[:, :4]
    dec.launches = 0
    t0 = time.perf_counter()
    texts = wrapper.generate_texts(prefix, generator=torch.Generator("cuda").manual_seed(3))
    torch.cuda.synchronize()
    text_wall = time.perf_counter() - t0
    n_new = cfg.text_seq_len - 4
    check(tuple(texts.shape) == (b, cfg.text_seq_len) and torch.equal(texts[:, :4], prefix)
          and int(texts.max()) < model.num_text_tokens and int(texts.min()) >= 0,
          f"generate_texts: {tuple(texts.shape)}, ids {int(texts.min())}..{int(texts.max())}")
    check(dec.launches == cfg.depth * (n_new - 1),
          f"generate_texts launched K2 {dec.launches}, expected {cfg.depth * (n_new - 1)}")
    launches["decode_attend"] += dec.launches
    emit("generate_texts", batch=b, prefix=4, new_tokens=n_new, wall_s=text_wall,
         ms_per_token=text_wall * 1e3 / n_new, k2_launches=dec.launches, card=card)

    # the int8w engine at its new default, dense and paged
    engine_rows, eng_launches = {}, {}
    subs = _serve_traffic(cfg, False)[:8]
    for mode in ("dense", "paged"):
        kw = dict(kv_block_tokens=16) if mode == "paged" else {}
        eng = wrapper.serve_engine(slots=8, **kw)
        check(eng.model is m8 and eng.cache_dtype == torch.int8, "serve_engine's default")
        q = RequestQueue()
        for i, s in enumerate(subs):
            q.submit(request_id=i, **s)
        q.close()
        window_set_counts(dec, dict.fromkeys(WINDOW_COUNTERS, 0))
        w8_set_counts(w8, dict.fromkeys(W8_COUNTERS, 0))     # this path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run(q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats
        k3, k5, got = dec.window_launches, dec.paged_launches, w8_counts(w8)
        mine, other = (k3, k5) if mode == "dense" else (k5, k3)
        check(len(done) == len(subs) and mine == cfg.depth * st.window_dispatches
              and other == 0, f"int8w engine {mode}: {len(done)} done, K3 {k3}, K5 {k5}")
        check(got["tc_launches"] > 0 and got["fma_launches"] == 0
              and got["launches"] == got["tc_launches"],
              f"int8w engine {mode}: W8 {got}")
        eng_launches[mode] = {"decode_attend_window": k3, "decode_attend_window_paged": k5,
                              "w8": got}
        launches["w8"] = {k: launches["w8"][k] + got[k] for k in W8_COUNTERS}
        engine_rows[mode] = dict(
            mode=mode, slots=8, precision="int8w", requests=len(done), wall_s=wall,
            requests_per_s=len(done) / wall,
            ms_per_step=st.step_seconds * 1e3 / max(st.steps, 1), steps=st.steps,
            launches=eng_launches[mode], card=card)
        emit("int8w_serve", **engine_rows[mode])
        if mode == "dense":
            served = {c.request_id: c.tokens for c in done}
    # engine against sequential int8w generation: reported, not assumed (not
    # bit for bit in the bf16 modes: an open fault, ROADMAP.md Queue 3). The
    # request's draws are its generator's, one (1, V) row a step as the
    # engine and the sequential sampler take them; the first divergence is
    # replayed over the int8 cache for its score gap
    s = subs[6]
    g6 = torch.Generator("cuda").manual_seed(s["seed"])
    noise6 = torch.stack([gumbel_noise((1, cfg.image_vocab_size), generator=g6, device="cuda")
                          for _ in range(cfg.image_seq_len)])
    text6 = torch.from_numpy(s["text"][None]).cuda()
    seq = m8.generate_images_tokens(text6, noise=noise6, cache_dtype=torch.int8)
    eng6 = torch.as_tensor(served[6], device="cuda")[None]
    agree = float((seq == eng6).float().mean())
    div = _first_divergence(torch, m8, text6, seq, eng6, noise6, 1.0, 0.5, torch.int8)
    emit("int8w_engine_vs_sequential", request=6, tokens=int(seq.shape[1]), agreement=agree,
         first_divergence=div, card=card)
    del model, vae, wrapper, wrapper2, m8, mb, eng
    torch.cuda.empty_cache()

    # an overfit model accepts drafts: depth 2, full width, a constant image
    m2 = init_dalle(cfg2, seed=SMOKE_SEED + 7).train()
    opt = torch.optim.Adam(m2.parameters(), lr=1e-3)
    t2 = text[:2, :].clone()
    t2[1] = t2[0]
    img = torch.full((2, cfg2.image_seq_len), 5, device="cuda")
    fit_steps, loss_img = 0, float("inf")
    while loss_img > 0.05 and fit_steps < 300:
        opt.zero_grad()
        loss, parts = m2(t2, img, return_loss=True)
        loss.backward()
        opt.step()
        loss_img = parts["loss_img"].item()
        fit_steps += 1
    m2.eval()
    noise2 = gumbel_noise((cfg2.image_seq_len, 2, cfg2.image_vocab_size),
                          generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    seq2 = m2.generate_images_tokens_speculative(t2, gamma=0, draft="repeat", noise=noise2,
                                                 temperature=0.2)
    out2, rounds2, _ = m2.generate_images_tokens_speculative(
        t2, gamma=3, draft="repeat", noise=noise2, temperature=0.2, return_stats=True)
    fives = float((out2 == 5).float().mean())
    check(torch.equal(out2, seq2), "overfit gamma=3 'repeat' differs from gamma=0")
    check(fives > 0.9 and rounds2 <= cfg2.image_seq_len // 2,
          f"overfit model: {fives} of its tokens are the image's, {rounds2} rounds")
    emit("speculative_overfit", depth=2, fit_steps=fit_steps, loss_img=loss_img, gamma=3,
         draft="repeat", temperature=0.2, rounds=rounds2, tokens=cfg2.image_seq_len,
         share_of_image_token=fives, equal_to_gamma0=True)
    del m2, opt

    # token shift: cached decode ≡ forward (depth 2, f32), a training step
    # through K1, and full-depth bf16 generation
    cfg_s = dalle_1p4b(depth=2, shift_tokens=True, use_pallas="off")
    ms_ = init_dalle(cfg_s, seed=SMOKE_SEED + 8)
    img_s = torch.randint(0, cfg_s.image_vocab_size, (2, cfg_s.image_seq_len), device="cuda",
                          generator=gen)
    with torch.no_grad():
        full = ms_(text[:2], img_s)[:, cfg_s.text_seq_len:]
        logits, cache, plen = ms_._prefill(text[:2], None, 2)
        steps = [logits]
        for i in range(cfg_s.image_seq_len - 1):
            logits, cache = ms_._decode_one(img_s[:, i], i, plen + i, cache)
            steps.append(logits)
        shift_err = (torch.stack(steps, 1) - full).abs().max().item()
    check(shift_err <= 1e-3, f"shifted cached decode vs forward: {shift_err}")
    del ms_, cache
    tr = DalleTrainer(dalle_1p4b(depth=2, shift_tokens=True),
                      TrainConfig(batch_size=8, seed=SMOKE_SEED,
                                  optim=OptimConfig(learning_rate=3e-4, grad_clip_norm=0.5)))
    tt, ti = _train_batch(tr.model.cfg, 8, SMOKE_SEED)
    fa.fwd_launches = fa.bwd_launches = 0                    # this path starts here
    m = tr.train_step(torch.from_numpy(tt).cuda(), torch.from_numpy(ti).cuda())
    k1 = {"fused_attention_fwd": fa.fwd_launches, "fused_attention_bwd": fa.bwd_launches}
    check(math.isfinite(m["loss"]) and all(v == 2 for v in k1.values()),
          f"shifted train step: loss {m['loss']}, K1 {k1}")
    del tr
    torch.cuda.empty_cache()
    cfg_f = dalle_1p4b(shift_tokens=True)
    wf = DalleWithVae(init_dalle(cfg_f, seed=SMOKE_SEED + 9),
                      DiscreteVAEAdapter(init_dvae(DVAEConfig(), seed=SMOKE_SEED)))
    wf._resolve_precision("bfloat16")
    dec.launches = 0
    t0 = time.perf_counter()
    images = wf.generate_images(text, generator=torch.Generator("cuda").manual_seed(4),
                                precision="bfloat16")
    torch.cuda.synchronize()
    shift_wall = time.perf_counter() - t0
    check(bool(torch.isfinite(images).all()) and dec.launches == per_pass,
          f"shifted generation: K2 {dec.launches}, expected {per_pass}")
    launches["decode_attend"] += dec.launches
    emit("token_shift", decode_vs_forward_max_abs_err=shift_err, tolerance=1e-3,
         train_step_loss=m["loss"], train_step_k1=k1, generate_wall_s=shift_wall,
         generate_ms_per_token=shift_wall * 1e3 / cfg_f.image_seq_len,
         generate_k2_launches=dec.launches, card=card)
    del wf
    torch.cuda.empty_cache()
    emit("decode_surface_done", seconds=time.perf_counter() - t_phase, card=card)
    return dict(launches=launches, engine=eng_launches, k1=k1, spec=spec,
                w8_err=w8_err, w8_share=w8_share, w8_timing=w8_timing,
                k3_ragged=k3_shares)


# ---------------------------------------------------------------------------
# K4 and the long-sequence training path
# ---------------------------------------------------------------------------

def longseq_config(**overrides):
    """The repo's long-sequence DALL·E, verbatim from scripts/bench_sweep.py
    (workload "longseq"): 256 text + 64×64 image tokens = 4,352, dim 512,
    4 layers of 8 heads × 64, full/axial_row/axial_col/full attention."""
    from dalle_tpu_torch import DalleConfig
    ls = dict(num_text_tokens=10000, text_seq_len=256, dim=512, depth=4, heads=8, dim_head=64,
              image_size=512, image_vocab_size=8192, image_fmap_size=64,
              attn_types=("full", "axial_row", "axial_col", "full"), attn_softmax_f32=False)
    return DalleConfig(**{**ls, **overrides})


K4_TOL = {"o_dq_dk_dv": "f32 route: flash_attention.kernel_tolerance: 2e-5*max(1,max|want|) "
                        "+ (2^-7*|want| for bf16), per element",
          "o_dq_dk_dv_bf16": "tensor-core route against the plain versions with "
                             "operands='bf16': flash_attention.tc_kernel_tolerance: "
                             "2^-7*rounding_bound + kernel_tolerance, per element",
          "cost_bf16": "tensor-core route against the TPU's f32 arithmetic (reported and "
                       "checked): flash_attention.rounding_tolerance: 2^-8*rounding_bound + "
                       "kernel_tolerance, per element",
          "lse": "flash_attention.lse_tolerance: 1e-5*max(1,|want|), per element"}
# K4's launch counters: every launch, then those of the tensor-core route
K4_COUNTERS = ("fwd_launches", "bwd_dq_launches", "bwd_dkv_launches",
               "tc_fwd_launches", "tc_bwd_dq_launches", "tc_bwd_dkv_launches")


def k4_counts(fl):
    return tuple(getattr(fl, c) for c in K4_COUNTERS)


def k4_set_counts(fl, counts):
    for c, x in zip(K4_COUNTERS, counts):
        setattr(fl, c, x)


def ptxas_report(source, keep):
    """nvcc's report (registers, spills) per kernel instance of
    csrc/<source>.cu whose mangled name holds ``keep``, from this process's
    build; {} when this process built nothing."""
    from dalle_tpu_torch.ops import _build
    ptxas, fn = {}, None
    for line in _build.build_logs.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        if fn and keep in fn and ("registers" in line or "spill" in line):
            ptxas.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    return ptxas


def k4_tc_build(torch):
    """The tensor-core route's build as nvcc reported it (registers, spills
    per kernel instance) and its tiles and shared memory per CTA, from the
    formulas of csrc/flash_attention.cu (tc_*_smem)."""
    ptxas = ptxas_report("flash_attention", "tc_")
    smem = {d: {"fwd": 5 * 64 * (d + 8) * 2, "dq": 6 * 64 * (d + 8) * 2,
                "dkv": 6 * 64 * (d + 8) * 2 + 4 * 64 * 4} for d in (16, 32, 64, 128)}
    return {"threads_per_cta": {"fwd": 128, "dq": 256, "dkv": 256}, "rows_per_cta": 64,
            "rows_per_warp": 16, "columns_per_warp": {"fwd": 64, "dq": 32, "dkv": 32},
            "instruction": "mma.sync.aligned.m16n8k16 bf16 -> f32", "stages": 2,
            "smem_bytes_per_cta": smem, "ptxas": ptxas or "no build log in this process"}


def _k4_masks(kind, n, text_len, fmap):
    """(numpy mask, spec) of a case: the transformer's mask one position
    longer than n and its spec; "holes" is a tabled 16-block sparse mask
    with row 5 fully masked."""
    from dalle_tpu_torch.ops.attn_masks import build_mask
    if kind == "none":
        return None, None
    if kind == "holes":
        mask = build_mask("sparse", text_len, fmap, block=16, num_random_blocks=1)[:n, :n]
        mask[5] = False
        return mask, None
    spec = {"axial_row": ("axial", text_len, fmap, 0), "axial_col": ("axial", text_len, fmap, 1),
            "conv_like": ("conv", text_len, fmap, 5, 1), "sparse": ("block", 128)}[kind]
    return build_mask(kind, text_len, fmap, block=128), spec


def k4_bounds(b, h, n, d, itemsize, sched):
    """Least card time of K4's three functions for these inputs:
    {"fwd"|"dq"|"dkv"|"bwd": (bound ms, "bytes"|"operations", flops, bytes)}.
    Operations count the pairs the mask makes visible (causality included),
    at the bf16 tensor-core rate: 2 products of 2·d flops each forward
    (s, p·v); dq recomputes s and dP and forms dQ (3 products), dk/dv s, dP,
    dK and dV (4); the whole backward shares s and dP (5). Bytes count each
    input read once and each output written once: q, k, v in, o and lse
    out; backward q, k, v, dO, lse, delta in, dq / dk, dv out; plus a
    tabled mask."""
    from dalle_tpu_torch.ops import flash_attention as fl
    pairs = b * h * fl.visible_pairs(sched)
    t = b * h * n * d * itemsize
    stats = b * h * n * 4
    tbl = n * n if sched.table is not None else 0
    work = {"fwd": (4 * d * pairs, 3 * t + t + stats + tbl),
            "dq": (6 * d * pairs, 4 * t + 2 * stats + t + tbl),
            "dkv": (8 * d * pairs, 4 * t + 2 * stats + 2 * t + tbl),
            "bwd": (10 * d * pairs, 4 * t + 2 * stats + 3 * t + tbl)}
    res = {}
    for k, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        res[k] = (max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
                  ops, nbytes)
    return res


def phase_flash_kernel(torch, card):
    import torch.nn.functional as F
    from dalle_tpu_torch.ops import flash_attention as fl
    t_phase = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED + 7)
    # (name, b, h, n, d, causal, mask kinds, text_len, fmap)
    cases = [("slice", 2, 8, 4352, 64, True,
              ("none", "axial_row", "axial_col", "conv_like", "sparse"), 257, 64),
             ("dalle1p4b", 8, 14, 512, 128, True, ("none", "axial_row"), 257, 16),
             ("ragged", 3, 6, 77, 64, True, ("holes",), 13, 8),
             ("non_causal", 2, 4, 300, 32, False, ("none",), 0, 0)]
    errs, shares, costs, n_cases = {}, {}, {}, 0
    saved = k4_counts(fl)
    for name, b, h, n, d, causal, kinds, text_len, fmap in cases:
        for kind in kinds:
            mask, spec = _k4_masks(kind, n, text_len, fmap)
            sched = fl.flash_schedule(n, mask, spec, causal, device="cuda")
            for dt in ("float32", "bfloat16"):
                q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen)
                               .to(getattr(torch, dt)) for _ in range(4))
                # the plain version in the route's arithmetic: the TPU's f32
                # for f32 operands, the tensor cores' roundings for bf16
                ops = "bf16" if dt == "bfloat16" else "f32"
                before = k4_counts(fl)
                ro, rlse = fl.flash_fwd_plain(q, k, v, sched, operands=ops)
                delta = (do.float() * ro.float()).sum(-1).contiguous()
                o, lse = fl.flash_attention_fwd(q, k, v, sched)
                got = {"o": o, "lse": lse,
                       "dq": fl.flash_attention_bwd_dq(q, k, v, do, rlse, delta, sched)}
                got["dk"], got["dv"] = fl.flash_attention_bwd_dkv(q, k, v, do, rlse, delta, sched)
                want = {"o": ro, "lse": rlse,
                        "dq": fl.flash_bwd_dq_plain(q, k, v, do, rlse, delta, sched,
                                                    operands=ops)}
                want["dk"], want["dv"] = fl.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, sched,
                                                                operands=ops)
                torch.cuda.synchronize()
                tc = int(ops == "bf16")
                routed = tuple(a - b_ for a, b_ in zip(k4_counts(fl), before))
                check(routed == (1, 1, 1, tc, tc, tc),
                      f"K4 {name}/{kind}/{dt}: launches by route {routed}")
                n_cases += 1
                bound = (fl.rounding_bound(q, k, v, do, rlse, delta, sched) if tc else {})
                for out, g in got.items():
                    w = want[out]
                    if out == "lse":
                        tol = fl.lse_tolerance(w)
                    elif tc:
                        tol = fl.tc_kernel_tolerance(w, bound[out])
                    else:
                        tol = fl.kernel_tolerance(w)
                    diff = (g.float() - w.float()).abs()
                    share = (diff / tol).max().item()
                    key = f"{out}/{name}/{kind}/{dt}"
                    errs[key], shares[key] = diff.max().item(), share
                    check(math.isfinite(share) and share <= 1.0,
                          f"K4 {key}: an element is {share} of its bound (max abs err "
                          f"{diff.max().item()})")
                if tc:
                    # the cost of the route: the bf16 kernel against the TPU's
                    # f32 arithmetic on the same inputs and backward statistics
                    f32 = {"o": fl.flash_fwd_plain(q, k, v, sched)[0],
                           "dq": fl.flash_bwd_dq_plain(q, k, v, do, rlse, delta, sched)}
                    f32["dk"], f32["dv"] = fl.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, sched)
                    for out, w in f32.items():
                        share = ((got[out].float() - w.float()).abs()
                                 / fl.rounding_tolerance(w, bound[out])).max().item()
                        costs[f"{out}/{name}/{kind}"] = share
                        check(math.isfinite(share) and share <= 1.0,
                              f"K4 bf16 {out}/{name}/{kind} against the f32 arithmetic: "
                              f"{share} of the rounding bound")
                if kind == "holes":
                    check(torch.equal(o[:, :, 5], torch.zeros_like(o[:, :, 5]))
                          and bool((lse[:, :, 5] == 1e9).all()),
                          f"K4 {dt}: the fully masked row is not zero with lse 1e9")
    k4_set_counts(fl, saved)
    by = {f"{out}/{dt}": max(v for key, v in errs.items()
                             if key.startswith(out + "/") and key.endswith("/" + dt))
          for out in ("o", "lse", "dq", "dk", "dv") for dt in ("float32", "bfloat16")}
    worst = {f"{out}/{dt}": max(v for key, v in shares.items()
                                if key.startswith(out + "/") and key.endswith("/" + dt))
             for out in ("o", "lse", "dq", "dk", "dv") for dt in ("float32", "bfloat16")}
    cost = {out: max(v for key, v in costs.items() if key.startswith(out + "/"))
            for out in ("o", "dq", "dk", "dv")}
    emit("flash_kernel", kernels=["flash_attention_fwd", "flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv"],
         routes={"float32": "fwd_kernel, dq_kernel, dkv_kernel (f32 FMA)",
                 "bfloat16": "tc_fwd_kernel, tc_dq_kernel, tc_dkv_kernel (tensor cores)"},
         cases=n_cases, tolerance=K4_TOL, max_abs_err=by, worst_share_of_bound=worst,
         bf16_worst_share_of_rounding_bound_against_f32=cost, tc_build=k4_tc_build(torch))

    # times in bf16 (the training path's dtype): each layer kind of the
    # slice, and the DALL·E-1.4B attention shape beside K1's
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    timing = {}
    for name, b, h, n, d, kind, text_len, fmap in (
            ("slice/full", 2, 8, 4352, 64, "none", 257, 64),
            ("slice/axial_row", 2, 8, 4352, 64, "axial_row", 257, 64),
            ("slice/axial_col", 2, 8, 4352, 64, "axial_col", 257, 64),
            ("dalle1p4b/causal", 8, 14, 512, 128, "none", 257, 16)):
        mask, spec = _k4_masks(kind, n, text_len, fmap)
        sched = fl.flash_schedule(n, mask, spec, True, device="cuda")
        q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen).bfloat16()
                       for _ in range(4))
        o, lse = fl.flash_attention_fwd(q, k, v, sched)
        delta = (do.float() * o.float()).sum(-1).contiguous()
        saved = k4_counts(fl)

        def kernels(q, k, v, do, iters):
            return {"fwd": median_ms(lambda: fl.flash_attention_fwd(q, k, v, sched), iters, flush),
                    "dq": median_ms(lambda: fl.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                                      sched), iters, flush),
                    "dkv": median_ms(lambda: fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                                        sched), iters, flush)}
        ms = kernels(q, k, v, do, 20)
        # the f32 route (f32 FMA on the CUDA cores) on the same values, same call
        f32_ms = kernels(*(t.float() for t in (q, k, v, do)), 5)
        k4_set_counts(fl, saved)
        plain = {"fwd": median_ms(lambda: fl.flash_fwd_plain(q, k, v, sched, operands="bf16"),
                                  5, flush),
                 "dq": median_ms(lambda: fl.flash_bwd_dq_plain(q, k, v, do, lse, delta, sched,
                                                               operands="bf16"), 5, flush),
                 "dkv": median_ms(lambda: fl.flash_bwd_dkv_plain(q, k, v, do, lse, delta, sched,
                                                                 operands="bf16"), 5, flush)}
        # the library yardstick: SDPA forward, and its backward alone (dq, dk
        # and dv together); a masked layer passes its boolean (n, n) mask
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        if mask is None:
            kw = dict(is_causal=True)
        else:
            kw = dict(attn_mask=torch.from_numpy(mask[:n, :n]).cuda()
                      & torch.ones(n, n, dtype=torch.bool, device="cuda").tril())
        with torch.no_grad():
            lib_fwd = median_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, **kw), 20, flush)
        ol = F.scaled_dot_product_attention(ql, kl, vl, **kw)
        lib_bwd = median_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True),
                            20, flush)
        del ol
        bounds = k4_bounds(b, h, n, d, 2, sched)
        row = {"visible_pairs": b * h * fl.visible_pairs(sched),
               "visited_tiles": b * h * sched.visited_tiles,
               "backward_bound_ms": bounds["bwd"][0], "backward_bound_by": bounds["bwd"][1]}
        for w in ("fwd", "dq", "dkv"):
            bound, by_what, ops, nbytes = bounds[w]
            row[w] = {"ms": ms[w], "plain_ms": plain[w],
                      "library_ms": lib_fwd if w == "fwd" else lib_bwd,
                      "bound_ms": bound, "bound_by": by_what, "flops": ops, "bytes": nbytes,
                      "roofline_share": bound / ms[w], "f32_route_ms": f32_ms[w]}
        row["share_of_backward_bound"] = {w: bounds["bwd"][0] / ms[w] for w in ("dq", "dkv")}
        timing[name] = row
    emit("flash_kernel_timing", dtype="bfloat16", route="tensor cores (f32_route_ms: the same "
         "values as f32 through the f32 route)",
         shapes={"slice": dict(b=2, h=8, n=4352, d=64), "dalle1p4b": dict(b=8, h=14, n=512, d=128)},
         library="torch.nn.functional.scaled_dot_product_attention (is_causal, or a boolean "
                 "(n, n) mask) forward, and its backward alone for dq and dk/dv",
         card=card, by_case=timing, seconds=time.perf_counter() - t_phase)
    return errs, timing


def _k4_step_parity(torch, fl, compute, seed):
    """One long-sequence step (depth 4, batch 1) through K4's kernels and
    through its plain versions in the route's arithmetic ("bf16" operands
    for bf16 compute), on the same weights and batch: (loss through the
    kernels, loss through the plain versions, worst gradient share of the
    tensor's largest entry, its tensor, launches by route of the kernel
    step, tensors compared)."""
    import functools
    from dalle_tpu_torch import DalleTrainer, OptimConfig, PrecisionConfig, TrainConfig
    cfg = longseq_config()
    tc = TrainConfig(batch_size=1, seed=seed,
                     optim=OptimConfig(learning_rate=3e-4, grad_clip_norm=0.5),
                     precision=PrecisionConfig(compute=compute))
    tr = DalleTrainer(cfg, tc)
    text, img = _train_batch(cfg, 1, seed)
    text = torch.from_numpy(text).cuda()
    img = torch.from_numpy(img).cuda()

    def grads():
        tr.optimizer.zero_grad()
        before = k4_counts(fl)
        loss, _ = tr.loss_and_backward(text, img)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(k4_counts(fl), before))
        return loss.item(), {n: p.grad.clone() for n, p in tr.model.named_parameters()}, launched

    loss_k, g_k, launched_k = grads()
    ops = "bf16" if compute == "bfloat16" else "f32"
    names = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    kernels = [getattr(fl, nm) for nm in names]
    for nm, fn in zip(names, (fl.flash_fwd_plain, fl.flash_bwd_dq_plain, fl.flash_bwd_dkv_plain)):
        setattr(fl, nm, functools.partial(fn, operands=ops))
    try:
        loss_p, g_p, launched_p = grads()
    finally:
        for nm, fn in zip(names, kernels):
            setattr(fl, nm, fn)
    check(launched_p == (0,) * 6, f"plain step launched K4 {launched_p}")
    worst, worst_name = 0.0, ""
    for name, gp in g_p.items():
        share = (g_k[name] - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
        if share > worst or not math.isfinite(share):
            worst, worst_name = share, name
    tensors = len(g_p)
    del tr, g_k, g_p
    torch.cuda.empty_cache()
    return loss_k, loss_p, worst, worst_name, launched_k, tensors


def phase_flash_parity(torch):
    from dalle_tpu_torch import dalle_1p4b, init_dalle
    from dalle_tpu_torch.ops import flash_attention as fl
    t_phase = time.perf_counter()
    cfg = longseq_config()
    d = cfg.depth
    loss_k, loss_p, worst, worst_name, launched_k, tensors = _k4_step_parity(
        torch, fl, "float32", SMOKE_SEED + 8)
    # f32 compute: every launch on the f32 route
    check(launched_k == (2 * d, d, d, 0, 0, 0), f"kernel step launched K4 {launched_k}")
    # f32 compute, the same inputs, both sides f32 arithmetic: summation
    # order only, 1e-5 of the loss and 1e-4 of each tensor's largest gradient
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(math.isfinite(loss_k) and loss_err <= 1e-5, f"loss {loss_k} vs plain {loss_p}")
    check(worst <= 1e-4, f"gradient of {worst_name}: {worst} of its largest entry")

    # bf16 compute: every launch on the tensor-core route, against the plain
    # versions with operands="bf16". Bounds, stated before the first run:
    # the two sides round the same p and dS to bf16 and differ where one
    # lands on a rounding boundary (an attention output a bf16 ulp apart on a
    # few elements); the rest of the step computes in bf16, where each
    # rounding is 2^-8, so the loss within 2^-8 relative and each gradient
    # within 2^-4 of its tensor's largest entry (a kernel that was wrong
    # anywhere would be off by O(1))
    b_loss_k, b_loss_p, b_worst, b_worst_name, b_launched, _ = _k4_step_parity(
        torch, fl, "bfloat16", SMOKE_SEED + 8)
    check(b_launched == (2 * d, d, d, 2 * d, d, d),
          f"bf16 kernel step launched K4 {b_launched} (all, then tensor-core route)")
    b_loss_err = abs(b_loss_k - b_loss_p) / abs(b_loss_p)
    check(math.isfinite(b_loss_k) and b_loss_err <= 2.0 ** -8,
          f"bf16 loss {b_loss_k} vs plain (operands='bf16') {b_loss_p}")
    check(b_worst <= 2.0 ** -4, f"bf16 gradient of {b_worst_name}: {b_worst} of its largest entry")

    # DALL·E-1.4B at depth 2: the forward through K4 against dense, f32 logits
    model = init_dalle(dalle_1p4b(depth=2, use_pallas="flash"), seed=SMOKE_SEED + 9).eval()
    t1, i1 = _train_batch(model.cfg, 4, SMOKE_SEED + 9)
    t1, i1 = torch.from_numpy(t1).cuda(), torch.from_numpy(i1).cuda()
    before = fl.fwd_launches
    with torch.no_grad():
        flash = model(t1, i1)
        launched = fl.fwd_launches - before
        model.transformer.cfg = dataclasses.replace(model.transformer.cfg, use_pallas="off")
        dense = model(t1, i1)
    torch.cuda.synchronize()
    logit_err = (flash - dense).abs().max().item()
    check(launched == 2, f"the 1.4B flash forward launched K4 {launched} times")
    check(logit_err <= 1e-4, f"1.4B flash vs dense logits: max abs err {logit_err}")
    emit("flash_parity", config="longseq (scripts/bench_sweep.py)", depth=d, dim=cfg.dim,
         heads=cfg.heads, seq=cfg.total_seq_len, batch=1, compute="float32",
         loss_kernel=loss_k, loss_plain=loss_p, loss_rel_err=loss_err, tensors=tensors,
         worst_grad_err_share=worst, worst_grad_tensor=worst_name,
         launches_kernel_step=dict(zip(K4_COUNTERS, launched_k)),
         bf16_step=dict(compute="bfloat16", plain="operands='bf16'", loss_kernel=b_loss_k,
                        loss_plain=b_loss_p, loss_rel_err=b_loss_err,
                        worst_grad_err_share=b_worst, worst_grad_tensor=b_worst_name,
                        launches_kernel_step=dict(zip(K4_COUNTERS, b_launched)),
                        tolerance=dict(loss_rel=2.0 ** -8, grad_share_of_largest=2.0 ** -4)),
         dalle1p4b_depth2_flash_vs_dense_max_abs_logit_err=logit_err,
         tolerance=dict(loss_rel=1e-5, grad_share_of_largest=1e-4, logits_abs=1e-4),
         seconds=time.perf_counter() - t_phase)
    del model
    torch.cuda.empty_cache()


def phase_train_long(torch, card):
    from dalle_tpu_torch import DalleTrainer, OptimConfig, TrainConfig
    from dalle_tpu_torch.ops import flash_attention as fl
    from dalle_tpu_torch.ops import fused_attention as fa
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = longseq_config()
    b, steps = 2, 6
    tc = TrainConfig(batch_size=b, seed=SMOKE_SEED,
                     optim=OptimConfig(optimizer="adam", learning_rate=3e-4, grad_clip_norm=0.5))
    tr = DalleTrainer(cfg, tc)
    check(tr.model.transformer.attention_mode(torch.device("cuda")) == "flash",
          "use_pallas='auto' does not pick K4 at 4,352 tokens on the card")
    text, img = _train_batch(cfg, b, SMOKE_SEED)
    text = torch.from_numpy(text).cuda()
    img = torch.from_numpy(img).cuda()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    # the long-sequence training path starts here
    k4_set_counts(fl, (0,) * len(K4_COUNTERS))
    fa.fwd_launches = fa.bwd_launches = 0
    for _ in range(steps):
        t0 = time.perf_counter()
        m = tr.train_step(text, img)               # ends in a host read of the metrics
        walls.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    launches = {"flash_attention_fwd": fl.fwd_launches,
                "flash_attention_bwd_dq": fl.bwd_dq_launches,
                "flash_attention_bwd_dkv": fl.bwd_dkv_launches}
    tc_launches = {"flash_attention_fwd": fl.tc_fwd_launches,
                   "flash_attention_bwd_dq": fl.tc_bwd_dq_launches,
                   "flash_attention_bwd_dkv": fl.tc_bwd_dkv_launches}
    k1 = (fa.fwd_launches, fa.bwd_launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over {steps} steps: {losses}")
    want = {"flash_attention_fwd": 2 * cfg.depth * steps,     # remat recomputes it
            "flash_attention_bwd_dq": cfg.depth * steps,
            "flash_attention_bwd_dkv": cfg.depth * steps}
    check(launches == want, f"K4 launched {launches} in {steps} steps, expected {want}")
    # the bf16 step goes wholly through the tensor-core route
    check(tc_launches == want, f"K4's tensor-core route launched {tc_launches} of {launches}")
    check(k1 == (0, 0), f"K1 launched {k1} on the long-sequence path")
    ms = statistics.median(walls[1:]) * 1e3
    tokens = b * cfg.total_seq_len
    row = dict(config="longseq (scripts/bench_sweep.py)", seq=cfg.total_seq_len, batch=b,
               steps=steps, use_pallas=cfg.use_pallas, use_remat=cfg.use_remat,
               loss_chunk=cfg.loss_chunk, compute=tc.precision.compute, losses=losses,
               grad_norm_last=m["grad_norm"], ms_per_step_first=walls[0] * 1e3,
               ms_per_step=ms, tokens_per_s=tokens / ms * 1e3,
               model_tflops_per_s=tr.flops_per_step / ms / 1e9, params=tr.num_params,
               peak_gib=peak, launches=launches, tc_route_launches=tc_launches,
               k1_launches=dict(zip(("fwd", "bwd"), k1)), card=card)
    emit("train_long", **row)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    saved = k4_counts(fl)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.train_step(text, img)
        wall = time.perf_counter() - t0
    k4_set_counts(fl, saved)
    dev_us, by_kernel = device_time(torch, prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    # K4 in the profiled step: its three tensor-core kernels, by kind
    k4_us = {w: sum(v for k, v in by_kernel.items() if f"tc_{w}_kernel" in k)
             for w in ("fwd", "dq", "dkv")}
    # where the host's time goes: self CPU time by op, the largest first
    host = sorted(((e.key[:80], e.self_cpu_time_total) for e in prof.key_averages()),
                  key=lambda kv: -kv[1])[:12]
    emit("train_long_profile", wall_ms_profiled=wall * 1e3,
         device_ms=dev_us / 1e3 if dev_us else "not measured",
         device_busy_share=(dev_us / 1e3) / ms if dev_us else "not measured",
         k4_device_ms=({w: v / 1e3 for w, v in k4_us.items()} | {"all": sum(k4_us.values()) / 1e3}
                       if dev_us else "not measured"),
         top_device_ms={k: v / 1e3 for k, v in top},
         top_host_self_ms={k: v / 1e3 for k, v in host}, card=card)
    del tr
    torch.cuda.empty_cache()

    # for the record: the same step with dense attention (mask tables) and
    # with K1; fresh trainers from the same seed, so step 1 sees the same
    # weights. bf16 compute rounds at other places on the three paths: the
    # step-1 losses agree within 1e-2 relative
    others = {}
    for mode in ("off", "fused"):
        other = DalleTrainer(dataclasses.replace(cfg, use_pallas=mode), tc)
        torch.cuda.reset_peak_memory_stats()
        saved = k4_counts(fl) + (fa.fwd_launches, fa.bwd_launches)
        o_losses, o_walls = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            o_losses.append(other.train_step(text, img)["loss"])
            o_walls.append(time.perf_counter() - t0)
        k4_set_counts(fl, saved[:-2])
        fa.fwd_launches, fa.bwd_launches = saved[-2:]
        rel = abs(o_losses[0] - losses[0]) / abs(losses[0])
        check(rel <= 1e-2, f"step-1 loss with use_pallas={mode} {o_losses[0]} vs K4 {losses[0]}")
        others[mode] = dict(ms_per_step=statistics.median(o_walls[1:]) * 1e3,
                            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                            loss_step1=o_losses[0], loss_step1_rel_to_k4=rel)
        del other
        torch.cuda.empty_cache()
    emit("train_long_others", k4=dict(ms_per_step=ms, peak_gib=peak, loss_step1=losses[0]),
         dense=others["off"], k1=others["fused"], tolerance=dict(loss_step1_rel=1e-2),
         card=card, seconds=time.perf_counter() - t_phase)
    return launches, row


# ---------------------------------------------------------------------------
# K8 and the persist training path; K7
# ---------------------------------------------------------------------------

K8_TOL = {"o_dq_dk_dv": "fused_attention.kernel_tolerance (K1's arithmetic): "
                        "2e-3*max(1,max|want|) + (2^-7*|want| for bf16), per element",
          "peaked": "fused_attention.flip_tolerance: 2^-7 * persistent_attention."
                    "rounding_bound + kernel_tolerance, per element"}


def k8_bounds(b, h, n, d, itemsize, table):
    """Least card time of K8's forward and backward for these inputs:
    {"fwd"|"bwd": (bound ms, "bytes"|"operations", flops, bytes)}.
    Operations count the visible pairs (the table's ones, causality in it):
    2 products of 2·d flops each forward (s, p·v), 6 backward (s, o, dp, dq,
    dk, dv), at the bf16 tensor-core rate. Bytes count each input read once
    and each output written once: forward q, k, v in and o out; backward q,
    k, v, dO in and dq, dk, dv out; plus the table."""
    pairs = b * h * (n * (n + 1) // 2 if table is None else int(table.long().sum()))
    t = b * h * n * d * itemsize
    tbl = 0 if table is None else n * n
    work = {"fwd": (4 * d * pairs, 4 * t + tbl), "bwd": (12 * d * pairs, 7 * t + tbl)}
    res = {}
    for k, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        res[k] = (max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
                  ops, nbytes)
    return res


def _k8_table(torch, kind, n):
    """None (causal), a layer's MaskTable (table and tile map, as the
    transformer hands it to K8), or "holes": a raw causal table with row 5
    empty (its softmax spreads 1/n over every key, as the TPU's -1e9 fill
    does; the wrapper builds its tile map and empty-row flags)."""
    from dalle_tpu_torch.ops import fused_attention as fa
    if kind == "none":
        return None
    if kind == "holes":
        tbl = torch.ones(n, n, dtype=torch.int8, device="cuda").tril()
        tbl[5] = 0
        return tbl
    return fa.layer_table(kind, n, device="cuda")


def launched_kernels(torch, fn, calls: int = 4):
    """The device kernels ``calls`` calls of ``fn`` ran, one name per launch,
    from a profile. A profile that saw no kernel at all (the tracer can miss
    a window) is taken again, up to three times."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and not re.fullmatch(r"[\w.]+#[\w.]+", e.name)]
        if names:
            break
    return names


def sdpa_kernels(torch, fn):
    """The device kernels one call of ``fn`` (an SDPA call) ran, by name:
    which backend SDPA took on these inputs."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    _, by_kernel = device_time(torch, prof)
    return sorted(by_kernel, key=lambda k: -by_kernel[k])[:4]


def phase_persist_kernel(torch, card):
    import torch.nn.functional as F
    from dalle_tpu_torch.ops import fused_attention as fa
    from dalle_tpu_torch.ops import persistent_attention as pa
    t_phase = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED + 10)
    # (name, b, h, n, d, dtype, table kinds, q multiplier)
    cases = [("dalle1p4b", 8, 14, 512, 128, "bfloat16", ("none", "axial_row"), 1.0),
             ("dalle_small", 64, 8, 512, 64, "bfloat16", ("none",), 1.0),
             ("ragged", 3, 6, 77, 64, "bfloat16", ("holes", "conv_like"), 1.0),
             ("n513", 4, 8, 513, 64, "bfloat16", ("none", "axial_row"), 1.0),
             ("f32_inputs", 2, 4, 256, 64, "float32", ("none", "holes"), 1.0),
             ("n2048", 1, 4, 2048, 128, "bfloat16", ("none", "holes"), 1.0),
             ("peaked", 8, 14, 512, 128, "bfloat16", ("none",), 8.0)]
    errs, shares, n_cases = {}, {}, 0
    saved = pa.fwd_launches, pa.bwd_launches
    for name, b, h, n, d, dt, kinds, mul in cases:
        for kind in kinds:
            table = _k8_table(torch, kind, n)
            q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen)
                           .to(getattr(torch, dt)) for _ in range(4))
            q = q * mul
            # the backward from the forward's (m, l), as the training step
            # runs it, and the one that computes them itself: the same bits
            o, stats = pa.persist_fwd(q, k, v, table, return_stats=True)
            grads = pa.persist_bwd(q, k, v, do, table, stats=stats)
            alone = pa.persist_bwd(q, k, v, do, table)
            got = dict(zip(("o", "dq", "dk", "dv"), (o,) + grads))
            want = dict(zip(("o", "dq", "dk", "dv"),
                            (pa.persist_fwd_plain(q, k, v, table),)
                            + pa.persist_bwd_plain(q, k, v, do, table)))
            bound = (dict(zip(("o", "dq", "dk", "dv"), pa.rounding_bound(q, k, v, do, table)))
                     if mul != 1.0 else None)
            torch.cuda.synchronize()
            check(all(torch.equal(a, z) for a, z in zip(grads, alone)),
                  f"K8 {name}/{kind}: the backward from the forward's (m, l) differs from "
                  "the one that recomputes them")
            n_cases += 1
            for out, g in got.items():
                w = want[out]
                check(g.dtype == q.dtype and g.shape == q.shape, f"K8 {out} {g.dtype} {g.shape}")
                diff = (g.float() - w.float()).abs()
                tol = (fa.kernel_tolerance(w) if bound is None
                       else fa.flip_tolerance(w, bound[out]))
                share = (diff / tol).max().item()
                key = f"{out}/{name}/{kind}/{dt}"
                errs[key], shares[key] = diff.max().item(), share
                check(math.isfinite(share) and share <= 1.0,
                      f"K8 {key}: an element is {share} of its bound (max abs err "
                      f"{diff.max().item()})")
            del q, k, v, do, o, grads, alone, got, want, bound
    # the main path's layout: the head views of the (b, n, 3·h·d) projection,
    # read through their strides, give the bits of contiguous copies, and
    # two runs give the same bits
    b, h, n, d = 8, 14, 512, 128
    qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).bfloat16()
    views = [t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]
    do = torch.randn(b, h, n, d, device="cuda", generator=gen).bfloat16()

    def run(q, k, v):
        o, stats = pa.persist_fwd(q, k, v, return_stats=True)
        return (o,) + pa.persist_bwd(q, k, v, do, stats=stats)

    runs = [run(*views), run(*views), run(*(t.contiguous() for t in views))]
    torch.cuda.synchronize()
    repeat_same = all(torch.equal(a, z) for a, z in zip(runs[0], runs[1]))
    strided_same = all(torch.equal(a, z) for a, z in zip(runs[0], runs[2]))
    check(repeat_same, "K8: two runs on the same inputs differ")
    check(strided_same, "K8: strided head views differ from their contiguous copies")
    del qkv, views, do, runs
    pa.fwd_launches, pa.bwd_launches = saved
    by = {out: max(v for key, v in errs.items() if key.startswith(out + "/"))
          for out in ("o", "dq", "dk", "dv")}
    worst = {out: max(v for key, v in shares.items()
                      if key.startswith(out + "/") and "/peaked/" not in key)
             for out in ("o", "dq", "dk", "dv")}
    peaked = {out: shares[f"{out}/peaked/none/bfloat16"] for out in ("o", "dq", "dk", "dv")}
    emit("persist_kernel", kernels=["persist_fwd", "persist_bwd"], cases=n_cases,
         tolerance=K8_TOL, max_abs_err=by, worst_share_of_bound=worst,
         peaked_share_of_flip_tolerance=peaked, repeat_same_bits=repeat_same,
         strided_views_same_bits=strided_same, build=k1_build("persistent_attention"))

    # times in bf16, causal: the DALL·E-1.4B layer and the DALL·E-small one
    # (where the JAX package measured persist), K1 on the same data in its
    # merged (b, n, 3·h·d) layout and SDPA beside them. The backward is
    # timed as the training step runs it, from the forward's (m, l); the
    # one that computes them first is beside it
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    timing = {}
    for name, b, h, n, d in (("dalle1p4b", 8, 14, 512, 128), ("dalle_small", 64, 8, 512, 64)):
        q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen).bfloat16()
                       for _ in range(4))
        saved = pa.fwd_launches, pa.bwd_launches, fa.fwd_launches, fa.bwd_launches
        _, stats = pa.persist_fwd(q, k, v, return_stats=True)
        qkv = torch.cat([t.transpose(1, 2).reshape(b, n, h * d) for t in (q, k, v)], -1)
        do_m = do.transpose(1, 2).reshape(b, n, h * d).contiguous()
        _, m1, l1 = fa.fused_attention_fwd(qkv, h)
        # K8 and K1 in three turns; each time is the median of the turns' medians
        fns = {"fwd": lambda: pa.persist_fwd(q, k, v),
               "bwd": lambda: pa.persist_bwd(q, k, v, do, stats=stats),
               "k1_fwd": lambda: fa.fused_attention_fwd(qkv, h),
               "k1_bwd": lambda: fa.fused_attention_bwd(qkv, do_m, m1, l1, h)}
        turns = {key: [] for key in fns}
        for _ in range(3):
            for key, fn in fns.items():
                turns[key].append(median_ms(fn, 20, flush))
        ms = {w: statistics.median(turns[w]) for w in ("fwd", "bwd")}
        k1 = {w: statistics.median(turns["k1_" + w]) for w in ("fwd", "bwd")}
        bwd_alone = median_ms(lambda: pa.persist_bwd(q, k, v, do), 20, flush)
        plain = {"fwd": median_ms(lambda: pa.persist_fwd_plain(q, k, v), 5, flush),
                 "bwd": median_ms(lambda: pa.persist_bwd_plain(q, k, v, do), 5, flush)}
        pa.fwd_launches, pa.bwd_launches, fa.fwd_launches, fa.bwd_launches = saved
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

        lib_fwd = median_ms(sdpa_fwd, 20, flush)
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

        def sdpa_bwd():
            return torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)

        lib_bwd = median_ms(sdpa_bwd, 20, flush)
        backend = {"fwd": sdpa_kernels(torch, sdpa_fwd), "bwd": sdpa_kernels(torch, sdpa_bwd)}
        del ol
        bounds = k8_bounds(b, h, n, d, 2, None)
        row = {}
        for w, lib in (("fwd", lib_fwd), ("bwd", lib_bwd)):
            bound, by_what, ops, nbytes = bounds[w]
            row[w] = {"ms": ms[w], "plain_ms": plain[w], "library_ms": lib, "k1_ms": k1[w],
                      "bound_ms": bound, "bound_by": by_what, "flops": ops, "bytes": nbytes,
                      "roofline_share": bound / ms[w], "k1_factor": ms[w] / k1[w],
                      "library_factor": ms[w] / lib, "sdpa_kernels": backend[w],
                      "ms_turns": turns[w], "k1_ms_turns": turns["k1_" + w]}
        row["bwd"]["ms_computing_stats_first"] = bwd_alone
        timing[name] = row
    emit("persist_kernel_timing", dtype="bfloat16", mask="causal",
         shapes={"dalle1p4b": dict(b=8, h=14, n=512, d=128),
                 "dalle_small": dict(b=64, h=8, n=512, d=64)},
         backward="from the forward's (m, l), as the training step runs it; "
                  "ms_computing_stats_first: persist_bwd without them",
         library="torch.nn.functional.scaled_dot_product_attention(is_causal=True) forward, "
                 "and its backward alone (sdpa_kernels: the device kernels it ran); k1_ms: K1 "
                 "on the same data in its (b, n, 3hd) layout",
         card=card, by_case=timing, seconds=time.perf_counter() - t_phase)
    return errs, timing


def phase_persist_parity(torch):
    from dalle_tpu_torch import (DalleTrainer, OptimConfig, PrecisionConfig, TrainConfig,
                                 dalle_1p4b)
    from dalle_tpu_torch.ops import persistent_attention as pa
    t_phase = time.perf_counter()
    cfg = dalle_1p4b(depth=2, use_pallas="persist")
    tc = TrainConfig(batch_size=8, seed=SMOKE_SEED + 11,
                     optim=OptimConfig(learning_rate=3e-4, grad_clip_norm=0.5),
                     precision=PrecisionConfig(compute="float32"))
    tr = DalleTrainer(cfg, tc)
    check(tr.model.transformer.attention_mode(torch.device("cuda")) == "persist",
          "use_pallas='persist' does not pick K8 at DALL·E-1.4B on the card")
    text, img = _train_batch(cfg, 8, SMOKE_SEED + 11)
    text = torch.from_numpy(text).cuda()
    img = torch.from_numpy(img).cuda()

    def grads():
        tr.optimizer.zero_grad()
        before = pa.fwd_launches, pa.bwd_launches
        loss, _ = tr.loss_and_backward(text, img)
        torch.cuda.synchronize()
        launched = (pa.fwd_launches - before[0], pa.bwd_launches - before[1])
        return loss.item(), {n: p.grad.clone() for n, p in tr.model.named_parameters()}, launched

    loss_k, g_k, launched_k = grads()
    kernels = pa.persist_fwd, pa.persist_bwd

    def plain_fwd(q, k, v, table=None, scale=None, return_stats=False):
        out = pa.persist_fwd_plain(q, k, v, table, scale)
        return (out, None) if return_stats else out

    def plain_bwd(q, k, v, do, table=None, scale=None, stats=None):
        return pa.persist_bwd_plain(q, k, v, do, table, scale)

    pa.persist_fwd, pa.persist_bwd = plain_fwd, plain_bwd
    try:
        loss_p, g_p, launched_p = grads()
    finally:
        pa.persist_fwd, pa.persist_bwd = kernels
    check(launched_k == (cfg.depth, cfg.depth), f"kernel step launched K8 {launched_k}")
    check(launched_p == (0, 0), f"plain step launched K8 {launched_p}")
    # f32 compute, the same inputs: K8's bf16 roundings match except where
    # the kernel's summation order flips one (see fused_attention's
    # kernel_tolerance); a weight's gradient sums such terms over every
    # position: 1e-2 of each tensor's largest gradient, 1e-5 of the loss
    worst, worst_name = 0.0, ""
    for name, gp in g_p.items():
        share = (g_k[name] - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
        if share > worst or not math.isfinite(share):
            worst, worst_name = share, name
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(math.isfinite(loss_k) and loss_err <= 1e-5, f"loss {loss_k} vs plain {loss_p}")
    check(worst <= 1e-2, f"gradient of {worst_name}: {worst} of its largest entry")
    emit("persist_parity", depth=cfg.depth, dim=cfg.dim, heads=cfg.heads, batch=8,
         compute="float32", loss_kernel=loss_k, loss_plain=loss_p, loss_rel_err=loss_err,
         tensors=len(g_p), worst_grad_err_share=worst, worst_grad_tensor=worst_name,
         tolerance=dict(loss_rel=1e-5, grad_share_of_largest=1e-2),
         seconds=time.perf_counter() - t_phase)
    del tr, g_k, g_p
    torch.cuda.empty_cache()


def phase_train_persist(torch, card, k1_row):
    from dalle_tpu_torch import DalleTrainer, OptimConfig, TrainConfig, dalle_1p4b
    from dalle_tpu_torch.ops import fused_attention as fa
    from dalle_tpu_torch.ops import persistent_attention as pa
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = dalle_1p4b(use_pallas="persist")
    b, steps = 8, 6
    # phase train's recipe and seed: step 1 sees the same weights and batch
    tc = TrainConfig(batch_size=b, seed=SMOKE_SEED,
                     optim=OptimConfig(optimizer="adam", learning_rate=3e-4, grad_clip_norm=0.5))
    tr = DalleTrainer(cfg, tc)
    check(tr.model.transformer.attention_mode(torch.device("cuda")) == "persist",
          "use_pallas='persist' does not pick K8 at DALL·E-1.4B on the card")
    text, img = _train_batch(cfg, b, SMOKE_SEED)
    text = torch.from_numpy(text).cuda()
    img = torch.from_numpy(img).cuda()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    pa.fwd_launches = pa.bwd_launches = 0          # the persist training path starts here
    fa.fwd_launches = fa.bwd_launches = 0
    for _ in range(steps):
        t0 = time.perf_counter()
        m = tr.train_step(text, img)               # ends in a host read of the metrics
        walls.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    launches = {"persistent_attention_fwd": pa.fwd_launches,
                "persistent_attention_bwd": pa.bwd_launches}
    k1 = (fa.fwd_launches, fa.bwd_launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over {steps} steps: {losses}")
    for name, n in launches.items():
        check(n == steps * cfg.depth, f"{name} launched {n} times in {steps} steps, "
                                      f"expected {steps * cfg.depth}")
    check(k1 == (0, 0), f"K1 launched {k1} on the persist path")
    # the same bf16 arithmetic as K1 from the same weights and batch
    rel = abs(losses[0] - k1_row["losses"][0]) / abs(k1_row["losses"][0])
    check(rel <= 1e-2, f"step-1 loss through K8 {losses[0]} vs K1 {k1_row['losses'][0]}")
    ms = statistics.median(walls[1:]) * 1e3
    tokens = b * cfg.total_seq_len
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.train_step(text, img)
        wall = time.perf_counter() - t0
    pa.fwd_launches, pa.bwd_launches = launches.values()
    dev_us, by_kernel = device_time(torch, prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    row = dict(batch=b, steps=steps, use_pallas=cfg.use_pallas, losses=losses,
               grad_norm_last=m["grad_norm"], ms_per_step_first=walls[0] * 1e3,
               ms_per_step=ms, tokens_per_s=tokens / ms * 1e3,
               model_tflops_per_s=tr.flops_per_step / ms / 1e9, peak_gib=peak,
               launches=launches, k1_launches=dict(zip(("fwd", "bwd"), k1)),
               device_ms_profiled_step=dev_us / 1e3 if dev_us else "not measured",
               device_busy_share=(dev_us / 1e3) / ms if dev_us else "not measured",
               wall_ms_profiled=wall * 1e3, top_device_ms={k: v / 1e3 for k, v in top},
               k1_step=dict(ms_per_step=k1_row["ms_per_step"],
                            tokens_per_s=k1_row["tokens_per_s"], peak_gib=k1_row["peak_gib"],
                            loss_step1=k1_row["losses"][0]),
               loss_step1_rel_to_k1=rel, tolerance=dict(loss_step1_rel=1e-2),
               card=card, seconds=time.perf_counter() - t_phase)
    emit("train_persist", **row)
    del tr
    torch.cuda.empty_cache()
    return launches, row


def chunked_bounds(b, h, d, length, itemsize, qsize, scaled):
    """Least card time of K7 for these inputs: (bound ms, "bytes" or
    "operations", flops, bytes). Bytes: q in and out once, and the cache
    up to ``length`` (K and V, and their f32 scales for int8) once.
    Operations: 4·d flops per (row, head, position) below ``length``, at the
    f32 rate for an f32 cache and the bf16 tensor rate otherwise."""
    nbytes = (2 * b * h * d * qsize + b * length * 2 * h * d * itemsize
              + (b * 2 * h * length * 4 if scaled else 0))
    ops = 4 * b * h * length * d
    rate = F32_FLOPS if itemsize == 4 else BF16_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", ops, nbytes


def phase_chunked_kernel(torch, card):
    import torch.nn.functional as F
    from dalle_tpu_torch.ops import decode_attention as dec
    t_phase = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED + 12)
    # the JAX package's bench shapes (scripts/bench_decode_chunked.py) and the
    # long-sequence model's cache
    shapes = [("b64_h8_S1280_d64", 64, 8, 1280, 64), ("b16_h14_S2560_d128", 16, 14, 2560, 128),
              ("longseq_b2_h8_S4352_d64", 2, 8, 4352, 64)]
    shares, errs, n_cases = {}, {}, 0
    saved = dec.chunked_launches
    timing = {}
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for name, b, h, S, d in shapes:
        blk = 256
        for dt in ("float32", "bfloat16", "int8"):
            dtype = getattr(torch, dt)
            qdt = torch.float32 if dt == "float32" else torch.bfloat16
            cache = _cache(torch, b, h, d, S, dtype, gen)
            q = torch.randn(b, h, 1, d, device="cuda", generator=gen).to(qdt)
            row = (torch.rand(S, device="cuda", generator=gen) > 0.3).int()
            for length, mask in ((S // 4, None), (S // 2, None), (S, None), (S // 2 + 5, row),
                                 (0, None)):
                out = dec.decode_attend_chunked(q, cache, length, blk=blk, mask_row=mask)
                ref = dec.decode_attend_chunked_plain(q, cache.kv, cache.scale, length,
                                                      blk=blk, mask_row=mask)
                torch.cuda.synchronize()
                n_cases += 1
                key = f"{name}/{dt}/L{length}" + ("/mask" if mask is not None else "")
                diff = (out.float() - ref.float()).abs()
                errs[key] = diff.max().item()
                if length == 0:
                    check(not out.any(), f"K7 {key}: length 0 does not give 0")
                    shares[key] = 0.0
                    continue
                tol = dec.chunked_tolerance(q, cache.kv, cache.scale, length, ref,
                                            mask_row=mask)
                share = torch.where(diff == 0, 0.0, diff / tol).max().item()
                shares[key] = share
                check(math.isfinite(share) and share <= 1.0,
                      f"K7 {key}: an element is {share} of its bound (max abs err "
                      f"{diff.max().item()})")
                again = dec.decode_attend_chunked(q, cache, length, blk=blk, mask_row=mask)
                torch.cuda.synchronize()
                check(torch.equal(out, again), f"K7 {key}: two runs differ")
            # one kernel a call: no scratch fill, no combine kernel (four calls
            # profiled: every kernel seen is K7's, and no more than four)
            names = launched_kernels(
                torch, lambda: dec.decode_attend_chunked(q, cache, S // 2 + 5, blk=blk,
                                                         mask_row=row))
            check(0 < len(names) <= 4 and all("chunked_split_kernel" in n for n in names),
                  f"K7 {name}/{dt}: four calls ran {names}")
            # times over the whole cache: K7, K2 (the same cluster split) on the
            # same inputs, the plain version, SDPA on the dequantized cache
            kd, vd = (t.contiguous() for t in cache.read_kv(dtype=qdt))
            saved_k2 = dec.launches
            k7 = median_ms(lambda: dec.decode_attend_chunked(q, cache, S, blk=blk), 30, flush)
            k2 = median_ms(lambda: dec.decode_attend(q, cache, S), 30, flush)
            dec.launches = saved_k2
            plain = median_ms(lambda: dec.decode_attend_chunked_plain(
                q, cache.kv, cache.scale, S, blk=blk), 5, flush)
            sdpa = lambda: F.scaled_dot_product_attention(q, kd, vd)  # noqa: E731
            lib = median_ms(sdpa, 30, flush)
            bound, by_what, ops, nbytes = chunked_bounds(b, h, d, S, cache.kv.element_size(),
                                                         q.element_size(),
                                                         cache.scale is not None)
            timing[f"{name}/{dt}"] = {"ms": k7, "k2_ms": k2, "plain_ms": plain,
                                      "library_ms": lib, "bound_ms": bound, "bound_by": by_what,
                                      "flops": ops, "bytes": nbytes,
                                      "roofline_share": bound / k7, "blk": blk,
                                      "plan": dec.decode_plan(b, h, S, d, dtype, sm_count,
                                                              blk=blk)._asdict(),
                                      "library_kernels": sdpa_kernels(torch, sdpa)}
            del cache, kd, vd
    dec.chunked_launches = saved
    by = {dt: max(v for key, v in errs.items() if f"/{dt}/" in key)
          for dt in ("float32", "bfloat16", "int8")}
    worst = {dt: max(v for key, v in shares.items() if f"/{dt}/" in key)
             for dt in ("float32", "bfloat16", "int8")}
    emit("chunked_kernel", kernel="decode_attend_chunked", cases=n_cases,
         tolerance="decode_attention.chunked_tolerance, per element", max_abs_err=by,
         worst_share_of_bound=worst, kernels_per_call=1, deterministic=True)
    emit("chunked_kernel_timing", length="S (the whole cache)",
         library="torch.nn.functional.scaled_dot_product_attention on the dequantized "
                 "(b,h,S,d) cache; k2_ms: decode_attend (K2) on the same inputs",
         card=card, by_case=timing, seconds=time.perf_counter() - t_phase)
    return errs, timing


# ---------------------------------------------------------------------------
# K6 and the sequence-parallel (ring) training path
# ---------------------------------------------------------------------------

K6_TOL = {"o_dq_dk_dv": "f32 route: chunk_attention.kernel_tolerance: 2e-5*max(1,max|want|), "
                        "per element (f32 outputs)",
          "o_dq_dk_dv_bf16": "tensor-core route against the plain versions with "
                             "operands='bf16': chunk_attention.tc_kernel_tolerance: "
                             "2^-7*rounding_bound + kernel_tolerance, per element",
          "cost_bf16": "tensor-core route against the TPU's f32 arithmetic (reported and "
                       "checked): chunk_attention.rounding_tolerance: 2^-8*rounding_bound + "
                       "kernel_tolerance, per element",
          "lse": "chunk_attention.lse_tolerance: 1e-5*max(1,|want|), per element"}
# K6's launch counters: every launch, then those of the tensor-core route
K6_COUNTERS = ("fwd_launches", "dq_launches", "dkv_launches",
               "tc_fwd_launches", "tc_dq_launches", "tc_dkv_launches")
LS_TEXT, LS_FMAP, LS_N = 257, 64, 4352       # the long-sequence model's layout


def k6_counts(ca):
    return tuple(getattr(ca, c) for c in K6_COUNTERS)


def k6_set_counts(ca, counts):
    for c, x in zip(K6_COUNTERS, counts):
        setattr(ca, c, x)


def k6_tc_build(torch):
    """K6's tensor-core kernels as nvcc reported them (registers, spills
    per instance) and their tiles and shared memory per CTA: K4's design
    and formulas (csrc/chunk_attention.cu tc_*_smem ≡ flash_attention.cu's)."""
    row = k4_tc_build(torch)
    row["ptxas"] = ptxas_report("chunk_attention", "tc_") or "no build log in this process"
    return row


def k6_bounds(b, h, vis, d, itemsize):
    """Least card time of K6's three functions on one pair whose (cq, ck)
    visibility is ``vis`` (the same for every row of b and head of h):
    {"fwd"|"dq"|"dkv": (bound ms, "bytes"|"operations", flops, bytes)}.
    Operations count the visible (query, key) pairs at the bf16 tensor
    rate, K4's convention: 4·d flops a pair forward, 6·d dq, 8·d dk/dv.
    Bytes count each input that some visible pair needs read once (the q
    and dO rows, lse and delta entries of rows that see a key; the k and v
    rows of keys that some row sees) and each output written once (all of
    o and lse; dq; dk and dv, f32): a pair with nothing visible needs only
    its outputs written."""
    cq, ck = vis.shape
    pairs = b * h * int(vis.sum())
    rows, cols = int(vis.any(1).sum()), int(vis.any(0).sum())
    q_in, kv_in = b * h * rows * d * itemsize, 2 * b * h * cols * d * itemsize
    stats_in = 2 * b * h * rows * 4                    # lse and delta
    o_out, dkv_out = b * h * cq * d * 4, 2 * b * h * ck * d * 4
    work = {"fwd": (4 * d * pairs, q_in + kv_in + o_out + b * h * cq * 4),
            "dq": (6 * d * pairs, 2 * q_in + kv_in + stats_in + o_out),
            "dkv": (8 * d * pairs, 2 * q_in + kv_in + stats_in + dkv_out)}
    res = {}
    for k, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        res[k] = (max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
                  ops, nbytes)
    return res


def _k6_cases():
    """(name, b, h, c, d, q_off, k_off, n_valid, causal, spec, q scale): the
    card tests' cases (tests/test_torch_cuda.py)."""
    ax = lambda axis: ("axial", LS_TEXT, LS_FMAP, axis)  # noqa: E731
    return [("slice_diagonal", 2, 8, 1088, 64, 1088, 1088, LS_N, True, None, 1.0),
            ("slice_before", 2, 8, 1088, 64, 3264, 0, LS_N, True, None, 1.0),
            ("slice_future", 2, 8, 1088, 64, 0, 3264, LS_N, True, None, 1.0),
            ("peaked_diagonal", 2, 8, 1088, 64, 1088, 1088, LS_N, True, None, 8.0),
            ("ragged_cut", 2, 4, 544, 128, 1088, 544, 900, True, None, 1.0),
            ("axial_row", 2, 4, 544, 64, 1632, 1088, LS_N, True, ax(0), 1.0),
            ("axial_col", 2, 4, 544, 64, 1632, 544, LS_N, True, ax(1), 1.0),
            ("conv", 2, 4, 544, 64, 1632, 1088, LS_N, True, ("conv", LS_TEXT, LS_FMAP, 5, 1),
             1.0),
            ("non_causal", 1, 2, 300, 32, 0, 300, 600, False, None, 1.0)]


def phase_ring_kernel(torch, card):
    import torch.nn.functional as F
    from dalle_tpu_torch.ops import chunk_attention as ca
    from dalle_tpu_torch.ops import flash_attention as fl
    from dalle_tpu_torch.parallel import ring_attention as ra
    t_phase = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED + 13)
    errs, shares, costs, n_cases = {}, {}, {}, 0
    saved = k6_counts(ca)

    def all_three(q, k, v, do, q_off, k_off, kw):
        """The kernels, and the plain versions in the route's arithmetic
        (the TPU's f32 for f32 operands, the tensor cores' roundings for
        bf16); for bf16 also the f32 arithmetic and the rounding bound."""
        ops = "bf16" if q.dtype == torch.bfloat16 else "f32"
        before = k6_counts(ca)
        o, lse = ca.chunk_flash_fwd(q, k, v, q_off, k_off, **kw)
        ro, rlse = ca.chunk_flash_fwd_plain(q, k, v, q_off, k_off, operands=ops, **kw)
        args = (q, k, v, do, torch.where(rlse <= -5e8, 1e9, rlse),
                (do.float() * ro).sum(-1), q_off, k_off)
        got = {"o": o, "lse": lse, "dq": ca.chunk_flash_dq(*args, **kw)}
        got["dk"], got["dv"] = ca.chunk_flash_dkv(*args, **kw)
        want = {"o": ro, "lse": rlse, "dq": ca.chunk_flash_dq_plain(*args, operands=ops, **kw)}
        want["dk"], want["dv"] = ca.chunk_flash_dkv_plain(*args, operands=ops, **kw)
        torch.cuda.synchronize()
        tc = int(ops == "bf16")
        routed = tuple(a - b_ for a, b_ in zip(k6_counts(ca), before))
        check(routed == (1, 1, 1, tc, tc, tc), f"K6 {ops}: launches by route {routed}")
        if not tc:
            return got, want, None, None
        bound = ca.rounding_bound(*args, **kw)
        f32 = {"o": ca.chunk_flash_fwd_plain(q, k, v, q_off, k_off, **kw)[0],
               "dq": ca.chunk_flash_dq_plain(*args, **kw)}
        f32["dk"], f32["dv"] = ca.chunk_flash_dkv_plain(*args, **kw)
        return got, want, bound, f32

    def record(key, got, want, bound, f32):
        for out, g in got.items():
            w = want[out]
            if out == "lse":
                tol = ca.lse_tolerance(w)
            elif bound is not None:
                tol = ca.tc_kernel_tolerance(w, bound[out])
            else:
                tol = ca.kernel_tolerance(w)
            diff = (g - w).abs()
            share = (diff / tol).max().item()
            k = f"{out}/{key}"
            errs[k], shares[k] = diff.max().item(), share
            check(g.dtype == torch.float32 and math.isfinite(share) and share <= 1.0,
                  f"K6 {k}: an element is {share} of its bound (max abs err "
                  f"{diff.max().item()})")
            if bound is not None and out != "lse":
                # the cost of the route: against the TPU's f32 arithmetic on
                # the same inputs and backward statistics
                cost = ((g - f32[out]).abs()
                        / ca.rounding_tolerance(f32[out], bound[out])).max().item()
                costs[k] = cost
                check(math.isfinite(cost) and cost <= 1.0,
                      f"K6 bf16 {k} against the f32 arithmetic: {cost} of the rounding bound")

    for name, b, h, c, d, q_off, k_off, n_valid, causal, spec, mul in _k6_cases():
        kw = dict(scale=d ** -0.5, n_valid=n_valid, causal=causal, mask_spec=spec)
        for dt in ("float32", "bfloat16"):
            q, k, v, do = (torch.randn(b, h, c, d, device="cuda", generator=gen)
                           .to(getattr(torch, dt)) for _ in range(4))
            q = (q.float() * mul).to(q.dtype)
            got, want, bound, f32 = all_three(q, k, v, do, q_off, k_off, kw)
            n_cases += 1
            record(f"{name}/{dt}", got, want, bound, f32)
            if name == "slice_future":
                check(not got["o"].any() and bool((got["lse"] == -1e9).all())
                      and not any(got[x].any() for x in ("dq", "dk", "dv")),
                      "K6: a chunk wholly in the future did not give o = 0, lse = -1e9 and "
                      "zero gradients")
    # the zigzag ring's operands: sub-chunk views, no copies; the kernels on
    # them equal the kernels on contiguous copies bit for bit
    m = 544
    q2, k2, v2, do2 = (torch.randn(2, 4, 2 * m, 64, device="cuda", generator=gen).bfloat16()
                       for _ in range(4))
    views = [t[:, :, m:] for t in (q2, k2, v2, do2)]
    zkw = dict(scale=0.125, n_valid=LS_N, causal=True, mask_spec=("axial", LS_TEXT, LS_FMAP, 0))
    got, want, bound, f32 = all_three(*views, 2176, 1632, zkw)
    copied, _, _, _ = all_three(*(t.contiguous() for t in views), 2176, 1632, zkw)
    check(all(torch.equal(got[x], copied[x]) for x in got),
          "K6: the zigzag views and their contiguous copies gave other bits")
    n_cases += 1
    record("zigzag_views/bfloat16", got, want, bound, f32)
    k6_set_counts(ca, saved)
    by = {f"{out}/{dt}": max(v for key, v in errs.items()
                             if key.startswith(out + "/") and key.endswith("/" + dt))
          for out in ("o", "lse", "dq", "dk", "dv") for dt in ("float32", "bfloat16")}
    worst = {f"{out}/{dt}": max(v for key, v in shares.items()
                                if key.startswith(out + "/") and key.endswith("/" + dt))
             for out in ("o", "lse", "dq", "dk", "dv") for dt in ("float32", "bfloat16")}
    cost = {out: max(v for key, v in costs.items() if key.startswith(out + "/"))
            for out in ("o", "dq", "dk", "dv")}
    emit("ring_kernel", kernels=["chunk_attention_fwd", "chunk_attention_dq",
                                 "chunk_attention_dkv"],
         routes={"float32": "fwd_kernel, dq_kernel, dkv_kernel (f32 FMA)",
                 "bfloat16": "tc_fwd_kernel, tc_dq_kernel, tc_dkv_kernel (tensor cores)"},
         cases=n_cases, tolerance=K6_TOL, max_abs_err=by, worst_share_of_bound=worst,
         bf16_worst_share_of_rounding_bound_against_f32=cost,
         bf16_share_of_rounding_bound_by_case=costs, tc_build=k6_tc_build(torch))

    # times in bf16 at the slice's pair (zigzag sub-chunks of 1,088 rows at
    # sp=2) on the diagonal, wholly before and wholly in the future
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    timing = {}
    b, h, c, d = 2, 8, 1088, 64
    q, k, v, do = (torch.randn(b, h, c, d, device="cuda", generator=gen).bfloat16()
                   for _ in range(4))
    for name, q_off, k_off in (("diagonal", 1088, 1088), ("before", 3264, 0),
                               ("future", 0, 3264)):
        kw = dict(scale=d ** -0.5, n_valid=LS_N, causal=True)
        o, lse = ca.chunk_flash_fwd(q, k, v, q_off, k_off, **kw)
        lse = torch.where(lse <= -5e8, 1e9, lse)
        delta = (do.float() * o).sum(-1)
        args = (q, k, v, do, lse, delta, q_off, k_off)
        saved = k6_counts(ca)

        def kernels(q, k, v, do, iters):
            a = (q, k, v, do, lse, delta, q_off, k_off)
            return {"fwd": median_ms(lambda: ca.chunk_flash_fwd(q, k, v, q_off, k_off, **kw),
                                     iters, flush),
                    "dq": median_ms(lambda: ca.chunk_flash_dq(*a, **kw), iters, flush),
                    "dkv": median_ms(lambda: ca.chunk_flash_dkv(*a, **kw), iters, flush)}
        ms = kernels(q, k, v, do, 20)
        # the f32 route (f32 FMA on the CUDA cores, the first design) on the
        # same values, same call
        f32_ms = kernels(*(t.float() for t in (q, k, v, do)), 10)
        k6_set_counts(ca, saved)
        plain = {"fwd": median_ms(lambda: ca.chunk_flash_fwd_plain(q, k, v, q_off, k_off,
                                                                   operands="bf16", **kw),
                                  5, flush),
                 "dq": median_ms(lambda: ca.chunk_flash_dq_plain(*args, operands="bf16", **kw),
                                 5, flush),
                 "dkv": median_ms(lambda: ca.chunk_flash_dkv_plain(*args, operands="bf16", **kw),
                                  5, flush)}
        # the library yardstick: SDPA with the pair's boolean mask, forward,
        # and its backward alone for dq and dk/dv
        vis = ca.chunk_visible(c, c, q_off, k_off, n_valid=LS_N, device="cuda")
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        with torch.no_grad():
            lib_fwd = median_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=vis),
                                20, flush)
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=vis)
        lib_bwd = median_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True),
                            20, flush)
        del ol
        pairs = b * h * int(vis.sum())
        bounds = k6_bounds(b, h, vis, d, 2)
        row = {"q_off": q_off, "k_off": k_off, "visible_pairs": pairs}
        for w in ("fwd", "dq", "dkv"):
            bound, by_what, ops, nbytes = bounds[w]
            row[w] = {"ms": ms[w], "plain_ms": plain[w],
                      "library_ms": lib_fwd if w == "fwd" else lib_bwd,
                      "bound_ms": bound, "bound_by": by_what, "flops": ops, "bytes": nbytes,
                      "roofline_share": bound / ms[w], "f32_route_ms": f32_ms[w]}
        timing[name] = row

    # the whole ring at the layer (b=2, h=8, n=4,352, d=64, bf16, P=2, zigzag,
    # 16 launches of each kernel) against K4 and SDPA on the whole sequence,
    # forward and forward + backward
    q, k, v, do = (torch.randn(b, h, LS_N, d, device="cuda", generator=gen).bfloat16()
                   for _ in range(4))
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    sched = fl.flash_schedule(LS_N, device="cuda")
    fns = {"ring_k6": lambda a, b_, c_: ra.ring_attention(a, b_, c_, nper=2, zigzag=True,
                                                          kernel=True),
           "k4": lambda a, b_, c_: fl.flash_attention(a, b_, c_, schedule=sched),
           "sdpa": lambda a, b_, c_: F.scaled_dot_product_attention(a, b_, c_, is_causal=True)}
    saved = k6_counts(ca) + k4_counts(fl)
    layer = {}
    for name, fn in fns.items():
        with torch.no_grad():
            fwd = median_ms(lambda: fn(q, k, v), 10, flush)
        both = median_ms(lambda: torch.autograd.grad(fn(ql, kl, vl), (ql, kl, vl), do), 10, flush)
        layer[name] = {"fwd_ms": fwd, "fwd_bwd_ms": both}
    k6_set_counts(ca, saved[:len(K6_COUNTERS)])
    k4_set_counts(fl, saved[len(K6_COUNTERS):])
    emit("ring_kernel_timing", dtype="bfloat16", route="tensor cores (f32_route_ms: the same "
         "values as f32 through the f32 route)", pair=dict(b=b, h=h, c=c, d=d, n_valid=LS_N),
         library="torch.nn.functional.scaled_dot_product_attention with the pair's boolean "
                 "mask, forward, and its backward alone for dq and dk/dv",
         by_case=timing, layer=dict(shape=dict(b=b, h=h, n=LS_N, d=d), nper=2, zigzag=True,
                                    by_path=layer),
         card=card, seconds=time.perf_counter() - t_phase)
    return errs, timing


def phase_ring_parity(torch):
    from dalle_tpu_torch import (DalleTrainer, MeshConfig, OptimConfig, PrecisionConfig,
                                 TrainConfig)
    from dalle_tpu_torch.ops import chunk_attention as ca
    from dalle_tpu_torch.parallel import ring_attention as ra
    t_phase = time.perf_counter()
    cfg = longseq_config(depth=2)
    text, img = _train_batch(cfg, 1, SMOKE_SEED + 14)
    text = torch.from_numpy(text).cuda()
    img = torch.from_numpy(img).cuda()

    def counts():
        return ca.fwd_launches, ca.dq_launches, ca.dkv_launches

    names = ("chunk_flash_fwd", "chunk_flash_dq", "chunk_flash_dkv")
    plains = (ca.chunk_flash_fwd_plain, ca.chunk_flash_dq_plain, ca.chunk_flash_dkv_plain)
    kernels = [getattr(ra, nm) for nm in names]
    use_kernel = ra._use_kernel
    rows = {}
    for sp in (2, 4):
        tc = TrainConfig(batch_size=1, seed=SMOKE_SEED + 14, mesh=MeshConfig(sp=sp),
                         optim=OptimConfig(learning_rate=3e-4, grad_clip_norm=0.5),
                         precision=PrecisionConfig(compute="float32"))
        tr = DalleTrainer(cfg, tc)
        check(tr.model.transformer.attention_mode(torch.device("cuda")) == "ring",
              f"sp={sp} does not route attention through the ring")

        def grads():
            tr.optimizer.zero_grad()
            before = counts()
            loss, _ = tr.loss_and_backward(text, img)
            torch.cuda.synchronize()
            launched = tuple(a - b for a, b in zip(counts(), before))
            return loss.item(), {n: p.grad.clone() for n, p in tr.model.named_parameters()}, \
                launched

        loss_k, g_k, launched_k = grads()
        try:
            for nm, fn in zip(names, plains):
                setattr(ra, nm, fn)
            loss_p, g_p, launched_p = grads()
            ra._use_kernel = lambda *a: False           # the dense ring body
            loss_d, g_d, launched_d = grads()
        finally:
            for nm, fn in zip(names, kernels):
                setattr(ra, nm, fn)
            ra._use_kernel = use_kernel
        per_layer = 4 * sp * sp
        want = (2 * per_layer * cfg.depth, per_layer * cfg.depth, per_layer * cfg.depth)
        check(launched_k == want, f"sp={sp}: the kernel step launched K6 {launched_k}, "
                                  f"expected {want}")
        check(launched_p == (0, 0, 0) and launched_d == (0, 0, 0),
              f"sp={sp}: the plain and dense steps launched K6 {launched_p} {launched_d}")
        # f32 compute, the same inputs, f32 arithmetic on every side: summation
        # order only, 1e-5 of the loss and 1e-4 of each tensor's largest
        # gradient
        row = {"loss_kernel": loss_k, "launches_kernel_step": dict(zip(names, launched_k))}
        for other, loss_o, g_o in (("plain", loss_p, g_p), ("dense_body", loss_d, g_d)):
            worst, worst_name = 0.0, ""
            for name, go in g_o.items():
                share = (g_k[name] - go).abs().max().item() / max(go.abs().max().item(), 1e-30)
                if share > worst or not math.isfinite(share):
                    worst, worst_name = share, name
            loss_err = abs(loss_k - loss_o) / abs(loss_o)
            check(math.isfinite(loss_k) and loss_err <= 1e-5,
                  f"sp={sp}: loss {loss_k} vs {other} {loss_o}")
            check(worst <= 1e-4, f"sp={sp}: gradient of {worst_name} vs {other}: {worst} of "
                                 "its largest entry")
            row[other] = dict(loss=loss_o, loss_rel_err=loss_err, worst_grad_err_share=worst,
                              worst_grad_tensor=worst_name)
        rows[f"sp{sp}"] = row
        del tr, g_k, g_p, g_d
        torch.cuda.empty_cache()
    emit("ring_parity", config="longseq (scripts/bench_sweep.py)", depth=cfg.depth,
         dim=cfg.dim, heads=cfg.heads, seq=cfg.total_seq_len, batch=1, compute="float32",
         by_sp=rows, tolerance=dict(loss_rel=1e-5, grad_share_of_largest=1e-4),
         seconds=time.perf_counter() - t_phase)


def phase_train_ring(torch, card, k4_row):
    from dalle_tpu_torch import DalleTrainer, MeshConfig, OptimConfig, TrainConfig
    from dalle_tpu_torch.ops import chunk_attention as ca
    from dalle_tpu_torch.ops import flash_attention as fl
    from dalle_tpu_torch.ops import fused_attention as fa
    from dalle_tpu_torch.ops import persistent_attention as pa
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = longseq_config()
    b, steps, sp = 2, 6, 2
    # phase train_long's recipe and seed with sp=2: step 1 sees the same
    # weights and batch
    tc = TrainConfig(batch_size=b, seed=SMOKE_SEED, mesh=MeshConfig(sp=sp),
                     optim=OptimConfig(optimizer="adam", learning_rate=3e-4, grad_clip_norm=0.5))
    tr = DalleTrainer(cfg, tc)
    check(tr.model.transformer.attention_mode(torch.device("cuda")) == "ring",
          "sp=2 does not route attention through the ring")
    text, img = _train_batch(cfg, b, SMOKE_SEED)
    text = torch.from_numpy(text).cuda()
    img = torch.from_numpy(img).cuda()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    # the sequence-parallel training path starts here
    k6_set_counts(ca, (0,) * len(K6_COUNTERS))
    k4_set_counts(fl, (0,) * len(K4_COUNTERS))
    fa.fwd_launches = fa.bwd_launches = 0
    pa.fwd_launches = pa.bwd_launches = 0
    for _ in range(steps):
        t0 = time.perf_counter()
        m = tr.train_step(text, img)               # ends in a host read of the metrics
        walls.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    launches = {"chunk_flash_fwd": ca.fwd_launches, "chunk_flash_dq": ca.dq_launches,
                "chunk_flash_dkv": ca.dkv_launches}
    tc_launches = {"chunk_flash_fwd": ca.tc_fwd_launches, "chunk_flash_dq": ca.tc_dq_launches,
                   "chunk_flash_dkv": ca.tc_dkv_launches}
    others = {"k4": (fl.fwd_launches, fl.bwd_dq_launches, fl.bwd_dkv_launches),
              "k1": (fa.fwd_launches, fa.bwd_launches), "k8": (pa.fwd_launches, pa.bwd_launches)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over {steps} steps: {losses}")
    per_layer = 4 * sp * sp
    want = {"chunk_flash_fwd": 2 * per_layer * cfg.depth * steps,    # remat recomputes it
            "chunk_flash_dq": per_layer * cfg.depth * steps,
            "chunk_flash_dkv": per_layer * cfg.depth * steps}
    check(launches == want, f"K6 launched {launches} in {steps} steps, expected {want}")
    check(tc_launches == want, f"K6's tensor-core route took {tc_launches} of {want} launches")
    check(all(not any(v) for v in others.values()),
          f"K4, K1 or K8 launched on the ring path: {others}")
    # the same bf16 step through the ring and through K4: both on the
    # tensor cores, rounding p and dS to bf16 at the same points, the
    # roundings around attention the same; sums in another order
    rel = abs(losses[0] - k4_row["losses"][0]) / abs(k4_row["losses"][0])
    check(rel <= 1e-2, f"step-1 loss through the ring {losses[0]} vs K4 {k4_row['losses'][0]}")
    ms = statistics.median(walls[1:]) * 1e3
    tokens = b * cfg.total_seq_len
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.train_step(text, img)
        wall = time.perf_counter() - t0
    k6_set_counts(ca, (*launches.values(), *tc_launches.values()))
    dev_us, by_kernel = device_time(torch, prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    row = dict(config="longseq (scripts/bench_sweep.py)", seq=cfg.total_seq_len, batch=b,
               sp=sp, steps=steps, use_remat=cfg.use_remat, compute=tc.precision.compute,
               losses=losses, grad_norm_last=m["grad_norm"],
               ms_per_step_first=walls[0] * 1e3, ms_per_step=ms,
               tokens_per_s=tokens / ms * 1e3,
               model_tflops_per_s=tr.flops_per_step / ms / 1e9, peak_gib=peak,
               launches=launches, tc_launches=tc_launches, other_launches=others,
               device_ms_profiled_step=dev_us / 1e3 if dev_us else "not measured",
               device_busy_share=(dev_us / 1e3) / ms if dev_us else "not measured",
               wall_ms_profiled=wall * 1e3, top_device_ms={k: v / 1e3 for k, v in top},
               k4_step=dict(ms_per_step=k4_row["ms_per_step"],
                            tokens_per_s=k4_row["tokens_per_s"], peak_gib=k4_row["peak_gib"],
                            loss_step1=k4_row["losses"][0]),
               loss_step1_rel_to_k4=rel, tolerance=dict(loss_step1_rel=1e-2),
               card=card, seconds=time.perf_counter() - t_phase)
    emit("train_ring", **row)
    del tr
    torch.cuda.empty_cache()
    return launches, row


# ---------------------------------------------------------------------------
# The command-line flow: tokenizer, dVAE encoder, checkpoints, entry points
# ---------------------------------------------------------------------------

CLI_DEPTH = 2      # a whole-train-state checkpoint at depth 24 is ~17 GB a save


def phase_cli(torch, card):
    import os
    import shutil

    from dalle_tpu_torch.cli import generate, train_dalle
    from dalle_tpu_torch.cli._common import load_vae_sidecar, read_png, to_uint8
    from dalle_tpu_torch.config import DalleConfig, TrainConfig
    from dalle_tpu_torch.data.synthetic import ShapesDataset
    from dalle_tpu_torch.models.dalle import DALLE
    from dalle_tpu_torch.models.wrapper import DalleWithVae
    from dalle_tpu_torch.ops import decode_attention as dec
    from dalle_tpu_torch.ops import fused_attention as fa
    from dalle_tpu_torch.text.tokenizer import SimpleTokenizer
    from dalle_tpu_torch.train.checkpoints import STATE_FILE, CheckpointManager
    from dalle_tpu_torch.train.trainer_dalle import DalleTrainer

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tok = SimpleTokenizer()                  # builds the native core (g++) if needed
    tok_load_s = time.perf_counter() - t0
    check(tok.core == "native", f"the tokenizer runs the {tok.core} core")
    check(tok.vocab_size == 49408, f"vocab {tok.vocab_size} != 49408")
    shapes = ShapesDataset(32)
    captions = [shapes[i].caption for i in range(len(shapes))]
    t0 = time.perf_counter()
    tok.tokenize(captions, 256)              # cold: every word through the merge core
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok.tokenize(captions, 256)              # warm: the word cache
    warm = time.perf_counter() - t0
    emit("cli_tokenizer", core=tok.core, vocab=tok.vocab_size, load_s=tok_load_s,
         prompts=len(captions), us_per_prompt_cold=cold * 1e6 / len(captions),
         us_per_prompt_warm=warm * 1e6 / len(captions), card=card)

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli_smoke")
    shutil.rmtree(work, ignore_errors=True)
    ckpt, outs = os.path.join(work, "ckpt"), os.path.join(work, "outputs")
    argv = ["--synthetic", "--image_size", "128", "--untrained_vae",
            "--untrained_vae_tokens", "8192", "--untrained_vae_layers", "3",
            "--dim", "1792", "--depth", str(CLI_DEPTH), "--heads", "14",
            "--dim_head", "128", "--text_seq_len", "256", "--batch_size", "8",
            "--keep_n_checkpoints", "1", "--output_dir", ckpt, "--seed", str(SMOKE_SEED)]
    try:
        # -- train 3 steps ----------------------------------------------------
        fa.fwd_launches = fa.bwd_launches = 0        # the CLI's training path
        t0 = time.perf_counter()
        rc = train_dalle.main(argv + ["--steps", "3"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = {"fused_attention_fwd": fa.fwd_launches,
                          "fused_attention_bwd": fa.bwd_launches}
        check(rc == 0, f"train_dalle returned {rc}")
        for name, n in train_launches.items():
            check(n >= 3 * CLI_DEPTH, f"train_dalle: {name} launched {n} times in 3 steps")
        mgr = CheckpointManager(ckpt)
        names = sorted(os.listdir(ckpt))
        check(mgr.all_steps() == [3], f"checkpoint steps {mgr.all_steps()} != [3]")
        check(not any(".tmp-" in n for n in names), f"tmp directories left: {names}")
        meta = mgr.load_metadata()
        check(meta["model_class"] == "DALLE" and meta["hparams"]["dim"] == 1792
              and meta["vae_class_name"] == "DiscreteVAEAdapter",
              f"checkpoint metadata: {sorted(meta)}")

        # -- the checkpoint: restore into a fresh trainer, bit for bit ---------
        saved = torch.load(os.path.join(mgr.step_dir(3), STATE_FILE),
                           map_location="cuda", weights_only=True)
        file_bytes = os.path.getsize(os.path.join(mgr.step_dir(3), STATE_FILE))
        tr = DalleTrainer(DalleConfig.from_dict(meta["hparams"]),
                          TrainConfig.from_dict({**meta["train"], "checkpoint_dir": ckpt}),
                          device="cuda")
        n_params = tr.num_params
        with torch.device("meta"):
            full = DALLE(DalleConfig.from_dict({**meta["hparams"], "depth": 24}))
        n_params24 = sum(p.numel() for p in full.parameters())
        reckoned = n_params * (4 + 4 + 4)           # f32 masters + Adam's two moments
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(tr.step == 3, f"restored step {tr.step} != 3")
        for name, p in tr.model.state_dict().items():
            check(torch.equal(p, saved["model"][name]), f"restored {name} differs")
        opt = tr.optimizer.state_dict()
        check_same_tree(torch, opt, saved["optimizer"], "restored optimizer")
        probe = CheckpointManager(os.path.join(work, "save_probe"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probe.save(tr.step, tr.state_dict(), tr._meta())
        save_s = time.perf_counter() - t0
        shutil.rmtree(probe.directory)
        del tr, saved, opt
        torch.cuda.empty_cache()
        emit("cli_checkpoint", params=n_params, depth=CLI_DEPTH,
             bytes_reckoned=reckoned, bytes_file=file_bytes,
             params_depth24=n_params24, bytes_reckoned_depth24=n_params24 * 12,
             save_s=save_s,
             save_gb_per_s=file_bytes / save_s / 1e9, restore_s=restore_s,
             restore_gb_per_s=file_bytes / restore_s / 1e9, card=card)

        # -- resume for one step more ------------------------------------------
        fa.fwd_launches = fa.bwd_launches = 0
        t0 = time.perf_counter()
        rc = train_dalle.main(argv + ["--steps", "4", "--resume"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resume_launches = {"fused_attention_fwd": fa.fwd_launches,
                           "fused_attention_bwd": fa.bwd_launches}
        check(rc == 0, f"train_dalle --resume returned {rc}")
        check(mgr.all_steps() == [4], f"after --resume: steps {mgr.all_steps()} != [4]")
        for name, n in resume_launches.items():
            check(n >= CLI_DEPTH, f"train_dalle --resume: {name} launched {n} times")
        torch.cuda.empty_cache()

        # -- generate -----------------------------------------------------------
        prompts = ["a red circle", "a blue square"]
        gen_argv = ["--dalle_path", ckpt, "--text", "|".join(prompts), "--num_images", "8",
                    "--batch_size", "8", "--bf16", "--outputs_dir", outs,
                    "--seed", str(SMOKE_SEED)]
        dec.launches = 0                             # the CLI's generation path
        t0 = time.perf_counter()
        rc = generate.main(gen_argv)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t0
        gen_launches = dec.launches
        check(rc == 0, f"generate returned {rc}")
        per_batch = CLI_DEPTH * 255
        check(gen_launches == 2 * per_batch,
              f"generate: K2 launched {gen_launches} times, expected {2 * per_batch}")
        pngs = sorted(os.path.join(r, f) for r, _, fs in os.walk(outs)
                      for f in fs if f.endswith(".png"))
        check(len(pngs) == 16, f"{len(pngs)} PNGs, expected 16")

        # the same images in process, with the same seed and weights
        t0 = time.perf_counter()
        model, _ = generate.load_dalle(ckpt, "cuda")   # what generate.main loads
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        wrapper = DalleWithVae(model, load_vae_sidecar(ckpt, "cuda"))
        gen = torch.Generator("cuda").manual_seed(SMOKE_SEED)
        walls = []
        for prompt in prompts:
            text = tok.tokenize([prompt], 256, truncate_text=True)
            t0 = time.perf_counter()
            images = wrapper.generate_images(text.repeat(8, 1), generator=gen,
                                             filter_thres=0.9, precision="bfloat16")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            want = to_uint8(images)
            outdir = os.path.join(outs, prompt.replace(" ", "_"))
            for i in range(8):
                got = read_png(os.path.join(outdir, f"img_0_{i}.png"))
                check(got.shape == (128, 128, 3), f"PNG shape {got.shape}")
                check(bool((got == want[i]).all()),
                      f"{prompt!r} image {i}: the CLI's PNG differs from the "
                      "in-process generate_images")
        del model, wrapper
        torch.cuda.empty_cache()
        emit("cli", depth=CLI_DEPTH, train_wall_s=train_s, resume_wall_s=resume_s,
             generate_wall_s=generate_s, generate_load_s=load_s,
             generate_ms_per_image_token=[
                 w * 1e3 / 256 for w in walls], batch=8, precision="bfloat16",
             launches={"train": train_launches, "resume": resume_launches,
                       "generate": {"decode_attend": gen_launches}},
             seconds=time.perf_counter() - t_phase, card=card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"fused_attention_fwd": train_launches["fused_attention_fwd"],
            "fused_attention_bwd": train_launches["fused_attention_bwd"],
            "decode_attend": gen_launches}


# ---------------------------------------------------------------------------
# The paper's flow: dVAE → DALL·E → CLIP → reranked generation
# ---------------------------------------------------------------------------

PAPER_PROMPT = "a red circle"


def _attention_counts(fa, fl, dec):
    return {"fused_attention_fwd": fa.fwd_launches, "fused_attention_bwd": fa.bwd_launches,
            "flash_attention_fwd": fl.fwd_launches, "decode_attend": dec.launches}


def _zero_attention_counts(fa, fl, dec):
    fa.fwd_launches = fa.bwd_launches = fl.fwd_launches = dec.launches = 0


def _train_steps(torch, trainer, batches):
    """Step ``trainer`` through ``batches`` → (ms of each step, losses)."""
    ms, losses = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(*batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    return ms, losses


def _same_train_state(torch, trainer, saved, what):
    """The masters and the optimizer's whole state (moments, counts,
    accumulator, plateau, lr scale) equal ``saved``'s bit for bit."""
    for k, v in trainer.model.state_dict().items():
        check(torch.equal(v, saved["model"][k]), f"{what}: {k} differs")
    check_same_tree(torch, trainer.optimizer.state_dict(), saved["optimizer"],
                    f"{what}: optimizer")


def _nan_rollback(torch, card, work):
    """VAETrainer.fit over three batches, the second poisoned with a NaN,
    checkpointing every step: right after the NaN step the masters and the
    optimizer state equal step 1's checkpoint bit for bit, the run ends at
    step 3, no step 2 is written, and step 3 replayed from step 1's
    checkpoint (the step counter at 2) gives the same bits. cuDNN's
    deterministic algorithms hold the replay to the same sums."""
    import os

    import numpy as np

    from dalle_tpu_torch.config import DVAEConfig, OptimConfig, TrainConfig
    from dalle_tpu_torch.data.synthetic import ShapesDataset
    from dalle_tpu_torch.ops.sampling import gumbel_noise
    from dalle_tpu_torch.train.checkpoints import STATE_FILE, CheckpointManager
    from dalle_tpu_torch.train.trainer_vae import VAETrainer

    cfg = DVAEConfig()
    ckpt = os.path.join(work, "nan")
    # device_prefetch=0: the stream checks the state between its batches
    tc = TrainConfig(batch_size=8, seed=SMOKE_SEED, checkpoint_dir=ckpt, save_every_steps=1,
                     log_every=1, device_prefetch=0,
                     optim=OptimConfig(learning_rate=1e-3, lr_scheduler="exponential"))
    imgs = ShapesDataset(128).as_arrays(limit=24)[0].reshape(3, 8, 128, 128, 3)
    imgs[1, 0, 5, 7, 1] = np.nan
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED)
    noise = [gumbel_noise((8, 16, 16, cfg.num_tokens), generator=gen, device="cuda")
             for _ in range(3)]
    seen, lines = {}, []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tr = VAETrainer(cfg, tc, device="cuda")

        def batches():
            yield imgs[0], noise[0]
            yield imgs[1], noise[1]
            saved = torch.load(os.path.join(CheckpointManager(ckpt).step_dir(1), STATE_FILE),
                               map_location="cuda", weights_only=True)
            _same_train_state(torch, tr, saved, "after the NaN step")
            seen.update(step=tr.step, count=tr.optimizer.count)
            yield imgs[2], noise[2]
        tr.fit(batches(), log=lines.append)
        check(seen == {"step": 2, "count": 1}, f"after the NaN step: {seen}")
        check(tr.step == 3 and tr.optimizer.count == 2,
              f"ended at step {tr.step}, count {tr.optimizer.count}")
        steps = CheckpointManager(ckpt).all_steps()
        check(steps == [0, 1, 3], f"checkpoint steps {steps} != [0, 1, 3]")
        check(any(ln.startswith("[step 2] non-finite loss") for ln in lines)
              and not any(ln.startswith("[step 2] loss=") for ln in lines),
              f"the NaN step's log: {lines}")
        replay = VAETrainer(cfg, tc, device="cuda")
        replay.restore(step=1)
        replay.step = 2
        replay.train_step(imgs[2], noise[2])
        _same_train_state(torch, replay, tr.state_dict(), "step 3 replayed from step 1")
        snap = dict(tr.last_snapshot)
        del tr, replay
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    emit("paper_nan_rollback", snapshot_mode=snap["mode"], snapshot_bytes=snap["bytes"],
         snapshot_ms=snap["ms"], steps_saved=steps, card=card)
    return snap


def phase_paper(torch, card):
    """The paper's three models through their entry points, in one directory
    under build/: train_vae at the full-width dVAE (8,192 codes, codebook
    512, 3 layers, hidden 64, one ResBlock: the 16 × 16 grid of the 1.4B
    model), train_dalle --vae_path on its checkpoint at the 1.4B widths,
    depth 2, learning rate 1e-5, train_clip at the full-width CLIP (dim 512,
    depth 6, 8 heads, 256 text tokens) on 128 px with 16 px patches, and
    generate --clip_path --bf16 of 8 images, reranked. Then in process: the
    reranked images and scores against generate_images(clip=…), eight
    distinct images whose scores do not all tie, CLIP's time to score 8 images,
    10 timed steps each of the dVAE and CLIP trainers, the codes the
    trained dVAE uses, and NaN rollback."""
    import os
    import shutil

    import numpy as np

    from dalle_tpu_torch.cli import generate, train_clip, train_dalle, train_vae
    from dalle_tpu_torch.cli._common import load_vae_sidecar, read_png, to_uint8
    from dalle_tpu_torch.config import ClipConfig, DVAEConfig, OptimConfig, TrainConfig
    from dalle_tpu_torch.data.synthetic import ShapesDataset, batch_iterator
    from dalle_tpu_torch.models.wrapper import DalleWithVae, rerank_scores
    from dalle_tpu_torch.ops import decode_attention as dec
    from dalle_tpu_torch.ops import flash_attention as fl
    from dalle_tpu_torch.ops import fused_attention as fa
    from dalle_tpu_torch.text.tokenizer import SimpleTokenizer
    from dalle_tpu_torch.train.checkpoints import STATE_FILE, CheckpointManager, load_clip
    from dalle_tpu_torch.train.trainer_clip import CLIPTrainer
    from dalle_tpu_torch.train.trainer_vae import VAETrainer

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "paper_smoke")
    shutil.rmtree(work, ignore_errors=True)
    vae_dir, dalle_dir, clip_dir, outs, samples = (
        os.path.join(work, n) for n in ("vae", "dalle", "clip", "outputs", "samples"))
    seed = ["--seed", str(SMOKE_SEED)]
    walls, counts = {}, {}

    def run(name, main, argv):
        _zero_attention_counts(fa, fl, dec)
        t0 = time.perf_counter()
        rc = main(argv)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts[name] = _attention_counts(fa, fl, dec)
        check(rc == 0, f"{name} returned {rc}")

    try:
        run("train_vae", train_vae.main,
            ["--synthetic", "--batch_size", "8", "--steps", "30", "--sample_every_steps", "15",
             "--sample_dir", samples, "--output_dir", vae_dir] + seed)
        vae_mgr = CheckpointManager(vae_dir)
        check(vae_mgr.all_steps() == [0, 30], f"train_vae steps {vae_mgr.all_steps()}")
        check(sorted(os.listdir(samples)) == ["step15_recon.png", "step30_recon.png"],
              f"train_vae samples {sorted(os.listdir(samples))}")
        check(read_png(os.path.join(samples, "step30_recon.png")).shape == (256, 1024, 3),
              "the reconstruction grid is not 2 × 8 images of 128 px")

        # at the default learning rate (3e-4) two Adam steps on the dVAE's codes
        # (13 of 8,192 used after 30 steps) lift one code's logit so far that
        # every sampled token is that code: one image eight times, eight tied
        # scores, nothing for the rerank to order. At 1e-5 the samples differ.
        run("train_dalle", train_dalle.main,
            ["--synthetic", "--vae_path", vae_dir, "--dim", "1792", "--depth", str(CLI_DEPTH),
             "--heads", "14", "--dim_head", "128", "--text_seq_len", "256", "--batch_size",
             "8", "--steps", "2", "--learning_rate", "1e-5", "--no_preflight",
             "--output_dir", dalle_dir] + seed)
        for name in ("fused_attention_fwd", "fused_attention_bwd"):
            n = counts["train_dalle"][name]
            check(n >= 2 * CLI_DEPTH, f"train_dalle --vae_path: {name} launched {n} times")
        trained = vae_mgr.restore(map_location="cpu")[0]["model"]
        sidecar = torch.load(os.path.join(dalle_dir, "vae", "0", STATE_FILE),
                             map_location="cpu", weights_only=True)["model"]
        check(sidecar.keys() == trained.keys()
              and all(torch.equal(sidecar[k], v) for k, v in trained.items()),
              "the VAE sidecar differs from train_vae's last step")
        del trained, sidecar

        run("train_clip", train_clip.main,
            ["--synthetic", "--image_size", "128", "--patch_size", "16", "--batch_size", "8",
             "--steps", "5", "--output_dir", clip_dir] + seed)
        check(CheckpointManager(clip_dir).all_steps() == [0, 5], "train_clip steps")

        # the dVAE decoder's transposed convolutions may take a cuDNN algorithm
        # whose sums run in another order on each call: the CLI's scores are
        # held bit for bit to the in-process run's under deterministic ones
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        run("generate", generate.main,
            ["--dalle_path", dalle_dir, "--clip_path", clip_dir, "--bf16", "--text",
             PAPER_PROMPT, "--num_images", "8", "--batch_size", "8", "--outputs_dir", outs]
            + seed)
        check(counts["generate"]["decode_attend"] == CLI_DEPTH * 255,
              f"generate: K2 launched {counts['generate']['decode_attend']} times, "
              f"expected {CLI_DEPTH * 255}")
        for name in ("train_vae", "train_clip"):
            check(not any(counts[name].values()), f"{name} launched {counts[name]}")
        check(counts["generate"]["fused_attention_fwd"] == 0
              and counts["generate"]["flash_attention_fwd"] == 0,
              f"generate's CLIP launched {counts['generate']}")
        torch.cuda.empty_cache()

        # -- the rerank in process, with the same seed and weights ---------------
        model, _ = generate.load_dalle(dalle_dir, "cuda")
        clip, clip_meta = load_clip(clip_dir, "cuda")
        wrapper = DalleWithVae(model, load_vae_sidecar(dalle_dir, "cuda"), clip)
        text = SimpleTokenizer().tokenize([PAPER_PROMPT], 256, truncate_text=True).repeat(8, 1)
        images, scores = wrapper.generate_images(
            text, generator=torch.Generator("cuda").manual_seed(SMOKE_SEED), filter_thres=0.9,
            precision="bfloat16", clip=wrapper.clip)
        torch.backends.cudnn.deterministic = deterministic
        scores = scores.float().cpu().numpy()
        order = np.argsort(-scores, kind="stable")
        outdir = os.path.join(outs, PAPER_PROMPT.replace(" ", "_"))
        with open(os.path.join(outdir, "clip_scores.json")) as f:
            written = json.load(f)
        check(written == [float(scores[i]) for i in order],
              f"generate's scores {written} != in-process {scores[order].tolist()}")
        want = to_uint8(images.float().cpu()[torch.from_numpy(order)])
        for i in range(8):
            check(bool((read_png(os.path.join(outdir, f"img_{i}.png")) == want[i]).all()),
                  f"img_{i}.png is not the in-process image of rank {i}")
        check(np.all(np.isfinite(scores)), f"scores {scores}")
        flat = images.float().reshape(len(images), -1)
        distinct_images = int(torch.unique(flat, dim=0).shape[0])
        image_spread = float((flat - flat[:1]).abs().max())
        distinct_scores = len(set(scores.tolist()))
        check(distinct_images == 8 and distinct_scores > 1,
              f"the rerank has nothing to order: {distinct_images} distinct images, "
              f"{distinct_scores} distinct scores")

        _zero_attention_counts(fa, fl, dec)
        score_ms = median_ms(lambda: rerank_scores(clip, text, images), 20)
        check(not any(_attention_counts(fa, fl, dec).values()),
              f"CLIP's scoring launched {_attention_counts(fa, fl, dec)}")
        del model, wrapper, images
        torch.cuda.empty_cache()

        # -- the dVAE's and CLIP's steps, and the codes the trained dVAE uses -----
        probe = ShapesDataset(128).as_arrays(limit=8)[0]
        raw = batch_iterator(ShapesDataset(128), 8, seed=SMOKE_SEED)
        vae_tc = TrainConfig(batch_size=8, seed=SMOKE_SEED, checkpoint_dir=vae_dir,
                             optim=OptimConfig(learning_rate=1e-3, grad_clip_norm=0.0,
                                               lr_scheduler="exponential"))
        vtr = VAETrainer(DVAEConfig(), vae_tc, device="cuda")
        vtr.restore()
        codes_used = int((vtr.codebook_histogram(probe) > 0).sum())
        vtr = VAETrainer(DVAEConfig(), vae_tc, device="cuda")
        vae_ms, vae_losses = _train_steps(torch, vtr, [(next(raw)[0],) for _ in range(10)])
        del vtr
        tok = SimpleTokenizer()
        clip_cfg = ClipConfig(**clip_meta["hparams"])
        ctr = CLIPTrainer(clip_cfg, TrainConfig(batch_size=8, seed=SMOKE_SEED), device="cuda")
        _zero_attention_counts(fa, fl, dec)
        clip_ms, clip_losses = _train_steps(torch, ctr, [
            (tok.tokenize(caps, 256, truncate_text=True), imgs)
            for imgs, caps in (next(raw) for _ in range(10))])
        check(not any(_attention_counts(fa, fl, dec).values()),
              f"CLIP's steps launched {_attention_counts(fa, fl, dec)}")
        clip_params = ctr.num_params
        del ctr
        torch.cuda.empty_cache()
        for name, losses in (("dVAE", vae_losses), ("CLIP", clip_losses)):
            check(all(math.isfinite(x) for x in losses), f"{name} losses {losses}")

        snap = _nan_rollback(torch, card, work)
        emit("paper", depth=CLI_DEPTH, batch=8, prompt=PAPER_PROMPT,
             wall_s=walls, launches=counts,
             dvae_ms_per_step=statistics.median(vae_ms[1:]), dvae_first_ms=vae_ms[0],
             dvae_loss_first=vae_losses[0], dvae_loss_last=vae_losses[-1],
             dvae_codes_used=codes_used, dvae_codes=DVAEConfig().num_tokens,
             clip_ms_per_step=statistics.median(clip_ms[1:]), clip_first_ms=clip_ms[0],
             clip_loss_first=clip_losses[0], clip_loss_last=clip_losses[-1],
             clip_params=clip_params, clip_score_8_ms=score_ms,
             scores_best_first=[float(scores[i]) for i in order],
             distinct_images=distinct_images, image_spread=image_spread,
             distinct_scores=distinct_scores,
             snapshot=snap, seconds=time.perf_counter() - t_phase, card=card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"fused_attention_fwd": counts["train_dalle"]["fused_attention_fwd"],
            "fused_attention_bwd": counts["train_dalle"]["fused_attention_bwd"],
            "decode_attend": counts["generate"]["decode_attend"]}


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
    errs, timing = phase_kernel(torch, card)
    k1_errs, k1_timing = phase_train_kernel(torch, card)
    w_errs, w_timing = phase_serve_kernel(torch, card)
    k4_errs, k4_timing = phase_flash_kernel(torch, card)
    k8_errs, k8_timing = phase_persist_kernel(torch, card)
    k7_errs, k7_timing = phase_chunked_kernel(torch, card)
    k6_errs, k6_timing = phase_ring_kernel(torch, card)
    phase_decode_vs_forward(torch)
    phase_train_parity(torch)
    phase_serve_parity(torch)
    phase_flash_parity(torch)
    phase_persist_parity(torch)
    phase_ring_parity(torch)
    launches, gen_rows = phase_generate(torch, card)
    serve_launches, _ = phase_serve(torch, card)
    surface = phase_decode_surface(torch, card, gen_rows)
    k1_launches, k1_row = phase_train(torch, card)
    recipe_launches, _ = phase_recipe(torch, card, k1_row)
    k8_launches, _ = phase_train_persist(torch, card, k1_row)
    k4_launches, k4_row = phase_train_long(torch, card)
    k6_launches, k6_row = phase_train_ring(torch, card, k4_row)
    cli_launches = phase_cli(torch, card)
    paper_launches = phase_paper(torch, card)

    f32 = timing["float32"]
    kernels = [{
        "name": "decode_attend", "route": "cuda",
        "source": "dalle_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dalle_tpu/ops/decode_attention.py:94",
        "launches": launches, "launches_cli": cli_launches["decode_attend"],
        "launches_decode_surface": surface["launches"]["decode_attend"],
        "launches_paper": paper_launches["decode_attend"],
        "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs,
        "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
        "timed_at": "b=8 h=14 d=128 S=512 length=512, float32 cache",
        "kernel_functions": "decode_split_kernel",
        "design": "a cluster of nsplit CTAs per (b, h), a two-slot cp.async ring of "
                  "stages of up to 64 positions (decode_plan), rank-order merge through "
                  "distributed shared memory",
        "by_cache_dtype": timing, "tolerance": TOL,
    }]
    for which, name, line in (("fwd", "fused_attention_fwd", 218),
                              ("bwd", "fused_attention_bwd", 238)):
        t = k1_timing[which]
        mine = {k: v for k, v in k1_errs.items() if k.startswith(which + "/")}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dalle_tpu_torch/csrc/fused_attention.cu",
            "replaces": f"dalle_tpu/ops/fused_attention.py:{line}",
            "launches": k1_launches[name], "launches_recipe": recipe_launches[name],
            "launches_shift_step": surface["k1"][name],
            "launches_cli": cli_launches[name],
            "launches_paper": paper_launches[name],
            "max_abs_err": max(mine.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "timed_at": "b=8 n=512 h=14 d=128, bfloat16 qkv, causal",
            "kernel_functions": {"fwd": "fwd_kernel",
                                 "bwd": "dq_kernel then dkv_kernel"}[which],
            "design": "mma.sync m16n8k16, cp.async ring, two-pass softmax",
            "tolerance": K1_TOL,
        })
    # K3 and K5: the headline time is a decode step (w=1) over the int8
    # cache the serving path runs (bf16_int8kv); every case is beside it
    for name, kname, line, mode in (
            ("decode_attend_window", "K3", 232, "dense"),
            ("decode_attend_window_paged", "K5", 480, "paged")):
        t = w_timing["int8/w1"]
        mine = {k: v for k, v in w_errs.items() if k.startswith(kname + "/")}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dalle_tpu_torch/csrc/decode_window_attention.cu",
            "replaces": f"dalle_tpu/ops/decode_attention.py:{line}",
            "launches": serve_launches[mode][name],
            "launches_int8w_engine": surface["engine"][mode][name],
            "launches_speculative": (sum(v["k3_launches"] for v in surface["spec"].values())
                                     if kname == "K3" else 0),
            "max_abs_err": max(mine.values()),
            "speculative_ragged_cache_worst_share": (max(surface["k3_ragged"].values())
                                                     if kname == "K3" else None),
            "ms": t[f"{kname}_ms"],
            "plain_ms": t["plain_ms"] if kname == "K3" else t["K5_plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "timed_at": "b=8 h=14 d=128 S=512 w=1 starts=S-1, int8 cache, bf16 q",
            "plan": t["plan"],
            "launches_by_route": {k: v for k, v in serve_launches[mode].items()
                                  if k.startswith("window_")},
            "kernel_functions": {"tc": "tc_window_kernel (mma.sync, cp.async ring)",
                                 "split": "split_window_kernel (cluster of 2-8 CTAs)",
                                 "fma": "fma_window_kernel (f32 FMA)"},
            "by_case": {k: {"plan": v["plan"], "ms": v[f"{kname}_ms"],
                            "bound_ms": v["bound_ms"], "library_ms": v["library_ms"],
                            "plain_ms": v["plain_ms" if kname == "K3" else "K5_plain_ms"]}
                        for k, v in w_timing.items()},
            "tolerance": "decode_attention.window_tolerance, per element",
        })
    # K4: the headline time is the slice's full-causal layer in bf16 (the
    # tensor-core route); the axial layers and the DALL·E-1.4B shape are
    # beside it, and the f32 route on the same values
    for which, name, line in (("fwd", "flash_attention_fwd", 354),
                              ("dq", "flash_attention_bwd_dq", 404),
                              ("dkv", "flash_attention_bwd_dkv", 436)):
        t = k4_timing["slice/full"][which]
        outs = ("o", "lse") if which == "fwd" else (("dq",) if which == "dq" else ("dk", "dv"))
        mine = {k: v for k, v in k4_errs.items() if k.split("/")[0] in outs}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dalle_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"dalle_tpu/ops/flash_attention.py:{line}",
            "launches": k4_launches[name],
            "max_abs_err": max(mine.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "timed_at": "b=2 h=8 n=4352 d=64, bfloat16 (tensor-core route), full causal",
            "kernel_functions": {"bfloat16": f"tc_{which}_kernel (mma.sync, cp.async ring)",
                                 "float32": f"{which}_kernel (f32 FMA)"},
            "f32_route_ms": t["f32_route_ms"],
            "by_case": {k: {"ms": v[which]["ms"], "bound_ms": v[which]["bound_ms"],
                            "plain_ms": v[which]["plain_ms"],
                            "library_ms": v[which]["library_ms"],
                            "f32_route_ms": v[which]["f32_route_ms"]}
                        for k, v in k4_timing.items()},
            "tolerance": K4_TOL,
        })
    # K8: the headline time is the DALL·E-1.4B layer in bf16, causal; the
    # DALL·E-small layer and K1 on the same data are beside it
    for which, name, line in (("fwd", "persistent_attention_fwd", 121),
                              ("bwd", "persistent_attention_bwd", 142)):
        t = k8_timing["dalle1p4b"][which]
        outs = ("o",) if which == "fwd" else ("dq", "dk", "dv")
        mine = {k: v for k, v in k8_errs.items() if k.split("/")[0] in outs}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dalle_tpu_torch/csrc/persistent_attention.cu",
            "replaces": f"dalle_tpu/ops/persistent_attention.py:{line}",
            "launches": k8_launches[name],
            "max_abs_err": max(mine.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "timed_at": "b=8 h=14 n=512 d=128, bfloat16, causal"
                        + ("" if which == "fwd" else ", from the forward's (m, l)"),
            "kernel_functions": {"fwd": "fwd_kernel",
                                 "bwd": "dq_kernel then dkv_kernel"}[which],
            "design": "K1's: mma.sync m16n8k16, cp.async ring, two-pass softmax",
            "by_case": {k: {"ms": v[which]["ms"], "k1_ms": v[which]["k1_ms"],
                            "bound_ms": v[which]["bound_ms"],
                            "plain_ms": v[which]["plain_ms"],
                            "library_ms": v[which]["library_ms"]}
                        for k, v in k8_timing.items()},
            "tolerance": K8_TOL,
        })
    # K7: on no path (opt-in in both packages); phase chunked_kernel times it.
    # The headline is the JAX bench's d=128 shape over a bf16 cache
    t = k7_timing["b16_h14_S2560_d128/bfloat16"]
    kernels.append({
        "name": "decode_attend_chunked", "route": "cuda",
        "source": "dalle_tpu_torch/csrc/decode_chunked_attention.cu",
        "replaces": "dalle_tpu/ops/decode_attention.py:391",
        "launches": 0, "launches_note": "no path selects K7; timed in phase chunked_kernel",
        "max_abs_err": max(k7_errs.values()),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "timed_at": "b=16 h=14 S=2560 d=128 length=S blk=256, bfloat16 cache",
        "kernel_functions": "chunked_split_kernel (one kernel a call)",
        "design": "K2's cluster split; ranks of whole blocks, a slot pairs block i's K "
                  "with block i-1's V",
        "by_case": {k: {"ms": v["ms"], "k2_ms": v["k2_ms"], "bound_ms": v["bound_ms"],
                        "plain_ms": v["plain_ms"], "library_ms": v["library_ms"]}
                    for k, v in k7_timing.items()},
        "tolerance": "decode_attention.chunked_tolerance, per element",
    })
    # K6: the headline time is the slice's pair on the diagonal in bf16;
    # the pair wholly before and wholly in the future are beside it
    for which, name, line in (("fwd", "chunk_flash_fwd", 213),
                              ("dq", "chunk_flash_dq", 244),
                              ("dkv", "chunk_flash_dkv", 274)):
        t = k6_timing["diagonal"][which]
        outs = ("o", "lse") if which == "fwd" else (("dq",) if which == "dq" else ("dk", "dv"))
        mine = {k: v for k, v in k6_errs.items() if k.split("/")[0] in outs}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dalle_tpu_torch/csrc/chunk_attention.cu",
            "replaces": f"dalle_tpu/ops/chunk_attention.py:{line}",
            "launches": k6_launches[name],
            "max_abs_err": max(mine.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "timed_at": "b=2 h=8 c=1088 d=64, bfloat16 (tensor-core route), causal pair on "
                        "the diagonal",
            "launches_tensor_core_route": k6_row["tc_launches"][name],
            "kernel_functions": {"bfloat16": f"tc_{which}_kernel (mma.sync, cp.async ring)",
                                 "float32": f"{which}_kernel (f32 FMA)"},
            "f32_route_ms": t["f32_route_ms"],
            "by_case": {k: {"ms": v[which]["ms"], "bound_ms": v[which]["bound_ms"],
                            "plain_ms": v[which]["plain_ms"],
                            "library_ms": v[which]["library_ms"],
                            "f32_route_ms": v[which]["f32_route_ms"]}
                        for k, v in k6_timing.items()},
            "tolerance": K6_TOL,
        })
    # W8: port-only (QDense's int8 branch is an XLA fusion); the headline
    # is the decode step's w1 (M = 8), every QLinear shape beside it
    t = surface["w8_timing"]["w1/M8"]
    kernels.append({
        "name": "int8w_linear", "route": "cuda",
        "source": "dalle_tpu_torch/csrc/int8w_linear.cu",
        "replaces": "dalle_tpu/ops/quantize_weights.py:32 (QDense's int8 branch; an XLA "
                    "fusion, no pallas_call)",
        "launches": surface["launches"]["w8"]["launches"],
        "launches_by_route": surface["launches"]["w8"],
        "max_abs_err": surface["w8_err"], "worst_share_of_tolerance": surface["w8_share"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": "torch.matmul on the dequantized bf16 weight",
        "timed_at": "1.4B w1: x (8, 1792) bf16, q (14336, 1792) int8, bias",
        "kernel_functions": {"bfloat16": "tc_kernel<MT> (mma.sync, weights converted in "
                                         "registers)", "float32": "fma_kernel"},
        "by_case": surface["w8_timing"],
        "tolerance": "int8w_linear.int8w_tolerance, per element",
    })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
