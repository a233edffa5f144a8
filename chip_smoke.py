#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (dalle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases train,train_data    # env and these phases only

Phases, one JSON line each; any failure raises and exits non-zero. With
``--phases`` only env and the named ones run (a phase that compares with
another's row takes that row's recorded numbers when it did not run), the
kernels line is left out and the last line is the same:

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
                8 slots, bf16_int8kv, dense, then paged at depth 2 (full
                width, for the script's time), 16 requests (10 full,
                3 ragged, 1 CFG, a 2-member shared-prefix cohort; half of
                them from a producer thread while the engine runs), the paged
                run with 4 repeated prompts and one that shares 128 text
                tokens with another. Every request completes with in-range
                tokens of its length; K3 launches depth times per attending
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
                W8 (int8-weight product, csrc/int8w_linear.cu: since PR 18
                warpgroup MMA with the output channels on its 64-row side,
                the weights converted in registers from a TMA ring, the
                contraction split across a cluster and summed in rank
                order, for bf16 x at any row count; f32 FMA for f32 x up to
                64 rows) against its plain version at every QLinear shape:
                bf16 at every row count 1-64 and 257, 514, 2,056 within
                int8w_tolerance and bitwise equal to the same rows of one
                2,056-row launch, that launch twice bitwise; f32 at 1, 8,
                16, 24, 40, 64 rows, rows 0, M/2 and M-1 alone equal to the
                same rows inside M; its times at 8-64 rows and the prefill
                widths beside its bound, the route "dequantize, then
                torch.matmul", the plain version and torch.matmul on the
                bf16 weight, summed over a decode step's QLinears, beside
                PR 16's recorded sums; nvcc's report; K3 on the speculative
                verify's caches (S = 514-516, w = 2, 3, 5, distinct starts;
                tc and fma routes) within window_tolerance; generate_images
                in int8w at full depth beside phase generate's bf16_int8kv
                run, and with CFG at depth 2 (finite images, K2 depth·255
                per pass, every QLinear of the prefills and decode steps
                on W8's kernel), the first decode step's logits within 0.1
                of the bf16 model's largest; the speculative sampler at
                depth 2 (full width) at gamma 0, 1, 2, 4 (bf16) and 0, 2
                (f32), and at full depth at gamma 0, 2 (bf16), each on one
                draw table: rounds, ms per image, K3 per round on its
                route, and each against gamma=0 "equal" or its first
                divergence, whose score gap must lie within 2^-5 of the
                row's largest logit; generate_texts from 4 tokens to 256
                (K2 24·251); the int8w engine (the default) dense and paged
                with 8 requests, K3/K5 and W8 counted, and under auto one
                request against sequential int8w generation (agreement and
                the first divergence's score gap reported: the reference's
                TPU caveat); then the dense int8w engine pinned
                (use_kernel=False) at depth 2 (full width) on the same 8
                requests against pinned sequential generation of each,
                every token equal and no
                K2, K3 or K5 launch (checked); a depth-2 model overfit
                to a constant image, gamma=3 "repeat" equal to gamma=0 in
                at most 128 rounds; token shift: cached decode ≡ forward at
                depth 2 in f32, a DalleTrainer step through K1, full-depth
                bf16 generation (K2 24·255).

25. serve_obs the serving path's telemetry and product pipeline at
                DALL·E-1.4B (int8w, 8 slots): (a) the dense engine on
                decode_surface's 8 requests with obs off, then with tracing,
                the flight recorder, decode_health and a chaos FaultPlan
                (slow, 0.25 s at engine step 16): every token equal, 8
                serve/request spans with finite entropy, topk_mass and
                repeat_ratio and 8 serve/request_ttft, the health.decode_*
                gauges, the chaos_fault event and step 16's wall >= 0.25 s;
                as many synchronising calls a step with decode_health as
                without; decode_quality within DQ_TOL of float64 on the same
                logits; ms/step off and on, TTFT p50/p95 from the
                serve.ttft_seconds histogram beside the wall clock's. (b)
                and (c) at depth 2 (full width, to keep the script's time:
                neither measures the depth). (b)
                The paged engine on phase serve's paged traffic: every
                chunk width dispatched in chunk_widths(), the kv.* gauges
                equal to kv_stats() after each admission pass. (c)
                image_pipeline(top_k=4) with the 1.4B dVAE and phase
                paper's CLIP over 2 groups of 8 engine candidates: ordered
                by score, scores within RERANK_TOL of rerank_scores on the
                same pixels, both stages' spans, the two groups' stages
                overlapping; ms per group per stage. (d) cli.generate
                --trace at depth 2: trace.json parses, its span names are
                the JAX script's, K2 launched 2 · 255 times. K3, K5, W8 and
                K2 counted from zero around each run.
26. taming    the taming stack at full width, in build/taming_smoke/ (removed
                after): ``cli.train_vqgan`` at taming's vqgan_imagenet_f16_1024
                (256 px, ch 128, ch_mult 1,1,2,2,4, 2 res blocks, attention at
                16, 1,024 codes of 256) for 3 steps at batch 8 with
                disc_start 0, so LPIPS, the adaptive weight and the
                discriminator run; then 6 VQGANTrainer steps timed (nll
                falling, every metric finite), peak memory; the trained
                model written in taming's layout with its yaml and read back
                through VQGanVAE.from_pretrained (the same codes), encode and
                decode ms an image; K2 at the faceshq GPT's cache (b 8, h 16,
                d 64, S 512, f32) against its plain version at lengths 1,
                31, 32, 257, 512, then timed beside its bound, the plain
                version and SDPA; the GPT of taming's faceshq_transformer
                (vocab 1,024, block 512, 24 layers, 16 heads, 1,024 wide)
                over a CoordStage(1024, 16) and the VQGAN: 4 Net2Net loss +
                Adam steps (loss falling), cached decode ≡ forward within
                1e-3, Net2NetTransformer.sample of 256 tokens at batch 8
                with top-k 100 (K2 launched 24 · 255 times, K1 never; ms a
                token); ``cli.train_dalle`` at the 1.4B widths, depth 2, over
                the taming files (--vqgan_model_path, --vqgan_config_path)
                for one step and ``cli.generate --bf16`` of 8 images (K2
                2 · 255).
27. reversible DALL·E-1.4B with reversible blocks, batch 8, bf16: first at
                depth 2, full width, the loss and every gradient of one
                step against the naive coupling's (autograd through stored
                activations, the same kernels): in f32 compute within
                REV_F32_TOL of each tensor's largest entry; in bf16 each
                tensor no farther from the f32 step's than the naive bf16
                step's is, plus REV_BF16_MARGIN; the loss within
                REV_LOSS_TOL;
                then 6 DalleTrainer steps at depth 24 (losses falling), K1's
                forward launched 48 times a step (the forward and the
                backward's recompute) and its backward 24, the profiler
                counting K1's fwd, dq and dkv kernels in one step; ms a step
                and peak memory beside phase train's sequential step, and
                what one step's forward and backward hold above the masters
                and optimizer state: reversible, naive, sequential (phase
                train's, no remat) and sequential with remat, on the same
                weights.
28. train_obs the training path's telemetry and model health at DALL·E-1.4B
                (24 layers, dim 1792, batch 8, bf16 over f32 masters, Adam,
                the runtime lr scale armed, K1): fit in turns, taps off,
                all on, all on, off (all on: trace, health, a 120 s
                watchdog, the Prometheus textfile with the device gauges
                every 4 steps, profile_step on a turn's 3rd step,
                BreachActions attached), 4 steps a turn on
                the same batches in both trainers; ms a step per turn (the
                profiled step left out); K1 launched 24 times a step; the
                fit/* span counts; the health columns (the JAX groups at
                depth 1); the Prometheus names; no stall; K1's fwd, dq and
                dkv kernels 24 each in both profiled steps' torch.profiler
                traces; one synchronising call a step with the taps and
                without; one step's grad_norm, param_norm and update_ratio
                a group against a float64 recompute on the card within
                TAP_TOL; the masters and Adam's moments bitwise equal with
                and without the taps; the breach rung: an inf written into
                a transformer gradient through grad_hook gives
                nonfinite_frac > 0, the nan-precursor breach and its
                preemptive snapshot (mode, ms, bytes), and a rollback after
                one more step restores it bit for bit. Then a dVAE step
                (phase paper's config) and two VQGAN GAN steps (taming's
                vqgan_imagenet_f16_1024) with health: their codebook and
                gumbel columns, gen/ and disc/ groups; and cli.train_dalle
                --trace --health --breach_actions --prometheus_path
                --watchdog_deadline_s 120 at depth 2 (full width) for 2
                steps, cli.obs_report over its metrics and its spans (the
                MODEL-HEALTH verdict), in build/train_obs_smoke/ (removed
                after).
29. train_data training from real data, in build/train_data_smoke/ (removed
                after): the image codec's native core built from its
                source and every committed JPEG fixture
                (tests/torch_fixtures) held to PIL's decode within the CPU
                tests' bound; a folder of 64 captioned images of mixed
                sizes around 256 px (PNG and BMP from the port's writers,
                the JPEG fixtures copied in) and two tar shards of them;
                the loader's ms a batch of 8 at 128 px; then DALL·E-1.4B
                (batch 8, bf16, Adam) trained 6 fit steps from the folder,
                each batch encoded by the 1.4B dVAE on the card: losses
                finite, K1's forward and backward 24 times a step, ms a
                step beside phase train's, the step breakdown, the
                synchronising calls of a step with its data;
                DalleWithVae.loss from the pixels of one batch against
                the step's loss on it (WITH_VAE_LOSS_TOL); an asynchronous
                checkpoint of the 1.4B train state (depth 24, or
                CKPT_SMALL_DEPTH at full width when the write would pass
                CKPT_MAX_WRITE_S at phase cli's synced rate or the disk is
                short):
                the pinned snapshot timed (first and reused), the save's
                blocking time, the write and its GB/s, steps taken while
                it is in flight, the restore bit for bit; and the command
                line at depth 2, full width: train_dalle on the folder and
                on the shards, a train_dalle process given SIGUSR1 after
                its first step (a durable checkpoint) then SIGTERM (exit 0,
                a complete checkpoint at the step it reached) and
                --resume from that step, and train_vae, train_vqgan and
                train_clip for 2 steps each on the folder.

30. serve_gateway the serving plane, in build/serve_gateway_smoke/
                (removed after): (a) the HTTP/SSE gateway (gateway.Gateway
                on 127.0.0.1:0) over 2 in-process replicas of 8 slots,
                steps_per_sync 4, FIFO, at DALL·E-1.4B in int8w, with a
                random dVAE and CLIP for /v1/images; 16 /v1/generate (8
                streamed, 2 of them with pixel previews, 8 blocking) and 2
                /v1/images (4 candidates, top 2), every sequence a whole
                grid, sent at once from client threads, then one request
                over its tenant's quota (429), a malformed one (400),
                /healthz and /metrics; any other status fails the phase.
                Each stream's rows concatenated equal its done tokens; K3
                and W8 launched (counts zeroed just before the traffic),
                K5 not. TTFT and latency p50/p95, image tokens/s, the
                pipeline's decode and rerank ms. Every sequence against
                one lone engine of the same configuration: under
                use_kernel None the replicas admit other batch mixes, so
                each sequence that parts is replayed to its first
                divergence, whose score gap must lie within 2^-5 of the
                row's largest logit (as decode_surface holds its engine),
                and the whole check reruns pinned (use_kernel=False), at
                depth 2 and full width as decode_surface's pinned check,
                and must be equal. One replica's engine's ms a step with
                pixel previews off and on (off, on, on, off; 8 requests
                of 64 tokens), and the same 8 requests on an engine
                driven directly on the main thread (the HTTP/SSE cost).
                Then, with the lock-order tracker on (off above, where
                the times are read): a replica failing after 2 rows
                (fail_after_rows) fails over mid-stream bit for bit; (b)
                the fleet at depth 2, full width: FleetManager spawns 2
                serve_replica processes from a checkpoint, a gateway routes
                over their RemoteReplicas under a FleetController
                (min_replicas 2); one process is SIGKILLed by a chaos
                FaultPlan at engine step 40 mid-stream, its stream fails
                over (conn_reset) bit for bit, the controller replaces
                it, and the replacement fleet serves again; every frame
                meets contracts/wire.json (wiretap) and the lock graph
                has no cycle. Spawn to handshake, kill to replacement.

Phases 11-20 and 23-25 run beside their kin: flash_kernel, persist_kernel,
chunked_kernel and ring_kernel after serve_kernel; flash_parity,
persist_parity and ring_parity after serve_parity; decode_surface, serve_obs
and serve_gateway after serve; recipe and then train_persist after train; train_long and then
train_ring, then cli, paper, taming, reversible, train_obs and train_data
last.

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
    # the paged engine at depth 2, full width (for the script's time): its
    # radix, COW and K5 paths do not depend on the depth
    cfg2 = dalle_1p4b(depth=CLI_DEPTH)
    wrapper2 = DalleWithVae(init_dalle(cfg2, seed=SMOKE_SEED), None)
    launches, rows = {}, {}
    for mode, wr, c in (("dense", wrapper, cfg), ("paged", wrapper2, cfg2)):
        kw = dict(kv_block_tokens=16) if mode == "paged" else {}
        eng = wr.serve_engine(slots=8, precision="bf16_int8kv", **kw)
        subs = _serve_traffic(c, mode == "paged")
        torch.cuda.reset_peak_memory_stats()
        window_set_counts(dec, dict.fromkeys(WINDOW_COUNTERS, 0))   # the main path starts here
        done, wall = _run_served(torch, eng, subs)
        k3, k5 = dec.window_launches, dec.paged_launches
        routes = {c: getattr(dec, c) for c in WINDOW_COUNTERS[2:]}
        st = eng.stats
        check(sorted(c.request_id for c in done) == list(range(len(subs))),
              f"serve {mode}: {len(done)} of {len(subs)} requests completed")
        for cr in done:
            n = subs[cr.request_id].get("max_tokens") or c.image_seq_len
            check(cr.tokens.shape == (n,) and cr.tokens.min() >= 0
                  and cr.tokens.max() < c.image_vocab_size,
                  f"serve {mode}: request {cr.request_id} tokens {cr.tokens.shape}")
        want = c.depth * st.window_dispatches
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
        ttft = sorted(cr.ttft_s for cr in done)
        tokens = sum(int(cr.tokens.shape[0]) for cr in done)
        rows[mode] = dict(
            mode=mode, depth=c.depth, slots=8, precision="bf16_int8kv", requests=len(done),
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
    del model, wrapper, wrapper2, eng
    torch.cuda.empty_cache()
    return launches, rows


# ---------------------------------------------------------------------------
# the decode surface: W8 (int8 weights), speculative decoding, text
# generation and token shift
# ---------------------------------------------------------------------------

W8_COUNTERS = ("launches", "tc_launches", "fma_launches", "matmul_calls")
W8_ROWS = (1, 8, 16, 24, 40, 64)        # the f32 (fma) route's 1-4 tiles of 16 rows
W8_TIMED = (8, 16, 24, 32, 40, 48, 64)
W8_PREFILL = (257, 514, 2056)           # a prompt, a CFG pair's, a refill of 8 slots
# PR 16's W8 summed over a decode step's 97 projections, ms (PERF.md section 6,
# PR 16 call 6, NVIDIA H100 80GB HBM3 at 700 W)
W8_PR16_STEP_MS = {8: 1.549, 16: 1.589, 24: 2.075, 32: 2.210, 40: 2.571, 48: 2.641, 64: 3.288}
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
    """W8 at every QLinear shape of the 1.4B model and each row count of
    ``rows``, bf16 x: the kernel (``ms``), the route "dequantize, then
    torch.matmul" (``matmul_route_ms``: PR 16's above 64 rows, the f32
    route's above ``MAX_ROWS``), the plain version, torch.matmul on the
    bf16 weight (``library_ms``) and the bound; then per row count the sums
    over a forward's QLinears (depth × the four layer shapes, plus
    to_logits: the 97 projections of a decode step) for each."""
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
    """W8 against its plain version at every QLinear shape of the 1.4B model.
    bf16 x (the warpgroup route): one x of W8_PREFILL[-1] rows, its output
    once in full; then every row count M of 1-64 and W8_PREFILL on x[:M]
    within int8w_tolerance of the plain version's rows and bitwise equal to
    the full output's first M rows (a row's bits do not depend on M, its
    tile or its route), and the full launch run twice bitwise. f32 x (the
    fma route) at W8_ROWS within int8w_tolerance, rows 0, M/2 and M-1 alone
    equal to the same rows inside M. Then the times (``_w8_timing``) at
    W8_TIMED and the prefill widths."""
    from dalle_tpu_torch.ops import int8w_linear as w8
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED + 20)
    shares, invariant, max_abs = {}, {}, 0.0
    full_rows = W8_PREFILL[-1]
    bf16_rows = list(range(1, 65)) + list(W8_PREFILL)
    for name, (N, K, bias) in w8_shapes(cfg).items():
        q = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand(N, generator=gen, device="cuda") * 0.02 + 1e-3
        # bf16: every row count against the full launch
        b = (torch.randn(N, generator=gen, device="cuda") * 0.5).bfloat16() if bias else None
        x = torch.randn(full_rows, K, generator=gen, device="cuda").bfloat16()
        full = w8.int8w_linear_kernel(x, q, s, b)
        want = w8.int8w_linear_plain(x, q, s, b)
        bound = w8.int8w_tolerance(x, q, s, b, want)
        again = w8.int8w_linear_kernel(x, q, s, b)
        torch.cuda.synchronize()
        key = f"{name}/bfloat16"
        check(torch.equal(full, again), f"W8 {key}: two runs of {full_rows} rows differ")
        worst, same = 0.0, True
        for M in bf16_rows:
            got = w8.int8w_linear_kernel(x[:M], q, s, b)
            err = (got.float() - want[:M].float()).abs()
            worst = max(worst, (err / bound[:M]).max().item())
            max_abs = max(max_abs, err.max().item())
            same = same and torch.equal(got, full[:M])
        shares[key] = worst
        invariant[key] = same
        check(worst <= 1.0, f"W8 {key}: {worst} of int8w_tolerance")
        check(same, f"W8 {key}: a row's bits depend on the row count")
        del x, full, want, bound, again
        # f32: the fma route
        b = (torch.randn(N, generator=gen, device="cuda") * 0.5).float() if bias else None
        for M in W8_ROWS:
            x = torch.randn(M, K, generator=gen, device="cuda")
            got = w8.int8w_linear_kernel(x, q, s, b)
            want = w8.int8w_linear_plain(x, q, s, b)
            torch.cuda.synchronize()
            share = ((got.float() - want.float()).abs()
                     / w8.int8w_tolerance(x, q, s, b, want)).max().item()
            key = f"{name}/float32/M{M}"
            shares[key] = share
            max_abs = max(max_abs, (got.float() - want.float()).abs().max().item())
            check(share <= 1.0, f"W8 {key}: {share} of int8w_tolerance")
            if M > 1:
                picked = sorted({0, M // 2, M - 1})
                alone = torch.cat([w8.int8w_linear_kernel(x[r:r + 1], q, s, b)
                                   for r in picked])
                invariant[key] = torch.equal(alone, got[picked])
                check(invariant[key], f"W8 {key}: a row alone differs from the row in {M}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {name: w8.w8_plan(N, K, sms) for name, (N, K, _) in w8_shapes(cfg).items()}
    emit("w8_kernel", shapes={k: list(v) for k, v in w8_shapes(cfg).items()}, splits=plans,
         bf16_rows=f"1-64 and {list(W8_PREFILL)}, against one launch of {full_rows} rows",
         f32_rows=list(W8_ROWS), max_abs_err=max_abs, worst_share=max(shares.values()),
         shares=shares, row_invariant=invariant, deterministic=True,
         tolerance="int8w_linear.int8w_tolerance, per element",
         ptxas=ptxas_report("int8w_linear", "kernel"), card=card)
    timing, step = _w8_timing(torch, cfg, rows=W8_TIMED + W8_PREFILL)
    # the host's cost of a call at the w1 shape and 8 rows, beside cuBLAS's
    N, K, _ = w8_shapes(cfg)["w1"]
    q = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
    s = torch.rand(N, generator=gen, device="cuda") * 0.02 + 1e-3
    b = (torch.randn(N, generator=gen, device="cuda") * 0.5).bfloat16()
    x = torch.randn(1, 8, K, generator=gen, device="cuda").bfloat16()
    wbf = w8.dequantize(q, s, torch.bfloat16)
    host_us = {"int8w_linear": host_us_per_call(torch, lambda: w8.int8w_linear(x, q, s, b)),
               "torch_matmul_bf16": host_us_per_call(torch, lambda: torch.matmul(x, wbf.t()))}
    emit("w8_kernel_timing", timing=timing, flush="a 512 MiB read before each launch",
         library="torch.matmul on the dequantized bf16 weight",
         matmul_route="int8w_linear_matmul: dequantize, then torch.matmul", card=card)
    emit("w8_routes", f32_max_rows=w8.MAX_ROWS, per_decode_step=step,
         host_us_per_call_w1_m8=host_us,
         pr16_per_decode_step_ms=W8_PR16_STEP_MS,
         pr16_source="PERF.md section 6, PR 16 call 6 (another call: compare within one "
                     "call with chip_w8_compare.py)",
         kernel_faster_than_matmul_route_at=[M for M in step
                                             if step[M]["ms"] <= step[M]["matmul_route_ms"]],
         kernel_faster_than_cublas_bf16_at=[M for M in step
                                            if step[M]["ms"] <= step[M]["library_ms"]],
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
    import numpy as np
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
        # every QLinear of the prefill (b·257 rows, its head on the last
        # position) and of every decode step runs the kernel
        linears = 4 * c.depth + 1                   # QLinears a forward runs
        want = {"launches": c.image_seq_len * linears * caches, "matmul_calls": 0}
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
    # engine against sequential int8w generation under auto: reported, not
    # assumed (K3 in the engine, K2 in the sequential steps, rounding at
    # other points: the reference's TPU caveat, dalle_tpu/models/dalle.py:
    # 290-296). The request's draws are its generator's, one (1, V) row a
    # step as the engine and the sequential sampler take them; the first
    # divergence is replayed over the int8 cache for its score gap
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
         first_divergence=div, use_kernel=None, card=card)

    # the pin: the int8w engine under use_kernel=False against pinned
    # sequential generation of each request under its generator, bit for
    # bit (the JAX package's contract); no K2, K3 or K5 launch in either.
    # At full width, depth cut to 2 (wrapper2): eight b=1 sequential runs
    # at depth 24 took most of this phase; bit-for-bit equality needs no
    # depth
    m8p, _ = wrapper2._resolve_precision("int8w")
    eng = wrapper2.serve_engine(slots=8, use_kernel=False)
    q = RequestQueue()
    for i, s in enumerate(subs):
        q.submit(request_id=i, **s)
    q.close()
    dec.launches = 0                                        # this path starts here
    window_set_counts(dec, dict.fromkeys(WINDOW_COUNTERS, 0))
    w8_set_counts(w8, dict.fromkeys(W8_COUNTERS, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pinned = {c.request_id: np.asarray(c.tokens) for c in eng.run(q)}
    torch.cuda.synchronize()
    pin_wall = time.perf_counter() - t0
    pin_steps = eng.stats.steps
    pin_step_ms = eng.stats.step_seconds * 1e3 / max(pin_steps, 1)
    t0 = time.perf_counter()
    equal, first_diff = {}, {}
    for i, s in enumerate(subs):
        seq_i = m8p.generate_images_tokens(
            torch.from_numpy(s["text"][None]).cuda(), cond_scale=s.get("cond_scale", 1.0),
            generator=torch.Generator("cuda").manual_seed(s["seed"]),
            cache_dtype=torch.int8, use_kernel=False)[0].cpu().numpy()
        n = s.get("max_tokens") or cfg.image_seq_len
        got_i = pinned.get(i, np.zeros((0,), np.int64))
        equal[i] = got_i.shape == (n,) and bool((seq_i[:n] == got_i).all())
        if not equal[i]:
            d = np.flatnonzero(seq_i[:len(got_i)] != got_i)
            first_diff[i] = int(d[0]) if d.size else int(len(got_i))
    seq_wall = time.perf_counter() - t0
    pin_kernels = {"decode_attend": dec.launches, "decode_attend_window": dec.window_launches,
                   "decode_attend_window_paged": dec.paged_launches}
    pin_w8 = w8_counts(w8)
    emit("int8w_engine_pinned_vs_sequential", use_kernel=False, requests=len(subs),
         depth=cfg2.depth,
         equal=equal, first_difference=first_diff, kernel_launches=pin_kernels, w8=pin_w8,
         engine_wall_s=pin_wall, engine_steps=pin_steps, engine_ms_per_step=pin_step_ms,
         sequential_wall_s=seq_wall, auto_agreement_request6=agree, card=card)
    check(all(equal.values()) and len(pinned) == len(subs),
          f"pinned int8w engine against pinned sequential generation: equal {equal}, "
          f"first differences {first_diff}")
    check(all(v == 0 for v in pin_kernels.values()),
          f"pinned runs launched decode kernels: {pin_kernels}")
    check(pin_w8["tc_launches"] > 0 and pin_w8["matmul_calls"] == 0,
          f"pinned runs: W8 {pin_w8}")
    launches["w8"] = {k: launches["w8"][k] + pin_w8[k] for k in W8_COUNTERS}
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
# serve_obs: the serving path's telemetry and product pipeline
# ---------------------------------------------------------------------------

SERVE_OBS_SLOW_STEP = 16        # the chaos fault's engine step
SERVE_OBS_SLOW_S = 0.25         # and its delay
# decode_quality on the card against a float64 computation on the host of the
# same bf16 logits: f32 log-softmax and sums over 8,192 entries, ~1e-6
DQ_TOL = 1e-4
# the pipeline's batched CLIP scores against rerank_scores on the same pixels:
# one text embedding against eight, or eight against eight, in f32
RERANK_TOL = 1e-5
# the span names the JAX package's scripts/generate.py records for
# ``--text P --num_images 8 --batch_size 8 --trace DIR`` (held to the JAX
# script on the CPU by tests/test_torch_cli.py)
GENERATE_TRACE_SPANS = {"generate/prompt", "decode/generate_tokens", "sampling/top_k_filter",
                        "sampling/gumbel_sample", "decode/vae_decode"}


def _hist_quantile(snap, name, q):
    """The q-quantile of an obs histogram in a metrics snapshot, linear within
    its bucket (Prometheus' histogram_quantile); the last finite bound when it
    falls in +Inf."""
    prefix = name + '_bucket{le="'
    cums = sorted((float(k[len(prefix):-2]), v) for k, v in snap.items()
                  if k.startswith(prefix) and "+Inf" not in k)
    rank = q * snap[name + "_count"]
    lo, below = 0.0, 0.0
    for bound, cum in cums:
        if cum >= rank:
            return lo + (bound - lo) * (rank - below) / max(cum - below, 1e-12)
        lo, below = bound, cum
    return cums[-1][0]


def _engine_counts(dec, w8):
    return {"decode_attend_window": dec.window_launches,
            "decode_attend_window_paged": dec.paged_launches, "w8": w8_counts(w8)["launches"]}


def _zero_engine_counts(dec, w8):
    window_set_counts(dec, dict.fromkeys(WINDOW_COUNTERS, 0))
    w8_set_counts(w8, dict.fromkeys(W8_COUNTERS, 0))


def phase_serve_obs(torch, card):
    """The serving path's telemetry and product pipeline at DALL·E-1.4B (see
    the module docstring, phase 25): (a) the int8w engine without and with
    tracing, decode_health and a chaos fault; (b) the paged engine's chunk
    widths and kv gauges; (c) image_pipeline over two groups of engine
    candidates; (d) cli.generate --trace at depth 2."""
    import base64
    import json as _json
    import os
    import shutil

    import numpy as np

    from dalle_tpu_torch import (ClipConfig, DalleWithVae, DiscreteVAEAdapter, DVAEConfig,
                                 chaos, dalle_1p4b, init_clip, init_dalle, init_dvae, obs)
    from dalle_tpu_torch.cli import generate
    from dalle_tpu_torch.cli._common import save_vae_sidecar
    from dalle_tpu_torch.models.wrapper import rerank_scores
    from dalle_tpu_torch.obs.health import decode_quality
    from dalle_tpu_torch.ops import decode_attention as dec
    from dalle_tpu_torch.ops import int8w_linear as w8
    from dalle_tpu_torch.serve import CandidateGroup, RequestQueue
    from dalle_tpu_torch.train.checkpoints import CheckpointManager

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "serve_obs_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = dalle_1p4b()
    vae = DiscreteVAEAdapter(init_dvae(DVAEConfig(), seed=SMOKE_SEED))
    clip = init_clip(ClipConfig(num_text_tokens=49408, visual_image_size=128,
                                visual_patch_size=16), seed=SMOKE_SEED)
    wrapper = DalleWithVae(init_dalle(cfg, seed=SMOKE_SEED), vae, clip)
    wrapper._resolve_precision("int8w")                # the one-time quantization
    subs = _serve_traffic(cfg, False)[:8]
    launches, row = {}, {"card": card}

    def served(eng, items, trace=False):
        """Run ``items`` through ``eng`` with the counts zeroed just before;
        (completions by id, wall s, the launches, step start times by step)."""
        q = RequestQueue()
        for i, s in enumerate(items):
            q.submit(request_id=i, **s)
        q.close()
        starts, real = {}, eng._multi_step

        def timed_step():
            starts[eng.stats.steps] = time.perf_counter()
            return real()
        eng._multi_step = timed_step
        _zero_engine_counts(dec, w8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run(q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {c.request_id: c for c in done}, wall, _engine_counts(dec, w8), starts

    # (a) the int8w engine, telemetry off, then tracing + decode_health + a
    # slow fault at step 16
    off_eng = wrapper.serve_engine(slots=8)
    off, off_wall, launches["engine_off"], _ = served(off_eng, subs)
    obs.configure()
    obs.configure_recorder(os.path.join(work, "recorder"))
    chaos.install(chaos.FaultPlan([chaos.Fault(kind="slow", step=SERVE_OBS_SLOW_STEP,
                                               duration_s=SERVE_OBS_SLOW_S)]))
    try:
        on_eng = wrapper.serve_engine(slots=8, decode_health=True)
        on, on_wall, launches["engine_on"], starts = served(on_eng, subs)
        spans = obs.get_tracer().snapshot_spans()
        snap = obs.metrics_snapshot()
        events = obs.get_recorder().snapshot_events()
    finally:
        chaos.uninstall()
        obs.disable()
        obs.disable_recorder()
    check(sorted(on) == sorted(off) == list(range(len(subs))), "serve_obs: lost requests")
    same = {i: bool(np.array_equal(on[i].tokens, off[i].tokens)) for i in off}
    check(all(same.values()), f"serve_obs: tokens differ with telemetry on: {same}")
    for mode in ("engine_off", "engine_on"):
        n = launches[mode]
        check(n["decode_attend_window"] > 0 and n["w8"] > 0
              and n["decode_attend_window_paged"] == 0, f"serve_obs {mode}: launches {n}")
    req = [a for name, *_, a in spans if name == "serve/request"]
    ttft_spans = [a for name, *_, a in spans if name == "serve/request_ttft"]
    check(len(req) == len(ttft_spans) == len(subs),
          f"serve_obs: {len(req)} serve/request, {len(ttft_spans)} serve/request_ttft spans")
    check(all(math.isfinite(a[k]) for a in req for k in ("entropy", "topk_mass",
                                                         "repeat_ratio")),
          "serve_obs: a request's health args are not finite")
    gauges = {k: snap.get(k) for k in ("health.decode_entropy", "health.decode_topk_mass",
                                       "health.decode_repeat_ratio")}
    check(all(v is not None and math.isfinite(v) for v in gauges.values()),
          f"serve_obs: health gauges {gauges}")
    fault = [e for e in events if e["kind"] == "chaos_fault"]
    slow_wall = starts[SERVE_OBS_SLOW_STEP] - starts[SERVE_OBS_SLOW_STEP - 1]
    check([e.get("at_step") for e in fault] == [SERVE_OBS_SLOW_STEP]
          and slow_wall >= SERVE_OBS_SLOW_S,
          f"serve_obs: chaos events {fault}, step {SERVE_OBS_SLOW_STEP}'s wall {slow_wall}")

    # one engine step's synchronising calls, decode_health on and off (the
    # stats ride the tokens' read), then steady steps of both in turns (off,
    # on, on, off): the runs above part by the host's noise as much as by
    # the taps
    syncs, engs, steady = {}, {}, {False: [], True: []}
    for health in (False, True):
        eng = engs[health] = wrapper.serve_engine(slots=8, decode_health=health)
        q = RequestQueue()
        for i, s in enumerate(subs):
            q.submit(request_id=i, **s)
        q.close()
        eng.run(q, max_steps=4)                   # admitted; rows stay active
        places, outside = _sync_calls(torch, eng._multi_step)
        syncs[health] = [p for p, _ in places]
    check(len(syncs[True]) == len(syncs[False]) >= 1,
          f"serve_obs: synchronising calls a step {syncs}")
    for health in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            engs[health]._multi_step()
        torch.cuda.synchronize()
        steady[health].append((time.perf_counter() - t0) * 1e3 / 16)
    # where decode_health's time goes: a profiled window of 8 steady steps of
    # each engine, the device's ms a step and the ops whose own host time a
    # step grew most with the taps
    host_ops, dev_ms = {}, {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for health in (False, True):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(8):
                engs[health]._multi_step()
            torch.cuda.synchronize()
        dev_us, _ = device_time(torch, prof)
        dev_ms[health] = dev_us / 1e3 / 8 if dev_us else "not measured"
        host_ops[health] = {e.key: (e.self_cpu_time_total / 1e3 / 8, e.count / 8)
                            for e in prof.key_averages()}
    grew = sorted(((k, ms - host_ops[False].get(k, (0.0, 0.0))[0],
                    n - host_ops[False].get(k, (0.0, 0.0))[1])
                   for k, (ms, n) in host_ops[True].items()), key=lambda t: -t[1])[:10]
    img = eng.logits[:, eng.num_text_tokens:]
    got = decode_quality(img)
    x = img.double().cpu()
    lp = torch.log_softmax(x, dim=-1)
    p = lp.exp()
    want = {"entropy": -(p * lp).sum(-1),
            "topk_mass": torch.topk(p, 32, dim=-1).values.sum(-1)}
    dq_err = max(float((got[k].double().cpu() - want[k]).abs().max()) for k in want)
    check(dq_err <= DQ_TOL, f"serve_obs: decode_quality against float64 {dq_err}")
    del eng, engs
    ttft = sorted(c.ttft_s for c in on.values())
    row.update(
        a=dict(requests=len(subs), slots=8, precision="int8w",
               ms_per_step_off=off_eng.stats.step_seconds * 1e3 / off_eng.stats.steps,
               ms_per_step_on=on_eng.stats.step_seconds * 1e3 / on_eng.stats.steps,
               steady_ms_per_step_off=steady[False], steady_ms_per_step_health=steady[True],
               device_ms_per_step_off=dev_ms[False], device_ms_per_step_health=dev_ms[True],
               host_ms_per_step_profiled={str(h): sum(v[0] for v in host_ops[h].values())
                                          for h in (False, True)},
               health_host_ops_grew=[[k, ms, n] for k, ms, n in grew],
               steps_off=off_eng.stats.steps, steps_on=on_eng.stats.steps,
               wall_s_off=off_wall, wall_s_on=on_wall,
               ttft_p50_s_hist=_hist_quantile(snap, "serve.ttft_seconds", 0.5),
               ttft_p95_s_hist=_hist_quantile(snap, "serve.ttft_seconds", 0.95),
               ttft_p50_s_wall=float(np.percentile(ttft, 50)),
               ttft_p95_s_wall=float(np.percentile(ttft, 95)),
               slow_step_wall_s=slow_wall, spans=len(spans), tokens_equal=True,
               health_gauges=gauges, sync_calls_a_step=len(syncs[True]),
               sync_places=syncs[True], decode_quality_vs_f64=dq_err,
               launches_off=launches["engine_off"], launches_on=launches["engine_on"]))
    emit("serve_obs_engine", **row["a"], card=card)

    # (b) and (c) at depth 2, full width: they check widths, gauges and the
    # pipeline's stages, which do not depend on the depth
    del wrapper
    torch.cuda.empty_cache()
    wrapper = DalleWithVae(init_dalle(dalle_1p4b(depth=CLI_DEPTH), seed=SMOKE_SEED), vae, clip)
    wrapper._resolve_precision("int8w")

    # (b) the paged engine: every dispatched width in chunk_widths(), the kv
    # gauges equal kv_stats() after every admission pass
    peng = wrapper.serve_engine(slots=8, kv_block_tokens=16)
    widths, ledgers = [], []
    real_chunk, real_admit = peng._refill_chunk, peng._admit_paged

    def chunk(ids, *a):
        widths.append(int(ids.shape[1]))
        return real_chunk(ids, *a)

    def admit(placed):
        real_admit(placed)
        m, kv = obs.metrics_snapshot(), peng.kv_stats()
        ledgers.append(({k: m[f"kv.pages_{k}"] for k in ("free", "used", "shared", "cow_copies")},
                        {k: float(kv[f"pages_{k}"] if k != "cow_copies" else kv[k])
                         for k in ("free", "used", "shared", "cow_copies")}))
    peng._refill_chunk, peng._admit_paged = chunk, admit
    paged_subs = _serve_traffic(cfg, True)
    obs.configure()
    try:
        pdone, pwall, launches["paged"], _ = served(peng, paged_subs)
    finally:
        obs.disable()
    allowed = peng.chunk_widths()
    check(len(pdone) == len(paged_subs) and widths and set(widths) <= set(allowed),
          f"serve_obs paged: widths {sorted(set(widths))} against chunk_widths {allowed}")
    check(ledgers and all(g == k for g, k in ledgers),
          f"serve_obs paged: kv gauges against kv_stats {ledgers[:2]}")
    n = launches["paged"]
    check(n["decode_attend_window_paged"] > 0 and n["w8"] > 0
          and n["decode_attend_window"] == 0, f"serve_obs paged: launches {n}")
    row["b"] = dict(requests=len(pdone), wall_s=pwall, chunk_widths=list(allowed),
                    widths_dispatched=sorted(set(widths)), chunks=len(widths),
                    admissions=len(ledgers), radix_full_hits=peng.stats.radix_full_hits,
                    launches=n)
    emit("serve_obs_paged", **row["b"], card=card)
    del peng

    # (c) the product pipeline over two groups of eight engine candidates
    texts = _serve_text(cfg, 2, SMOKE_SEED + 20)
    cand = [dict(text=texts[g], seed=3000 + 8 * g + i, group_id=g) for g in range(2)
            for i in range(8)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    obs.configure()
    pipe = wrapper.image_pipeline(top_k=4)
    try:
        cdone, cwall, launches["pipeline_engine"], _ = served(wrapper.serve_engine(slots=8),
                                                               cand)
        groups = [CandidateGroup(group_id=g, text=texts[g],
                                 tokens=np.stack([cdone[8 * g + i].tokens for i in range(8)]),
                                 seeds=[3000 + 8 * g + i for i in range(8)], top_k=4,
                                 trace_id=f"group-{g}") for g in range(2)]
        obs.disable()
        # the first group through the stages pays their one-time set-up
        # (kernel loads, cuDNN's choice of algorithms): timed alone
        t0 = time.perf_counter()
        pipe.process(groups[0])
        cold_ms = (time.perf_counter() - t0) * 1e3
        obs.configure()                  # the pipeline's spans alone
        t0 = time.perf_counter()
        pending = [pipe.submit(gr) for gr in groups]
        ranked = [p.result(timeout=120) for p in pending]
        pipe_wall = time.perf_counter() - t0
        pspans = obs.get_tracer().snapshot_spans()
        pixels = [pipe._decode_stage(gr) for gr in groups]
    finally:
        pipe.close(timeout=60)
        obs.disable()
        torch.backends.cudnn.deterministic = deterministic
    rerank_err = 0.0
    for gr, r, px in zip(groups, ranked, pixels):
        check(r.error is None and r.reranked and len(r.top_k) == 4,
              f"serve_obs pipeline: group {gr.group_id} {r.error}")
        check(r.order == sorted(range(8), key=lambda i: (-r.scores[i], i))
              and [e["candidate"] for e in r.top_k] == r.order[:4]
              and all(len(base64.b64decode(e["pixels_b64"])) == vae.image_size ** 2 * 3
                      for e in r.top_k),
              f"serve_obs pipeline: group {gr.group_id} not ordered by score")
        want = rerank_scores(clip, torch.from_numpy(np.repeat(gr.text[None], 8, 0)).cuda(),
                             torch.from_numpy(px).cuda()).float().cpu().numpy()
        rerank_err = max(rerank_err, float(np.abs(np.asarray(r.scores) - want).max()))
    check(rerank_err <= RERANK_TOL, f"serve_obs pipeline: scores against rerank_scores "
          f"{rerank_err}")
    stage = {name: sorted((t0, t0 + d, a["group_id"]) for n_, t0, d, _, _, a in pspans
                          if n_ == f"pipeline/{name}") for name in ("decode_pixels", "rerank")}
    check(all(len(v) == 2 for v in stage.values()), f"serve_obs pipeline: spans {stage}")
    at = {(name, g): (s0, s1) for name, v in stage.items() for s0, s1, g in v}
    dec_b, rr_a = at[("decode_pixels", 1)], at[("rerank", 0)]
    overlap = dec_b[0] < rr_a[1] and rr_a[0] < dec_b[1]
    check(overlap, f"serve_obs pipeline: group 1's decode and group 0's rerank do not "
          f"overlap {stage}")
    n = launches["pipeline_engine"]
    check(n["decode_attend_window"] > 0 and n["w8"] > 0, f"serve_obs pipeline: launches {n}")
    row["c"] = dict(groups=2, candidates=8, top_k=4, engine_wall_s=cwall,
                    pipeline_wall_s=pipe_wall,
                    decode_pixels_ms_per_group=[(e - s) * 1e3 for s, e, _ in
                                                stage["decode_pixels"]],
                    rerank_ms_per_group=[(e - s) * 1e3 for s, e, _ in stage["rerank"]],
                    first_group_cold_ms=cold_ms,
                    stages_overlap=overlap, scores_vs_rerank_scores=rerank_err,
                    launches=n, top_scores=[r.scores[r.order[0]] for r in ranked])
    emit("serve_obs_pipeline", **row["c"], card=card)
    del wrapper, pipe
    torch.cuda.empty_cache()

    # (d) cli.generate --trace at the 1.4B widths, depth 2
    ck, out, tdir = (os.path.join(work, n) for n in ("dalle", "outputs", "trace"))
    cfg2 = dalle_1p4b(depth=CLI_DEPTH)
    state = {k: v.cpu() for k, v in init_dalle(cfg2, seed=SMOKE_SEED).state_dict().items()}
    CheckpointManager(ck).save(0, {"model": state},
                               {"model_class": "DALLE", "hparams": cfg2.to_dict(),
                                "vae_class_name": "DiscreteVAEAdapter"})
    save_vae_sidecar(ck, vae)
    dec.launches = 0                                  # this path starts here
    t0 = time.perf_counter()
    try:
        rc = generate.main(["--dalle_path", ck, "--text", PAPER_PROMPT, "--num_images", "8",
                            "--batch_size", "8", "--outputs_dir", out, "--trace", tdir,
                            "--seed", str(SMOKE_SEED)])
    finally:
        obs.disable()
    gen_wall = time.perf_counter() - t0
    k2 = dec.launches
    doc = _json.load(open(os.path.join(tdir, "trace.json")))
    names = {e["name"] for e in doc["traceEvents"]}
    jsonl = [_json.loads(line) for line in open(os.path.join(tdir, "spans.jsonl"))]
    check(rc == 0 and names == GENERATE_TRACE_SPANS == {r["name"] for r in jsonl}
          and all(e["ph"] == "X" and e["dur"] >= 0 for e in doc["traceEvents"]),
          f"serve_obs generate --trace: rc {rc}, spans {sorted(names)}")
    check(k2 == CLI_DEPTH * (cfg2.image_seq_len - 1), f"generate --trace: K2 launched {k2}")
    tok = [r for r in jsonl if r["name"] == "decode/generate_tokens"]
    row["d"] = dict(depth=CLI_DEPTH, wall_s=gen_wall, spans=sorted(names), k2_launches=k2,
                    generate_tokens_s=tok[0]["dur_s"],
                    ms_per_token=tok[0]["dur_s"] * 1e3 / cfg2.image_seq_len)
    emit("serve_obs_generate_trace", **row["d"], card=card)
    launches["generate_trace"] = {"decode_attend": k2}
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t_phase
    emit("serve_obs_done", seconds=row["seconds"], card=card)
    return launches, row


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
    from dalle_tpu_torch.cli._common import load_vae_sidecar, to_uint8
    from dalle_tpu_torch.data.image_codec import read_png
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
            tr.ckpt.wait_until_finished()          # step 1's save is written on a thread
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
    from dalle_tpu_torch.cli._common import load_vae_sidecar, to_uint8
    from dalle_tpu_torch.data.image_codec import read_png
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


# ---------------------------------------------------------------------------
# The taming stack (VQGAN, its GAN trainer, the pretrained import, minGPT and
# Net2Net) and reversible DALL·E training
# ---------------------------------------------------------------------------

TAMING_BATCH = 8         # images a VQGAN step and a GPT step
TAMING_STEPS = 6
GPT_STEPS = 4
GPT_TOP_K = 100
# taming's configs/faceshq_transformer.yaml: the GPT over a VQGAN f16 with a
# CoordStage(n_embed 1024, down_factor 16) condition
FACESHQ_GPT = dict(vocab_size=1024, block_size=512, n_layer=24, n_head=16, n_embd=1024)
K2_GPT_LENGTHS = (1, 31, 32, 257, 512)


def _taming_layout(model):
    """A port VQModel's state_dict under taming's names (the inverse of
    ``models/pretrained.taming_key``), on the host."""
    from dalle_tpu_torch.models.pretrained import taming_key
    out = {}
    for k, v in model.state_dict().items():
        up = re.sub(r"\.(down|up)_(\d+)_(block|attn)_(\d+)\.", r".\1.\2.\3.\4.", k)
        up = re.sub(r"\.down_(\d+)_downsample\.", r".down.\1.downsample.", up)
        up = re.sub(r"\.up_(\d+)_upsample\.", r".up.\1.upsample.", up)
        up = re.sub(r"\.mid_(block_1|attn_1|block_2)\.", r".mid.\1.", up)
        up = up.replace("codebook.weight", "quantize.embedding.weight")
        check(taming_key(up) == k, f"taming name {up} does not map back to {k}")
        out[up] = v.detach().cpu()
    return out


def _taming_yaml(cfg) -> str:
    """taming's config yaml for ``cfg`` (its layout: model.params with the
    ddconfig, block lists)."""
    def block_list(name, xs):
        return f"      {name}:\n" + "".join(f"      - {x}\n" for x in xs)
    return ("model:\n  base_learning_rate: 4.5e-06\n  target: taming.models.vqgan.VQModel\n"
            f"  params:\n    embed_dim: {cfg.embed_dim}\n    n_embed: {cfg.n_embed}\n"
            f"    ddconfig:\n      double_z: false\n      z_channels: {cfg.z_channels}\n"
            f"      resolution: {cfg.resolution}\n      in_channels: {cfg.in_channels}\n"
            f"      out_ch: {cfg.out_ch}\n      ch: {cfg.ch}\n"
            + block_list("ch_mult", cfg.ch_mult)
            + f"      num_res_blocks: {cfg.num_res_blocks}\n"
            + block_list("attn_resolutions", cfg.attn_resolutions)
            + f"      dropout: {cfg.dropout}\n")


def _k2_gpt_case(torch, card):
    """K2 at the faceshq GPT's cache (b 8, h 16, d 64, S 512, f32) against
    its plain version at K2_GPT_LENGTHS, then its time at length 512 beside
    its bound, the plain version's and SDPA's."""
    import torch.nn.functional as F
    from dalle_tpu_torch.ops import decode_attention as dec
    gen = torch.Generator("cuda").manual_seed(SMOKE_SEED + 19)
    b, h, d, S = TAMING_BATCH, FACESHQ_GPT["n_head"], 64, FACESHQ_GPT["block_size"]
    saved = dec.launches
    cache = _cache(torch, b, h, d, S, torch.float32, gen)
    q = torch.randn(b, h, 1, d, device="cuda", generator=gen)
    errs = {}
    for length in K2_GPT_LENGTHS:
        out = dec.decode_attend(q, cache, length)
        ref = dec.decode_attend_plain(q, cache.kv, cache.scale, length)
        torch.cuda.synchronize()
        errs[f"L{length}"] = err = (out - ref).abs().max().item()
        check(err <= TOL["float32"], f"decode_attend at the GPT shape, length {length}: "
                                     f"max abs err {err} > {TOL['float32']}")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    ms = median_ms(lambda: dec.decode_attend(q, cache, S), 50, flush)
    dec.launches = saved               # comparison and timing launches are not the path's
    plain_ms = median_ms(lambda: dec.decode_attend_plain(q, cache.kv, cache.scale, S), 20,
                         flush)
    kd, vd = (t.contiguous() for t in cache.read_kv(dtype=torch.float32))
    sdpa = lambda: F.scaled_dot_product_attention(q, kd, vd)  # noqa: E731
    lib_ms = median_ms(sdpa, 50, flush)
    nbytes = q.numel() * 4 * 2 + b * S * 2 * h * d * 4
    ops = 4 * b * h * S * d + 5 * b * h * S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes,
           "roofline_share": max(t_bytes, t_ops) / ms,
           "plan": dec.decode_plan(b, h, S, d, torch.float32, sm_count)._asdict(),
           "library_kernels": sdpa_kernels(torch, sdpa), "max_abs_err": max(errs.values()),
           "max_abs_err_by_length": errs, "tolerance": TOL["float32"],
           "timed_at": f"b={b} h={h} d={d} S={S} length={S}, float32 cache"}
    emit("taming_k2", card=card, **row)
    del cache, kd, vd, flush
    return row


def phase_taming(torch, card):
    import os
    import shutil

    from dalle_tpu_torch.cli import generate, train_dalle, train_vqgan
    from dalle_tpu_torch.data.image_codec import read_png
    from dalle_tpu_torch.config import OptimConfig, TrainConfig, VQGANConfig
    from dalle_tpu_torch.data.synthetic import ShapesDataset
    from dalle_tpu_torch.models.cond_transformer import CoordStage, Net2NetTransformer
    from dalle_tpu_torch.models.gan import GANLossConfig
    from dalle_tpu_torch.models.mingpt import GPTConfig, init_gpt, make_sampler
    from dalle_tpu_torch.models.pretrained import VQGanVAE
    from dalle_tpu_torch.ops import decode_attention as dec
    from dalle_tpu_torch.ops import fused_attention as fa
    from dalle_tpu_torch.train.checkpoints import CheckpointManager
    from dalle_tpu_torch.train.train_state import make_optimizer
    from dalle_tpu_torch.train.trainer_vqgan import VQGANTrainer

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = VQGANConfig()                      # taming's vqgan_imagenet_f16_1024
    b = TAMING_BATCH
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "taming_smoke")
    shutil.rmtree(work, ignore_errors=True)
    ds = ShapesDataset(cfg.resolution)
    images01 = ds.as_arrays(limit=b)[0]
    images = images01 * 2.0 - 1.0
    out = {}
    try:
        # -- the VQGAN's GAN step through its entry point -----------------------
        t0 = time.perf_counter()
        rc = train_vqgan.main(["--synthetic", "--resolution", str(cfg.resolution),
                               "--batch_size", str(b), "--steps", "3", "--disc_start", "0",
                               "--output_dir", os.path.join(work, "vqgan"), "--no_preflight",
                               "--seed", str(SMOKE_SEED)])
        cli_s = time.perf_counter() - t0
        check(rc == 0, f"train_vqgan exited {rc}")
        meta = CheckpointManager(os.path.join(work, "vqgan")).load_metadata()
        check(meta["model_class"] == "VQModel" and meta["hparams"] == cfg.to_dict(),
              "train_vqgan's checkpoint does not name the VQGAN")

        # -- its step, timed ------------------------------------------------------
        tc = TrainConfig(batch_size=b, seed=SMOKE_SEED,
                         optim=OptimConfig(learning_rate=4.5e-6 * b, beta1=0.5, beta2=0.9,
                                           grad_clip_norm=0.0))
        tr = VQGANTrainer(cfg, tc, GANLossConfig(disc_start=0))
        torch.cuda.reset_peak_memory_stats()
        walls, rows = [], []
        for _ in range(TAMING_STEPS):
            t0 = time.perf_counter()
            rows.append(tr.train_step(images))       # ends in a host read of the metrics
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for m in rows:
            check(all(math.isfinite(m[k]) for k in ("loss", "disc_loss", "d_weight", "g_loss")),
                  f"VQGAN step: non-finite metrics {m}")
        check(rows[-1]["nll_loss"] < rows[0]["nll_loss"],
              f"VQGAN nll did not fall: {[m['nll_loss'] for m in rows]}")
        vq_row = {"batch": b, "steps": TAMING_STEPS, "ms_per_step_first": walls[0] * 1e3,
                  "ms_per_step": statistics.median(walls[1:]) * 1e3, "peak_gib": peak,
                  "params_gen": tr.num_params,
                  "params_disc": sum(p.numel() for p in tr.disc.parameters()),
                  "first": rows[0], "last": rows[-1], "compute": tc.precision.compute,
                  "cli_train_vqgan_s": cli_s}
        emit("taming_vqgan_step", card=card, **vq_row)
        model = tr.model.eval()
        del tr
        torch.cuda.empty_cache()

        # -- encode + decode, through the pretrained import of a taming file ----
        os.makedirs(work, exist_ok=True)
        ckpt, yml = os.path.join(work, "vqgan.ckpt"), os.path.join(work, "vqgan.yaml")
        torch.save({"state_dict": _taming_layout(model)}, ckpt)
        with open(yml, "w", encoding="utf-8") as f:
            f.write(_taming_yaml(cfg))
        vae = VQGanVAE.from_pretrained(ckpt, yml)
        x01 = torch.from_numpy(images01).cuda()
        ids = vae.get_codebook_indices(x01)
        check(torch.equal(ids, model.get_codebook_indices(torch.from_numpy(images).cuda())),
              "the taming file's VQGAN encodes otherwise than the trained model")
        dec_img = vae.decode(ids)
        check(tuple(ids.shape) == (b, 256) and int(ids.max()) < cfg.n_embed
              and tuple(dec_img.shape) == (b, 256, 256, 3)
              and bool(torch.isfinite(dec_img).all()), "VQGAN encode/decode shapes")
        enc_ms = median_ms(lambda: vae.get_codebook_indices(x01), 5)
        dec_ms = median_ms(lambda: vae.decode(ids), 5)
        emit("taming_vqgan_codec", batch=b, encode_ms_per_image=enc_ms / b,
             decode_ms_per_image=dec_ms / b, codes_used=int(torch.unique(ids).numel()),
             card=card)
        vq_row.update(encode_ms_per_image=enc_ms / b, decode_ms_per_image=dec_ms / b)

        # -- K2 at the GPT's cache, before the GPT runs --------------------------
        k2_row = _k2_gpt_case(torch, card)

        # -- the faceshq GPT over the VQGAN: loss + Adam -------------------------
        gcfg = GPTConfig(**FACESHQ_GPT)
        gpt = init_gpt(gcfg, seed=SMOKE_SEED).train()
        coord = CoordStage(gcfg.vocab_size, 16)
        n2n = Net2NetTransformer.from_vqgan(gcfg, model, cond_encode=coord.encode, gpt=gpt)
        ramp = torch.linspace(0, 1, cfg.resolution, device="cuda")
        c = ramp[None, :, None, None].expand(b, cfg.resolution, cfg.resolution, 1).contiguous()
        # faceshq_transformer.yaml's base_learning_rate 4.5e-6 scaled by the
        # batch (taming's rule); at 1e-4 the loss spiked at step 3
        opt = make_optimizer(OptimConfig(learning_rate=4.5e-6 * b, grad_clip_norm=1.0),
                             list(gpt.parameters()))
        x = torch.from_numpy(images).cuda()
        torch.cuda.reset_peak_memory_stats()
        losses, walls = [], []
        for _ in range(GPT_STEPS):
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = n2n.loss(x, c)
            loss.backward()
            opt.step(loss.detach())
            losses.append(loss.item())
            walls.append(time.perf_counter() - t0)
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
              f"GPT loss: {losses}")
        gpt_row = {"params": sum(p.numel() for p in gpt.parameters()), "batch": b,
                   "tokens_a_row": 2 * 256 - 1, "losses": losses,
                   "ms_per_step": statistics.median(walls[1:]) * 1e3,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "compute": "float32 (TF32 off)"}
        emit("taming_gpt_step", card=card, **gpt_row)
        del opt
        gpt.eval()

        # -- cached decode ≡ forward at full width -------------------------------
        c_ids = n2n.encode_to_c(c)
        z = n2n.encode_to_z(x)
        with torch.no_grad():
            full = gpt(torch.cat([c_ids, z], 1)[:, :-1])
            logits, cache, n0 = gpt.prefill(c_ids, gpt.init_cache(b))
            err = (logits - full[:, n0 - 1]).abs().max().item()
            for i in range(z.shape[1] - 1):
                logits, cache = gpt.decode_one(z[:, i:i + 1], n0 + i, cache)
                err = max(err, (logits - full[:, n0 + i]).abs().max().item())
        check(err <= 1e-3, f"GPT cached decode vs forward: max abs err {err} > 1e-3")
        del cache, full

        # -- sampling: 256 tokens at batch 8, top-k -------------------------------
        gen = torch.Generator("cuda").manual_seed(SMOKE_SEED)
        dec.launches = 0                                 # the sampling path starts here
        k1_before = fa.fwd_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs, zs = n2n.sample(c, 256, top_k=GPT_TOP_K, generator=gen, return_ids=True)
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        k2_launches = dec.launches
        check(k2_launches == gcfg.n_layer * 255,
              f"Net2Net sampling launched K2 {k2_launches} times, expected "
              f"{gcfg.n_layer * 255}")
        check(fa.fwd_launches == k1_before, "sampling launched K1")
        check(tuple(imgs.shape) == (b, 256, 256, 3) and bool(torch.isfinite(imgs).all())
              and int(zs.max()) < cfg.n_embed, "Net2Net sample: images or codes")
        sampler = make_sampler(gpt, 256, top_k=GPT_TOP_K, vocab_limit=cfg.n_embed)
        saved = dec.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler(c_ids, generator=gen)
        torch.cuda.synchronize()
        tokens_s = time.perf_counter() - t0
        dec.launches = saved
        sample_row = {"batch": b, "tokens": 256, "prompt": int(c_ids.shape[1]),
                      "top_k": GPT_TOP_K, "k2_launches": k2_launches,
                      "wall_s_with_decode": sample_s, "ms_per_token": tokens_s * 1e3 / 256,
                      "distinct_codes": int(torch.unique(zs).numel()),
                      "decode_vs_forward_max_abs_err": err}
        emit("taming_gpt_sample", card=card, **sample_row)
        del gpt, n2n, model
        torch.cuda.empty_cache()

        # -- DALL·E over the VQGAN from the command line (phase cli's depth) -----
        vq_flags = ["--vqgan_model_path", ckpt, "--vqgan_config_path", yml]
        dalle_dir, outs = os.path.join(work, "dalle"), os.path.join(work, "outputs")
        fa.fwd_launches = fa.bwd_launches = 0
        t0 = time.perf_counter()
        rc = train_dalle.main(["--synthetic", "--image_size", str(cfg.resolution), "--dim",
                               "1792", "--depth", str(CLI_DEPTH), "--heads", "14",
                               "--dim_head", "128", "--text_seq_len", "256", "--batch_size",
                               str(b), "--steps", "1", "--no_preflight", "--output_dir",
                               dalle_dir, "--seed", str(SMOKE_SEED)] + vq_flags)
        train_s = time.perf_counter() - t0
        check(rc == 0 and fa.fwd_launches > 0 and fa.bwd_launches == CLI_DEPTH,
              f"train_dalle over the VQGAN: rc {rc}, K1 {fa.fwd_launches} / "
              f"{fa.bwd_launches}")
        meta = CheckpointManager(dalle_dir).load_metadata()
        check(meta["vae_class_name"] == "VQGanVAE", f"vae {meta['vae_class_name']}")
        dec.launches = 0
        t0 = time.perf_counter()
        rc = generate.main(["--dalle_path", dalle_dir, "--text", "a red circle",
                            "--num_images", str(b), "--batch_size", str(b), "--bf16",
                            "--outputs_dir", outs] + vq_flags)
        gen_s = time.perf_counter() - t0
        cli_k2 = dec.launches
        pngs = sorted(os.path.join(d, f) for d, _, fs in os.walk(outs) for f in fs)
        check(rc == 0 and len(pngs) == b and cli_k2 == CLI_DEPTH * 255,
              f"generate over the VQGAN: rc {rc}, {len(pngs)} PNGs, K2 {cli_k2}")
        check(all(read_png(p).shape == (256, 256, 3) for p in pngs), "PNG shapes")
        emit("taming_dalle_cli", depth=CLI_DEPTH, train_dalle_s=train_s, generate_s=gen_s,
             images=len(pngs), k2_launches=cli_k2, card=card)
        out = {"vqgan": vq_row, "gpt": gpt_row, "sample": sample_row, "k2": k2_row,
               "k2_launches": k2_launches, "k2_launches_cli": cli_k2}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("taming_done", seconds=time.perf_counter() - t_phase)
    return out


REVERSIBLE_STEPS = 6
# the reversible step's gradients against the naive coupling's (autograd
# through stored activations, the same kernels), at full width and depth 2.
# f32 compute: the coupling inverts exactly up to f32 rounding, and K1's bf16
# roundings may flip where the recomputed inputs differ in their last bits
# (tests/test_torch_cuda.py's tolerance for such flips), 1e-2 of each
# tensor's largest gradient. bf16 compute: the inversion rounds in bf16, so
# each tensor's gradient is held to the f32 step's no farther than the naive
# bf16 step's is, plus 2^-5 of that tensor's largest. The loss is the same
# forward: 1e-6 relative.
REV_F32_TOL = 1e-2
REV_BF16_MARGIN = 2.0 ** -5
REV_LOSS_TOL = 1e-6


def _naive(transformer):
    forward = type(transformer).forward

    def run(x, key_mask=None, dropout_masks=None):
        return forward(transformer, x, key_mask, dropout_masks, reversible_naive=True)
    return run


def _shares(got, want):
    """Each tensor's max |got - want| over its largest |want|."""
    return {n: ((got[n] - g).abs().max() / (g.abs().max() + 1e-8)).item()
            for n, g in want.items()}


def _reversible_parity(torch, tc):
    """Full width, depth 2: the reversible step's loss and gradients against
    the naive coupling's, in f32 and in bf16 compute (module constants)."""
    from dalle_tpu_torch import DalleTrainer, PrecisionConfig, dalle_1p4b
    grads, losses = {}, {}
    for compute in ("float32", "bfloat16"):
        tr = DalleTrainer(dalle_1p4b(depth=2, reversible=True),
                          dataclasses.replace(tc, precision=PrecisionConfig(compute=compute)))
        text, img = _train_batch(tr.model_cfg, tc.batch_size, SMOKE_SEED)
        text, img = torch.from_numpy(text).cuda(), torch.from_numpy(img).cuda()
        for naive in (False, True):
            tr.optimizer.zero_grad()
            if naive:
                tr.model.transformer.forward = _naive(tr.model.transformer)
            loss, _ = tr.loss_and_backward(text, img)
            losses[compute, naive] = loss.item()
            grads[compute, naive] = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
        del tr
        torch.cuda.empty_cache()
    f32 = _shares(grads["float32", False], grads["float32", True])
    rev16 = _shares(grads["bfloat16", False], grads["float32", True])
    naive16 = _shares(grads["bfloat16", True], grads["float32", True])
    excess = {n: rev16[n] - naive16[n] for n in rev16}
    loss_rel = {c: abs(losses[c, False] - losses[c, True]) / abs(losses[c, True])
                for c in ("float32", "bfloat16")}
    row = {"losses": {f"{c}/{'naive' if n else 'reversible'}": v
                      for (c, n), v in losses.items()},
           "f32_worst_share": max(f32.values()), "f32_tolerance": REV_F32_TOL,
           "bf16_worst_excess_over_naive": max(excess.values()),
           "bf16_margin": REV_BF16_MARGIN,
           "bf16_reversible_vs_naive_worst_share": max(_shares(
               grads["bfloat16", False], grads["bfloat16", True]).values()),
           "bf16_naive_vs_f32_worst_share": max(naive16.values()),
           "loss_rel_err": loss_rel, "loss_tolerance": REV_LOSS_TOL}
    check(row["f32_worst_share"] <= REV_F32_TOL,
          f"reversible f32 gradients: worst {row['f32_worst_share']} of a tensor's largest "
          f"> {REV_F32_TOL}")
    check(row["bf16_worst_excess_over_naive"] <= REV_BF16_MARGIN,
          f"reversible bf16 gradients: {row['bf16_worst_excess_over_naive']} farther from "
          f"the f32 step than the naive bf16 step's > {REV_BF16_MARGIN}")
    check(max(loss_rel.values()) <= REV_LOSS_TOL, f"reversible loss: {loss_rel}")
    return row


def phase_reversible(torch, card, seq_row):
    from dalle_tpu_torch import DalleTrainer, OptimConfig, TrainConfig, dalle_1p4b
    from dalle_tpu_torch.ops import fused_attention as fa
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    b = 8
    tc = TrainConfig(batch_size=b, seed=SMOKE_SEED,
                     optim=OptimConfig(optimizer="adam", learning_rate=3e-4, grad_clip_norm=0.5))
    parity = _reversible_parity(torch, tc)
    emit("reversible_parity", depth=2, dim=dalle_1p4b().dim, **parity)

    # -- the reversible 1.4B step ----------------------------------------------
    cfg = dalle_1p4b(reversible=True)
    tr = DalleTrainer(cfg, tc)
    text, img = _train_batch(cfg, b, SMOKE_SEED)
    text, img = torch.from_numpy(text).cuda(), torch.from_numpy(img).cuda()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    fa.fwd_launches = fa.bwd_launches = 0          # the reversible path starts here
    for _ in range(REVERSIBLE_STEPS):
        t0 = time.perf_counter()
        m = tr.train_step(text, img)
        walls.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    launches = {"fused_attention_fwd": fa.fwd_launches, "fused_attention_bwd": fa.bwd_launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"reversible losses: {losses}")
    want = {"fused_attention_fwd": 2 * cfg.depth * REVERSIBLE_STEPS,
            "fused_attention_bwd": cfg.depth * REVERSIBLE_STEPS}
    check(launches == want, f"reversible K1 launches {launches}, expected {want}")

    # K1's kernels in one profiled step: the forward's 24, the recompute's 24,
    # and the backward's dq and dk/dv kernels
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    saved = fa.fwd_launches, fa.bwd_launches
    with torch.profiler.profile(activities=acts) as prof:
        tr.train_step(text, img)
    fa.fwd_launches, fa.bwd_launches = saved
    kernels = {w: sum(1 for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and f"::{w}_kernel<" in e.name) for w in ("fwd", "dq", "dkv")}
    check(kernels == {"fwd": 2 * cfg.depth, "dq": cfg.depth, "dkv": cfg.depth},
          f"the profiler counted K1's kernels {kernels} in one reversible step")
    dev_us, _ = device_time(torch, prof)

    # what the forward and backward hold above the masters and the optimizer
    # state, on the same weights: reversible, the naive coupling, the
    # sequential stack as phase train runs it (no remat) and with remat
    tcfg = tr.model.transformer.cfg
    act_peak = {}
    for mode in ("reversible", "naive", "sequential", "sequential_remat"):
        if mode == "naive":
            tr.model.transformer.forward = _naive(tr.model.transformer)
        if mode == "sequential":
            del tr.model.transformer.forward
            tr.model.transformer.cfg = dataclasses.replace(tcfg, reversible=False)
        if mode == "sequential_remat":
            tr.model.transformer.cfg = dataclasses.replace(tcfg, reversible=False,
                                                           use_remat=True)
        tr.optimizer.zero_grad()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr.loss_and_backward(text, img)
        torch.cuda.synchronize()
        act_peak[mode] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    tr.model.transformer.cfg = tcfg
    ms = statistics.median(walls[1:]) * 1e3
    row = dict(batch=b, steps=REVERSIBLE_STEPS, losses=losses, ms_per_step=ms,
               ms_per_step_first=walls[0] * 1e3,
               sequential_ms_per_step=seq_row["ms_per_step"],
               tokens_per_s=b * cfg.total_seq_len / ms * 1e3, peak_gib=peak,
               sequential_peak_gib=seq_row["peak_gib"], launches=launches,
               profiler_k1_kernels=kernels,
               device_ms=dev_us / 1e3 if dev_us else "not measured",
               step_peak_above_state_gib=act_peak, card=card)
    emit("reversible", **row)
    del tr
    torch.cuda.empty_cache()
    emit("reversible_done", seconds=time.perf_counter() - t_phase)
    return launches, row


# ---------------------------------------------------------------------------
# the training path's telemetry and model health
# ---------------------------------------------------------------------------

TRAIN_OBS_STEPS = 4          # fit steps a turn; turns: off, on, on, off
TRAIN_OBS_PROFILE = 3        # the step of an "on" turn that profile_step profiles
# DALL·E's layer groups at depth 1, the JAX package's (tests/test_torch_health.py)
TRAIN_OBS_GROUPS = ("final_norm", "image_emb", "text_emb", "to_logits", "transformer")
# the taps against a float64 recompute of the same step on the card,
# relative: the taps sum f32 squares a tensor, then a group; the update is
# the f32 difference of the masters, whose rounding (~6e-8 of |p| an
# element) is far below 1e-3 of Adam's ~lr·|p| steps
TAP_TOL = {"grad_norm": 1e-4, "param_norm": 1e-4, "update_ratio": 1e-3}


class _StampedWriter:
    """A fit metrics writer that stamps each record with the host's clock."""

    def __init__(self):
        self.records = []

    def log(self, step, metrics):
        self.records.append((step, time.perf_counter(), metrics))


def _bits_equal(torch, a, b) -> bool:
    """Two tensors equal bit for bit, NaN included."""
    if a.dtype in (torch.float32, torch.bfloat16, torch.float16):
        view = torch.int32 if a.dtype == torch.float32 else torch.int16
        return torch.equal(a.view(view), b.to(a.device).view(view))
    return torch.equal(a, b.to(a.device))


def _f64_taps(torch, tr, batch):
    """One ``train_step`` of ``tr`` with its f64 reference: the gradient's
    Σg² a group (read before the optimizer, which clips in place), and
    after the step Σp² and Σ(p_new - p_old)² a group, in float64 on the
    card. → (metrics, {metric: {group: value}})."""
    from dalle_tpu_torch.convert import flax_path
    named = list(tr.model.named_parameters())
    group = [flax_path(tr.model, n)[0] for n, _ in named]
    ref = {"grad": {}, "old": None}

    def hook(trainer):
        for g, (_, p) in zip(group, named):
            ref["grad"][g] = ref["grad"].get(g, 0.0) + p.grad.double().square().sum()
        ref["old"] = [p.detach().clone() for _, p in named]
    tr.grad_hook = hook
    try:
        m = tr.train_step(*batch)
    finally:
        tr.grad_hook = None
    psq, usq = {}, {}
    with torch.no_grad():
        for g, (_, p), old in zip(group, named, ref["old"]):
            new = p.detach().double()
            psq[g] = psq.get(g, 0.0) + new.square().sum()
            usq[g] = usq.get(g, 0.0) + (new - old.double()).square().sum()
    want = {"grad_norm": {g: v.sqrt().item() for g, v in ref["grad"].items()},
            "param_norm": {g: v.sqrt().item() for g, v in psq.items()}}
    want["update_ratio"] = {g: usq[g].sqrt().item() / (want["param_norm"][g] + 1e-12)
                            for g in usq}
    return m, want


def phase_train_obs(torch, card):
    """The training path's telemetry and model health at DALL·E-1.4B (the
    module docstring, phase 28)."""
    import contextlib
    import io
    import os
    import shutil

    import numpy as np

    from dalle_tpu_torch import (DalleTrainer, DVAEConfig, ObsConfig, OptimConfig,
                                 TrainConfig, VAETrainer, VQGANConfig, VQGANTrainer,
                                 dalle_1p4b, obs)
    from dalle_tpu_torch.cli import obs_report, train_dalle
    from dalle_tpu_torch.data.synthetic import ShapesDataset
    from dalle_tpu_torch.models.gan import GANLossConfig
    from dalle_tpu_torch.ops import fused_attention as fa
    from dalle_tpu_torch.train.actions import BreachActions

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_obs_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = dalle_1p4b()
    b = 8
    base = TrainConfig(batch_size=b, seed=SMOKE_SEED, log_every=1, nan_rollback=False,
                       runtime_lr_scale=True, checkpoint_dir=work, preflight_checkpoint=False,
                       save_every_steps=0,
                       optim=OptimConfig(learning_rate=3e-4, grad_clip_norm=0.5))
    # the textfile is written at each device poll: every 4 steps, so the last
    # one carries the health gauges the sentry published since step 1
    on_obs = ObsConfig(trace=True, trace_dir=os.path.join(work, "obs"), health=True,
                       watchdog_deadline_s=120.0, device_poll_every=4,
                       prometheus_path=os.path.join(work, "dalle.prom"))
    trainers = {False: DalleTrainer(cfg, base),
                True: DalleTrainer(cfg, dataclasses.replace(base, obs=on_obs))}
    for tr in trainers.values():
        # no checkpoints here (one at 1.4B is ~17 GB); profile_step still
        # writes under checkpoint_dir
        tr.ckpt = None
    on_tr = trainers[True]
    BreachActions(on_tr, log=print).attach()
    batches = [_train_batch(cfg, b, SMOKE_SEED + 40 + i) for i in range(2 * TRAIN_OBS_STEPS + 4)]
    out = {"card": card}
    torch.cuda.synchronize()
    try:
        # -- fit in turns: off, on, on, off -------------------------------------
        turns = []
        fa.fwd_launches = fa.bwd_launches = 0            # the main path starts here
        for on in (False, True, True, False):
            tr = trainers[on]
            first = tr.step
            if on:
                tr.train_cfg = dataclasses.replace(tr.train_cfg,
                                                   profile_step=first + TRAIN_OBS_PROFILE)
            w = _StampedWriter()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.fit(iter(batches[first:first + TRAIN_OBS_STEPS]), log=lambda *a: None,
                   metrics_writer=w)
            wall = time.perf_counter() - t0
            steps = [s for s, _, _ in w.records]
            check(steps == list(range(first + 1, first + TRAIN_OBS_STEPS + 1)),
                  f"train_obs: records of steps {steps}")
            stamps = [t for _, t, _ in w.records]
            per = [(z - a) * 1e3 for s, a, z in zip(steps[1:], stamps, stamps[1:])
                   if not (on and s == first + TRAIN_OBS_PROFILE)]
            if on:
                last_on = w.records[-1][2]
            turns.append({"taps": on, "steps": steps, "ms_per_step": per,
                          "median_ms": statistics.median(per), "wall_s": wall,
                          "losses": [m["loss"] for _, _, m in w.records]})
        launches = {"fused_attention_fwd": fa.fwd_launches,
                    "fused_attention_bwd": fa.bwd_launches}
        n_steps = 4 * TRAIN_OBS_STEPS
        for name, n in launches.items():
            check(n == n_steps * cfg.depth, f"train_obs: {name} launched {n} times in "
                                            f"{n_steps} steps")
        for t in turns:
            check(all(math.isfinite(x) for x in t["losses"]), f"train_obs: losses {t}")
        off_ms = [x for t in turns if not t["taps"] for x in t["ms_per_step"]]
        on_ms = [x for t in turns if t["taps"] for x in t["ms_per_step"]]
        out["cost"] = {"alloc_retries_after_turns": torch.cuda.memory_stats().get(
                           "num_alloc_retries"),
                       "turns": [{k: t[k] for k in ("taps", "median_ms", "ms_per_step",
                                                     "wall_s")} for t in turns],
                       "off_median_ms": statistics.median(off_ms),
                       "on_median_ms": statistics.median(on_ms)}

        # -- what the "on" turns recorded ---------------------------------------
        spans = [json.loads(line)["name"] for line in open(os.path.join(work, "obs",
                                                                        "spans.jsonl"))]
        counts = {n: spans.count(n) for n in sorted(set(spans))
                  if n.startswith(("fit/", "ckpt/", "dalle/", "data/"))}
        check(counts.get("fit/dispatch") == 2 * TRAIN_OBS_STEPS
              and counts.get("fit/sync") == 2 * TRAIN_OBS_STEPS
              and counts.get("fit/step", 0) >= 2 * TRAIN_OBS_STEPS
              and counts.get("fit/batch_wait", 0) >= 2 * TRAIN_OBS_STEPS,
              f"train_obs: span counts {counts}")
        cols = sorted(k for k in last_on if k.startswith("health/") and k.count("/") == 2)
        want_cols = sorted(f"health/{m}/{g}" for m in ("grad_norm", "param_norm",
                                                       "update_ratio", "nonfinite_frac")
                           for g in TRAIN_OBS_GROUPS)
        check(cols == want_cols, f"train_obs: health columns {cols}")
        prom = open(on_obs.prometheus_path).read()
        check("dalle_t_dispatch_s " in prom
              and 'dalle_health_grad_norm{layer_group="transformer"}' in prom,
              "train_obs: the Prometheus textfile lacks the breakdown or the health gauges")
        wd = on_tr.last_watchdog
        check(wd is not None and wd.stall_count == 0, "train_obs: the watchdog fired")
        k1 = {}
        for step in (TRAIN_OBS_PROFILE, TRAIN_OBS_STEPS + TRAIN_OBS_PROFILE):
            doc = json.load(open(os.path.join(work, f"profile_step{step}", "trace.json")))
            names = [e.get("name", "") for e in doc.get("traceEvents", [])
                     if e.get("cat") == "kernel"]
            k1[step] = {w_: sum(f"::{w_}_kernel<" in n for n in names)
                        for w_ in ("fwd", "dq", "dkv")}
            check(k1[step] == {"fwd": cfg.depth, "dq": cfg.depth, "dkv": cfg.depth},
                  f"train_obs: K1 kernels in profile_step{step}'s trace: {k1[step]}")
        out.update(spans=counts, health_columns=cols, k1_in_profiled_step=k1,
                   watchdog_stalls=wd.stall_count)

        # -- where the "on" step's time goes: one profiled step of each --------
        text, img = (torch.from_numpy(x).cuda() for x in batches[2 * TRAIN_OBS_STEPS])
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        prof_rows = {}
        for on in (False, True):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                trainers[on].train_step(text, img)
                wall = time.perf_counter() - t0
            dev_us, by_kernel = device_time(torch, prof)
            host = {e.key: e.self_cpu_time_total for e in prof.key_averages()}
            prof_rows[on] = (wall * 1e3, dev_us / 1e3, by_kernel, host)
        kdelta = {k: (prof_rows[True][2].get(k, 0.0) - prof_rows[False][2].get(k, 0.0)) / 1e3
                  for k in set(prof_rows[True][2]) | set(prof_rows[False][2])}
        hdelta = {k: (prof_rows[True][3].get(k, 0.0) - prof_rows[False][3].get(k, 0.0)) / 1e3
                  for k in set(prof_rows[True][3]) | set(prof_rows[False][3])}
        out["profiled_step"] = {
            "wall_ms": {"off": prof_rows[False][0], "on": prof_rows[True][0]},
            "device_ms": {"off": prof_rows[False][1], "on": prof_rows[True][1]},
            "kernel_ms_grown_most": dict(sorted(kdelta.items(), key=lambda kv: -kv[1])[:8]),
            "host_self_ms_grown_most": dict(sorted(hdelta.items(), key=lambda kv: -kv[1])[:8]),
            "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries"),
            "max_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}

        # -- synchronising calls a step, off and on -------------------------------
        syncs = {}
        for on in (False, True):
            places, _outside = _sync_calls(
                torch, lambda tr=trainers[on]: tr.train_step(text, img))
            syncs[on] = [p for p, _ in places]
        check(len(syncs[True]) == len(syncs[False]) == 1,
              f"train_obs: synchronising calls a step {syncs}")
        out["sync_calls_a_step"] = {"off": syncs[False], "on": syncs[True]}

        # -- the taps against float64, then on ≡ off bit for bit ------------------
        trainers[False].train_step(*batches[2 * TRAIN_OBS_STEPS + 1])
        m, want = _f64_taps(torch, on_tr, batches[2 * TRAIN_OBS_STEPS + 1])
        errs = {}
        for metric, by_group in want.items():
            for g, ref in by_group.items():
                got = m[f"health/{metric}/{g}"]
                errs[f"{metric}/{g}"] = abs(got - ref) / max(abs(ref), 1e-30)
                check(errs[f"{metric}/{g}"] <= TAP_TOL[metric],
                      f"train_obs: {metric}/{g} {got} against float64 {ref}")
        for (name, a), (_, p) in zip(trainers[False].model.named_parameters(),
                                     on_tr.model.named_parameters()):
            check(_bits_equal(torch, a.detach(), p.detach()),
                  f"train_obs: {name} differs with the taps on")
        opt_off, opt_on = trainers[False].optimizer.state_dict(), on_tr.optimizer.state_dict()
        for k, lst in opt_off["core"].items():
            for i, (a, p) in enumerate(zip(lst, opt_on["core"][k])):
                check(_bits_equal(torch, a, p), f"train_obs: optimizer {k}[{i}] differs")
        out["taps_vs_float64"] = {"max_rel_err": {mt: max(v for k, v in errs.items()
                                                          if k.startswith(mt + "/"))
                                                  for mt in TAP_TOL},
                                  "tolerance": TAP_TOL}
        out["on_equals_off"] = f"bitwise after {on_tr.step} steps"
        del trainers[False]
        torch.cuda.empty_cache()

        # -- the breach rung --------------------------------------------------------
        on_tr.health_sentry = None
        # the precursor's action alone, once: the inf also trips grad-explosion,
        # and the next step's NaN spreads to every group
        rung_actions = BreachActions(on_tr, policy={"nan-precursor": "preemptive_snapshot"},
                                     cooldown_steps=100, log=print).attach()
        target = on_tr.model.transformer.attn_0.to_qkv.weight

        def poison(trainer):
            target.grad[0, 0] = float("inf")
        on_tr.grad_hook = poison
        try:
            m = on_tr.train_step(*batches[2 * TRAIN_OBS_STEPS + 2])
        finally:
            on_tr.grad_hook = None
        breach_step = on_tr.step
        frac = m["health/nonfinite_frac/transformer"]
        check(frac > 0, f"train_obs: nonfinite_frac/transformer {frac}")
        check(rung_actions.fired == [(breach_step, "preemptive_snapshot", "nan-precursor",
                                      "transformer")],
              f"train_obs: actions fired {rung_actions.fired}")
        rung = on_tr._preemptive[2]
        on_tr.train_step(*batches[2 * TRAIN_OBS_STEPS + 3])
        restored = on_tr._rollback()
        check(restored == breach_step, f"train_obs: rolled back to step {restored}")
        live = on_tr.model.state_dict()
        for name, t in rung["model"].items():
            check(_bits_equal(torch, live[name], t), f"train_obs: {name} not restored")
        check(on_tr._preemptive is None, "train_obs: the rung was not consumed")
        out["breach"] = {"step": breach_step, "nonfinite_frac_transformer": frac,
                         "breach_detector": m.get("health/breach_detector"),
                         "snapshot": on_tr.last_preemptive, "restored_step": restored}
        del on_tr, trainers, rung, live
        torch.cuda.empty_cache()

        # -- the dVAE and the VQGAN with their codebook taps -------------------------
        ds = ShapesDataset(image_size=128)
        vt = VAETrainer(DVAEConfig(), TrainConfig(batch_size=b, seed=SMOKE_SEED,
                                                  obs=ObsConfig(health=True)))
        vm = vt.train_step(ds.as_arrays(limit=b)[0])
        vae_cols = {k: v for k, v in vm.items() if k.startswith("health/")
                    and "/" not in k[len("health/"):]}
        check(set(vae_cols) >= {"health/codebook_perplexity", "health/codebook_dead_frac",
                                "health/codebook_usage_entropy", "health/gumbel_temp",
                                "health/st_sharpness", "health/encoder_confidence"}
              and all(math.isfinite(v) for v in vae_cols.values())
              and 1.0 <= vae_cols["health/codebook_perplexity"] <= DVAEConfig().num_tokens,
              f"train_obs: dVAE taps {vae_cols}")
        del vt
        torch.cuda.empty_cache()
        qcfg = VQGANConfig()                      # taming's vqgan_imagenet_f16_1024
        qt = VQGANTrainer(qcfg, TrainConfig(batch_size=TAMING_BATCH, seed=SMOKE_SEED,
                                            obs=ObsConfig(health=True),
                                            optim=OptimConfig(learning_rate=4.5e-6 * TAMING_BATCH,
                                                              beta1=0.5, beta2=0.9,
                                                              grad_clip_norm=0.0)),
                          GANLossConfig(disc_start=0))
        images = ShapesDataset(qcfg.resolution).as_arrays(limit=TAMING_BATCH)[0] * 2.0 - 1.0
        for _ in range(2):
            qm = qt.train_step(images)
        q_cols = {k: v for k, v in qm.items() if k.startswith("health/")}
        groups = sorted({k.split("/", 2)[2] for k in q_cols if k.count("/") >= 2})
        check(all(math.isfinite(v) for v in q_cols.values())
              and "health/codebook_perplexity" in q_cols
              and any(g.startswith("gen/") for g in groups)
              and any(g.startswith("disc/") for g in groups),
              f"train_obs: VQGAN taps {sorted(q_cols)}")
        out["other_models"] = {"dvae": vae_cols,
                               "vqgan": {k: v for k, v in q_cols.items()
                                         if k.count("/") == 1},
                               "vqgan_groups": groups}
        del qt
        torch.cuda.empty_cache()

        # -- the command line with every telemetry flag, then obs_report -------------
        cli_dir = os.path.join(work, "cli")
        argv = ["--synthetic", "--image_size", "128", "--untrained_vae",
                "--untrained_vae_tokens", "8192", "--untrained_vae_layers", "3",
                "--dim", "1792", "--depth", str(CLI_DEPTH), "--heads", "14",
                "--dim_head", "128", "--text_seq_len", "256", "--batch_size", "8",
                "--output_dir", cli_dir, "--seed", str(SMOKE_SEED), "--steps", "2",
                "--no_preflight", "--trace", "--health", "--breach_actions",
                "--prometheus_path", os.path.join(cli_dir, "dalle.prom"),
                "--watchdog_deadline_s", "120"]
        fa.fwd_launches = fa.bwd_launches = 0
        t0 = time.perf_counter()
        try:
            rc = train_dalle.main(argv)
        finally:
            obs.disable()
            obs.disable_recorder()
        cli_s = time.perf_counter() - t0
        check(rc == 0, f"train_obs: train_dalle exited {rc}")
        cli_launches = {"fused_attention_fwd": fa.fwd_launches,
                        "fused_attention_bwd": fa.bwd_launches}
        # the entry point keeps the JAX default use_remat=True: the backward
        # recomputes each layer's forward
        check(cli_launches == {"fused_attention_fwd": 4 * CLI_DEPTH,
                               "fused_attention_bwd": 2 * CLI_DEPTH},
              f"train_obs: K1 in the CLI run {cli_launches}")
        reports = {}
        for name, path in (("metrics", cli_dir), ("spans", os.path.join(cli_dir, "obs"))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = obs_report.main([path, "--top", "5"])
            check(rc == 0, f"train_obs: obs_report {name} exited {rc}")
            reports[name] = buf.getvalue()
        verdict = [line for line in reports["metrics"].splitlines() if "MODEL-HEALTH" in line]
        check(verdict and "fit/step" in reports["spans"],
              "train_obs: obs_report lacks the MODEL-HEALTH verdict or the fit spans")
        out["cli"] = {"seconds": cli_s, "launches": cli_launches, "verdict": verdict[0],
                      "report_lines": len(reports["metrics"].splitlines())
                      + len(reports["spans"].splitlines())}
    finally:
        obs.disable()
        obs.disable_recorder()
        shutil.rmtree(work, ignore_errors=True)
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit("train_obs", **out)
    print(reports["metrics"], flush=True)
    return launches, out


# ---------------------------------------------------------------------------
# training from real data: the image codec, the loaders, async checkpoints,
# the signal handlers
# ---------------------------------------------------------------------------

DATA_IMAGES = 64                 # captioned images in the phase's folder
JPEG_MAX, JPEG_MEAN = 3, 0.5     # levels: the CPU tests' bound on the codec against PIL
WITH_VAE_LOSS_TOL = 2e-2         # DalleWithVae.loss (f32) against the bf16 step's, relative
CKPT_MAX_WRITE_S = 40.0          # a depth-24 write predicted slower drops to CKPT_SMALL_DEPTH
CKPT_SMALL_DEPTH = 6
CKPT_PRIOR_GB_PER_S = 0.55       # a synced save's rate, phase cli (PERF.md §5)


def _pairs_folder(np, folder, fixtures, n, seed):
    """``n`` captioned images of mixed sizes around 256 px in ``folder``:
    PNGs and BMPs from the port's writers, and the committed JPEG
    fixtures copied in. → rows (key, ext, bytes, caption)."""
    import os
    from dalle_tpu_torch.data import image_codec as ic
    jpegs = sorted(f for f in os.listdir(fixtures) if f.endswith(".jpg"))
    rng = np.random.RandomState(seed)
    words = ["red", "blue", "green", "yellow", "circle", "square", "ring", "small", "large"]
    os.makedirs(folder)
    rows = []
    for i in range(n):
        if i % 6 == 5:
            ext = "jpg"
            with open(os.path.join(fixtures, jpegs[(i // 6) % len(jpegs)]), "rb") as f:
                data = f.read()
        else:
            h, w = (int(v) for v in rng.randint(200, 312, 2))
            y, x = np.mgrid[0:h, 0:w]
            c = rng.randint(0, 256, 3)
            img = np.stack([(x * 255 // w + c[0]) % 256, (y * 255 // h + c[1]) % 256,
                            ((x + y) // 4 + c[2]) % 256], -1)
            img = np.clip(img + rng.randint(-12, 13, img.shape), 0, 255).astype(np.uint8)
            ext = "png" if i % 2 == 0 else "bmp"
            data = ic.encode_png(img) if ext == "png" else ic.encode_bmp(img)
        caption = " ".join(rng.choice(words, 3))
        with open(os.path.join(folder, f"img{i:03d}.{ext}"), "wb") as f:
            f.write(data)
        with open(os.path.join(folder, f"img{i:03d}.txt"), "w") as f:
            f.write(f"a {caption}\n{caption} picture\n")
        rows.append((f"img{i:03d}", ext, data, f"a {caption}"))
    return rows


def phase_train_data(torch, card, k1_row):
    """Training from real data at DALL·E-1.4B (see the module's docstring,
    phase 29). ``k1_row``: phase train's row, beside which the step is
    reported."""
    import contextlib
    import io
    import itertools
    import os
    import shutil
    import signal

    import numpy as np

    from dalle_tpu_torch import (DalleTrainer, DalleWithVae, DiscreteVAEAdapter, DVAEConfig,
                                 OptimConfig, TrainConfig, dalle_1p4b)
    from dalle_tpu_torch.cli import train_clip, train_dalle, train_vae, train_vqgan
    from dalle_tpu_torch.cli._common import upload_images
    from dalle_tpu_torch.data import image_codec as ic
    from dalle_tpu_torch.data.text_image import TextImageDataset
    from dalle_tpu_torch.data.webdataset import write_shards
    from dalle_tpu_torch.models.dvae import init_dvae
    from dalle_tpu_torch.ops import fused_attention as fa
    from dalle_tpu_torch.text.tokenizer import SimpleTokenizer
    from dalle_tpu_torch.train import checkpoints as ck

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    fixtures = os.path.join(root, "tests", "torch_fixtures")
    work = os.path.join(root, "build", "train_data_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    try:
        # -- the codec: built here from its source, held to PIL's decodes ----
        t0 = time.perf_counter()
        lib = ic.build()
        build_s = time.perf_counter() - t0
        errs = {}
        for name in sorted(f[:-4] for f in os.listdir(fixtures) if f.endswith(".jpg")):
            with open(os.path.join(fixtures, name + ".jpg"), "rb") as f:
                got = ic.decode(f.read(), name).astype(np.int64)
            d = np.abs(got - np.load(os.path.join(fixtures, name + ".npy")))
            errs[name] = {"max": int(d.max()), "mean": float(d.mean())}
            check(d.max() <= JPEG_MAX and d.mean() <= JPEG_MEAN,
                  f"{name}: decode off PIL's by {errs[name]}")
        folder, shard_dir = os.path.join(work, "pairs"), os.path.join(work, "shards")
        rows = _pairs_folder(np, folder, fixtures, DATA_IMAGES, SMOKE_SEED)
        os.makedirs(shard_dir)
        shards = write_shards(
            ({"__key__": k, ("jpg" if e == "jpg" else "png"):
              d if e != "bmp" else ic.encode_png(ic.decode(d)), "txt": c}
             for k, e, d, c in rows), os.path.join(shard_dir, "pairs-{:02d}.tar"),
            samples_per_shard=DATA_IMAGES // 2)
        ds = TextImageDataset(folder, image_size=128, shuffle=True, seed=SMOKE_SEED)
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in itertools.islice(ds.batches(8), 8))
        loader_ms = (time.perf_counter() - t0) * 1e3 / n_batches
        emit("train_data_codec", library=os.path.basename(str(lib)), build_s=build_s,
             fixtures=errs, bound={"max": JPEG_MAX, "mean": JPEG_MEAN},
             images={e: sum(r[1] == e for r in rows) for e in ("png", "bmp", "jpg")},
             shards=len(shards), loader_ms_per_batch_of_8=loader_ms, card=card)

        # -- DALL·E-1.4B from the folder through fit --------------------------
        cfg = dalle_1p4b()
        vae = DiscreteVAEAdapter(init_dvae(DVAEConfig(), seed=SMOKE_SEED))
        tok = SimpleTokenizer()
        tc = TrainConfig(batch_size=8, seed=SMOKE_SEED, log_every=1,
                         optim=OptimConfig(optimizer="adam", learning_rate=3e-4,
                                           grad_clip_norm=0.5))
        tr = DalleTrainer(cfg, tc)
        ds = TextImageDataset(folder, image_size=128, shuffle=True, seed=SMOKE_SEED)

        def encoded():
            for imgs, caps in ds.batches(8):
                yield (tok.tokenize(caps, cfg.text_seq_len, truncate_text=True),
                       vae.get_codebook_indices(upload_images(imgs, "cuda")))
        writer = _StampedWriter()
        fa.fwd_launches = fa.bwd_launches = 0          # the real-data training path
        t0 = time.perf_counter()
        tr.fit(encoded(), steps=6, log=lambda *a: None, metrics_writer=writer)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {"fused_attention_fwd": fa.fwd_launches,
                    "fused_attention_bwd": fa.bwd_launches}
        for name, n in launches.items():
            check(n == 6 * cfg.depth, f"{name} launched {n} times in 6 fit steps")
        recs = [m for _, _, m in writer.records]
        stamps = [t for _, t, _ in writer.records]
        losses = [m["loss"] for m in recs]
        check(len(recs) == 6 and all(math.isfinite(x) for x in losses), f"losses {losses}")
        ms = statistics.median(np.diff(stamps)[1:]) * 1e3
        cols = {k: statistics.median(m[k] for m in recs[1:] if k in m)
                for k in ("t_batch_wait_s", "t_dispatch_s", "t_sync_s", "t_h2d_s",
                          "data_starvation")}
        more = encoded()
        places, outside = _sync_calls(torch, lambda: tr.train_step(*next(more)))
        row = dict(steps=6, batch=8, losses=losses, ms_per_step=ms,
                   ms_per_step_phase_train=k1_row["ms_per_step"], fit_s=fit_s,
                   breakdown_median=cols, launches=launches,
                   sync_calls_per_step=len(places), sync_places=places,
                   sync_outside=outside, card=card)
        emit("train_data_fit", **row)

        # -- DalleWithVae.loss from pixels on one batch, against the step ------
        imgs, caps = next(ds.batches(8))
        text = tok.tokenize(caps, cfg.text_seq_len, truncate_text=True)
        with torch.no_grad():
            wl, _ = DalleWithVae(tr.model, vae).loss(text, upload_images(imgs, "cuda"))
        step_loss = tr.train_step(text, vae.get_codebook_indices(upload_images(imgs, "cuda")))
        rel = abs(wl.item() - step_loss["loss"]) / abs(step_loss["loss"])
        check(rel <= WITH_VAE_LOSS_TOL, f"DalleWithVae.loss {wl.item()} against the step's "
                                        f"{step_loss['loss']}")
        emit("train_data_with_vae_loss", loss_f32=wl.item(), step_loss_bf16=step_loss["loss"],
             rel=rel, tol=WITH_VAE_LOSS_TOL, card=card)

        # -- an asynchronous checkpoint: the snapshot, the write, the restore ---
        state = tr.state_dict()
        nbytes = sum(t.numel() * t.element_size() for t in _tensors(torch, state))
        free = shutil.disk_usage(work).free
        depth = cfg.depth
        if nbytes / (CKPT_PRIOR_GB_PER_S * 1e9) > CKPT_MAX_WRITE_S or free < 2.5 * nbytes:
            depth = CKPT_SMALL_DEPTH
            del tr, state
            torch.cuda.empty_cache()
            tr = DalleTrainer(dataclasses.replace(cfg, depth=depth), tc)
            state = tr.state_dict()
            nbytes = sum(t.numel() * t.element_size() for t in _tensors(torch, state))
        # steps on one encoded batch, before the save and while its write is
        # in flight: does the writer thread hold the loop back?
        batch = next(more)

        def timed_step():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tr.train_step(*batch)
            return (time.perf_counter() - t1) * 1e3
        before = [timed_step() for _ in range(3)]
        # the host snapshot, timed: the manager's pinned staging area, whose
        # first take allocates and page-locks it (pageable memory, the
        # alternative it was chosen over, took 8.0-11.9 s; PERF.md §6)
        mgr = ck.CheckpointManager(os.path.join(work, "ckpt"), async_save=True)
        saved_step = tr.step
        state = tr.state_dict()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = mgr._snapshot.take(state)     # the save below refills these buffers
        snap_s = {"pinned_first": time.perf_counter() - t0}
        t0 = time.perf_counter()
        mgr.save(saved_step, state, tr._meta())
        block_s = time.perf_counter() - t0
        snap_s["pinned_reused"] = mgr.last_save["snapshot_s"]
        during = []
        while mgr._thread is not None and mgr._thread.is_alive() and len(during) < 8:
            during.append(timed_step())
        mgr.wait_until_finished()
        durable_s = mgr.last_save["write_s"]          # from the save's call to the rename
        write_s = durable_s - mgr.last_save["snapshot_s"]
        size = os.path.getsize(os.path.join(mgr.step_dir(saved_step), ck.STATE_FILE))
        del state
        t0 = time.perf_counter()
        saved, meta = mgr.restore(map_location="cpu", mmap=True)
        check_same_tree(torch, ref, saved, "the restored checkpoint")   # the staged copy
        restore_check_s = time.perf_counter() - t0
        check(meta["model_class"] == "DALLE" and meta["hparams"]["depth"] == depth,
              "the checkpoint's metadata")
        emit("train_data_checkpoint", depth=depth, bytes_state=nbytes, bytes_file=size,
             disk_free_bytes=free, snapshot_s=snap_s, save_blocked_s=block_s,
             save_to_durable_s=durable_s, write_s=write_s, write_gb_per_s=size / write_s / 1e9,
             synced_save_gb_per_s=CKPT_PRIOR_GB_PER_S,
             ms_per_step_before_write=before, ms_per_step_during_write=during,
             restore_and_compare_s=restore_check_s,
             bit_for_bit=True, card=card)
        del saved, ref, mgr, tr, vae
        torch.cuda.empty_cache()

        # -- the command line at depth 2, full width ---------------------------
        cli = os.path.join(work, "cli")
        base = ["--image_size", "128", "--untrained_vae", "--untrained_vae_tokens", "8192",
                "--untrained_vae_layers", "3", "--dim", "1792", "--depth", str(CLI_DEPTH),
                "--heads", "14", "--dim_head", "128", "--text_seq_len", "256",
                "--batch_size", "8", "--keep_n_checkpoints", "1", "--seed", str(SMOKE_SEED),
                "--no_preflight"]
        walls, cli_launches = {}, {}

        def run(name, main, argv, steps):
            out = os.path.join(cli, name)
            fa.fwd_launches = fa.bwd_launches = 0
            t0 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(argv + ["--output_dir", out, "--no_preemption_handler"])
            walls[name] = time.perf_counter() - t0
            cli_launches[name] = fa.fwd_launches + fa.bwd_launches
            check(rc == 0, f"{name} returned {rc}: {buf.getvalue()[-2000:]}")
            check(ck.CheckpointManager(out).latest_step() == steps,
                  f"{name}: checkpoint steps {ck.CheckpointManager(out).all_steps()}")
            return buf.getvalue()
        run("train_dalle_folder", train_dalle.main,
            base + ["--image_text_folder", folder, "--steps", "2"], 2)
        run("train_dalle_wds", train_dalle.main, base + ["--wds", shard_dir, "--steps", "2"], 2)
        check(cli_launches["train_dalle_folder"] >= 4 * CLI_DEPTH
              and cli_launches["train_dalle_wds"] >= 4 * CLI_DEPTH,
              f"K1 launches in the CLI runs: {cli_launches}")

        # SIGUSR1, then SIGTERM, to a train_dalle process; then --resume
        sig_dir = os.path.join(cli, "signals")
        log_path = os.path.join(work, "signals.log")
        cmd = [sys.executable, "-m", "dalle_tpu_torch.cli.train_dalle"] + base + [
            "--image_text_folder", folder, "--steps", "100000", "--output_dir", sig_dir,
            "--save_every_n_steps", "100000"]
        sig = {}
        with open(log_path, "w") as logf:
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, cwd=root, stdout=logf, stderr=subprocess.STDOUT)
            try:
                metrics = os.path.join(sig_dir, "metrics.jsonl")
                mgr = ck.CheckpointManager(sig_dir)
                deadline = time.time() + 300
                while not (os.path.exists(metrics) and os.path.getsize(metrics) > 0):
                    check(proc.poll() is None and time.time() < deadline,
                          f"train_dalle ended or stalled before its first step: "
                          f"{open(log_path).read()[-2000:]}")
                    time.sleep(0.1)
                sig["first_step_s"] = time.perf_counter() - t0
                proc.send_signal(signal.SIGUSR1)
                t1 = time.perf_counter()
                while not mgr.all_steps():
                    check(proc.poll() is None and time.time() < deadline,
                          f"no SIGUSR1 checkpoint: {open(log_path).read()[-2000:]}")
                    time.sleep(0.05)
                sig["usr1_step"] = mgr.all_steps()[0]
                sig["usr1_durable_s"] = time.perf_counter() - t1
                proc.send_signal(signal.SIGTERM)
                t1 = time.perf_counter()
                rc = proc.wait(timeout=300)
                sig["term_exit_s"] = time.perf_counter() - t1
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        text = open(log_path).read()
        check(rc == 0, f"train_dalle exited {rc} on SIGTERM: {text[-2000:]}")
        step = mgr.latest_step()
        names = os.listdir(sig_dir)
        check(step is not None and step >= sig["usr1_step"]
              and f"preempted at step {step}" in text
              and not any(".tmp-" in n for n in names), f"after SIGTERM: {names} {text[-2000:]}")
        sig["term_step"] = step
        out = run("signals", train_dalle.main,
                  base + ["--image_text_folder", folder, "--steps", str(step + 1), "--resume"],
                  step + 1)
        check(f"resumed at step {step}" in out, f"--resume: {out[-2000:]}")
        emit("train_data_signals", **sig, card=card)

        # the other trainers, 2 steps each at their small CLI sizes
        run("train_vae", train_vae.main, ["--image_folder", folder, "--batch_size", "8",
                                          "--steps", "2", "--no_preflight"], 2)
        run("train_vqgan", train_vqgan.main,
            ["--image_folder", folder, "--resolution", "64", "--ch", "32",
             "--ch_mult", "1,2", "--n_embed", "256", "--batch_size", "8", "--steps", "2",
             "--disc_start", "0", "--no_preflight"], 2)
        run("train_clip", train_clip.main,
            ["--image_text_folder", folder, "--image_size", "128", "--patch_size", "16",
             "--dim", "512", "--depth", "6", "--batch_size", "8", "--steps", "2",
             "--no_preflight"], 2)
        emit("train_data_cli", depth=CLI_DEPTH, wall_s=walls, k1_launches=cli_launches,
             card=card)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
        shutil.rmtree(work, ignore_errors=True)
    emit("train_data_phase", seconds=time.perf_counter() - t_phase, card=card)
    return launches, row


def _tensors(torch, tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(torch, v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(torch, v)



# ---------------------------------------------------------------------------
# the serving plane: the HTTP/SSE gateway over in-process replicas, and the
# replica fleet over its wire protocol
# ---------------------------------------------------------------------------

GW_SLOTS = 8                 # slots a replica
GW_STEPS_PER_SYNC = 4
# the burst asks for whole grids (the default max_tokens), as the users of
# /v1/generate and /v1/images do; the preview and direct turns, which read
# the engine's ms a step, and the failover check's request decode 4 grid rows
GW_PREVIEW_TOKENS = 64
GW_FAILOVER_TOKENS = 64      # failed after 2 rows
FLEET_KILL_STEP = 40         # the chaos SIGKILL's engine step (rows 0-1 sent)
FLEET_SPAWN_TIMEOUT_S = 240.0


def _gw_request(addr, method, path, body=None):
    """One HTTP exchange with the gateway on the caller's thread: the status,
    the JSON body or the SSE events, and the client's clock (start, first
    row, end)."""
    import http.client
    from dalle_tpu_torch.gateway import iter_sse
    host, port = addr
    out = {"path": path, "body": body, "t0": time.perf_counter(), "t_first_row": None}
    conn = http.client.HTTPConnection(host, port, timeout=600)
    try:
        conn.request(method, path, None if body is None else json.dumps(body))
        resp = conn.getresponse()
        out["status"] = resp.status
        if resp.getheader("Content-Type") == "text/event-stream":
            events = []
            for kind, data in iter_sse(resp):
                if kind == "row" and out["t_first_row"] is None:
                    out["t_first_row"] = time.perf_counter()
                events.append((kind, data))
            out["events"] = events
        else:
            raw = resp.read()
            if resp.getheader("Content-Type") == "application/json":
                out["json"] = json.loads(raw)
            else:
                out["text"] = raw.decode()
    finally:
        conn.close()
    out["t_end"] = time.perf_counter()
    return out


def _gw_burst(addr, calls):
    """``calls`` [(method, path, body)] sent at once, one client thread each."""
    import threading
    results = [None] * len(calls)

    def one(i):
        results[i] = _gw_request(addr, *calls[i])
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(calls))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def _gw_done(res):
    """The ``done`` payload of a /v1/generate result (stream or blocking)."""
    if "events" in res:
        done = [d for k, d in res["events"] if k == "done"]
        rows = [d for k, d in res["events"] if k == "row"]
        check(len(done) == 1, f"serve_gateway: stream ended without one done: "
                              f"{[k for k, _ in res['events']]}")
        check([r["row"] for r in rows] == list(range(len(rows)))
              and [t for r in rows for t in r["tokens"]] == done[0]["tokens"],
              "serve_gateway: the SSE rows concatenated differ from done's tokens")
        return done[0], rows
    return res["json"], None


def _gw_traffic(cfg):
    """16 /v1/generate (8 streamed, the first 2 with pixel previews, 8
    blocking; the last one of tenant "capped", whose quota is one request)
    and 2 /v1/images of 4 candidates, top 2; every sequence a whole grid."""
    texts = _serve_text(cfg, 18, SMOKE_SEED + 23)
    calls = []
    for i in range(16):
        body = {"text": texts[i].tolist(), "seed": 5000 + i, "stream": i < 8,
                "pixels": i < 2}
        if i == 15:
            body["tenant"] = "capped"
        calls.append(("POST", "/v1/generate", body))
    for j in range(2):
        calls.append(("POST", "/v1/images", {"text": texts[16 + j].tolist(),
                                             "seed": 6000 + 100 * j,
                                             "n_candidates": 4, "top_k": 2}))
    return texts, calls


def _gw_lone(torch, wrapper, calls, use_kernel):
    """The traffic's sequences on one lone engine of the replicas'
    configuration, the candidates of a group admitted as a group:
    {("gen", i) or ("img", j, c): tokens}, wall seconds."""
    import numpy as np
    from dalle_tpu_torch.serve import RequestQueue
    eng = wrapper.serve_engine(slots=GW_SLOTS, steps_per_sync=GW_STEPS_PER_SYNC,
                               use_kernel=use_kernel)
    q, keys = RequestQueue(), []
    for i, (_, path, body) in enumerate(calls):
        text = np.asarray(body["text"], np.int32)
        if path == "/v1/generate":
            q.submit(text, body["seed"], request_id=len(keys),
                     max_tokens=body.get("max_tokens"))
            keys.append(("gen", i))
            continue
        for c in range(body["n_candidates"]):
            q.submit(text, body["seed"] + c, request_id=len(keys), group_id=i,
                     group_size=body["n_candidates"], group_index=c)
            keys.append(("img", i - 16, c))
    q.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(q)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {keys[c.request_id]: c.tokens.tolist() for c in done}, wall


def _gw_plane(wrapper, vae, clip, use_kernel, replicas=2):
    from dalle_tpu_torch.gateway import (AdmissionController, Gateway, Replica,
                                         ReplicaRouter, SloEstimator, TenantQuotas)
    reps = [Replica(wrapper.serve_engine(slots=GW_SLOTS, steps_per_sync=GW_STEPS_PER_SYNC,
                                         use_kernel=use_kernel),
                    replica_id=f"replica-{i}", maxsize=64).start() for i in range(replicas)]
    admission = AdmissionController(
        TenantQuotas(100.0, 100.0, overrides={"capped": (0.001, 1.0)}),
        SloEstimator(parallelism=GW_SLOTS * replicas))
    gw = Gateway(ReplicaRouter(reps), admission, vae=vae, clip=clip).start()
    return reps, gw


def _gw_serve(torch, cfg, gw, calls):
    """The burst through the gateway, every answer 200: ({("gen", i) or
    ("img", j, c): tokens}, results, wall seconds)."""
    results, wall = _gw_burst(gw.httpd.server_address[:2], calls)
    tokens = {}
    for i, res in enumerate(results):
        check(res["status"] == 200, f"serve_gateway: {res['path']} #{i} answered "
                                    f"{res['status']}: {res.get('json')}")
        if res["path"] == "/v1/generate":
            done, _ = _gw_done(res)
            want = res["body"].get("max_tokens") or cfg.image_seq_len
            check(len(done["tokens"]) == want,
                  f"serve_gateway: request {i} returned {len(done['tokens'])} tokens")
            tokens[("gen", i)] = done["tokens"]
        else:
            doc, j = res["json"], i - 16
            check(doc["n_candidates"] == 4 and len(doc["top_k"]) == 2 and doc["reranked"]
                  and all(math.isfinite(s) for s in doc["scores"])
                  and [e["candidate"] for e in doc["top_k"]] == doc["order"][:2]
                  and all(e["pixels_shape"] == [cfg.image_size, cfg.image_size, 3]
                          and e["tokens"] == doc["candidates"][e["candidate"]]
                          for e in doc["top_k"]),
                  f"serve_gateway: /v1/images #{j}: {({k: v for k, v in doc.items() if k != 'top_k'})}")
            for c, toks in enumerate(doc["candidates"]):
                tokens[("img", j, c)] = toks
    return tokens, results, wall


def _gw_partings(got, want):
    """The keys of the sequences that differ."""
    return [k for k, w in want.items() if got[k] != w]


def _gw_part_gaps(torch, wrapper, cfg, calls, parted, got, want):
    """Each parted sequence's first divergence from the lone engine's, as
    phase decode_surface holds its engine: replayed teacher-forced on the
    int8w model over its int8 cache from the lone engine's prefix, under the
    request's generator (one (1, V) draw a token, as the engine takes them):
    {"gen/i" or "img/j/c": row, step, the two tokens, their score gap and
    its share of 2^-5 of the row's largest logit}."""
    import numpy as np
    from dalle_tpu_torch.ops.sampling import gumbel_noise
    model, cache_dtype = wrapper._resolve_precision("int8w")
    out = {}
    for key in parted:
        body = calls[key[1] if key[0] == "gen" else 16 + key[1]][2]
        seed = body["seed"] + (key[2] if key[0] == "img" else 0)
        g = torch.Generator("cuda").manual_seed(seed)
        noise = torch.stack([gumbel_noise((1, cfg.image_vocab_size), generator=g,
                                          device="cuda") for _ in range(cfg.image_seq_len)])
        text = torch.from_numpy(np.asarray(body["text"], np.int32)[None]).cuda()
        base = torch.as_tensor(want[key], device="cuda")[None]
        seq = torch.as_tensor(got[key], device="cuda")[None]
        out["/".join(map(str, key))] = _first_divergence(torch, model, text, base, seq, noise,
                                                         1.0, 0.5, cache_dtype)
    return out


def _gw_preview_calls(texts, pixels):
    return [("POST", "/v1/generate", {"text": texts[i].tolist(), "seed": 7100 + i,
                                      "stream": True, "pixels": pixels,
                                      "max_tokens": GW_PREVIEW_TOKENS})
            for i in range(GW_SLOTS)]


def _gw_preview_steps(torch, wrapper, vae, clip, texts):
    """The engine's ms a step while 8 streams are served without and with
    pixel previews, in turns (off, on, on, off), on one replica behind its
    own gateway; the preview decodes run on the handlers' threads on their
    own CUDA streams."""
    reps, gw = _gw_plane(wrapper, vae, clip, None, replicas=1)
    eng, out = reps[0].engine, {False: [], True: []}
    try:
        for pixels in (False, True, True, False):
            steps0, secs0 = eng.stats.steps, eng.stats.step_seconds
            results, wall = _gw_burst(gw.httpd.server_address[:2],
                                      _gw_preview_calls(texts, pixels))
            for res in results:
                check(res["status"] == 200, f"serve_gateway previews: {res['status']}")
                _, rows = _gw_done(res)
                check(all(("pixels_b64" in r) == pixels for r in rows),
                      f"serve_gateway previews: pixels={pixels} rows carry "
                      f"{[('pixels_b64' in r) for r in rows]}")
            steps = eng.stats.steps - steps0
            out[pixels].append({"ms_per_step": (eng.stats.step_seconds - secs0) * 1e3
                                / max(steps, 1), "steps": steps, "wall_s": wall,
                                "image_tokens_per_s": GW_SLOTS * GW_PREVIEW_TOKENS / wall})
    finally:
        gw.shutdown(drain=True, timeout=120)
    return out


def _gw_direct_steps(torch, wrapper, texts):
    """The preview turns' 8 requests on a fresh engine driven directly on
    the calling thread and its default stream (all queued, no HTTP): {ms a
    step, wall, image tokens/s}."""
    import numpy as np
    from dalle_tpu_torch.serve import RequestQueue
    eng = wrapper.serve_engine(slots=GW_SLOTS, steps_per_sync=GW_STEPS_PER_SYNC)
    q = RequestQueue()
    for _, _, body in _gw_preview_calls(texts, False):
        q.submit(np.asarray(body["text"], np.int32), body["seed"],
                 max_tokens=body["max_tokens"])
    q.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(q)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(done) == GW_SLOTS, f"serve_gateway direct: {len(done)} done")
    return {"ms_per_step": eng.stats.step_seconds * 1e3 / max(eng.stats.steps, 1),
            "steps": eng.stats.steps, "wall_s": wall,
            "image_tokens_per_s": GW_SLOTS * GW_PREVIEW_TOKENS / wall}


def _gw_fleet(card, ckpt, ftexts, ref_tokens):
    """The fleet at depth 2, full width, from the checkpoint ``ckpt``: 2
    serve_replica processes under a FleetController, one SIGKILLed by a
    chaos FaultPlan mid-stream; the stream fails over bit for bit to
    ``ref_tokens``, the controller replaces the process, and every frame
    meets contracts/wire.json. {spawn to handshake, kill to replacement}."""
    import os
    import signal
    import threading

    from dalle_tpu_torch import chaos, obs
    from dalle_tpu_torch.fleet import FleetController, FleetManager
    from dalle_tpu_torch.gateway import Gateway, ReplicaRouter
    from dalle_tpu_torch.obs import wiretap
    wiretap.install()
    wiretap.reset()
    root = os.path.dirname(os.path.abspath(__file__))
    mgr = FleetManager([sys.executable, "-m", "dalle_tpu_torch.cli.serve_replica",
                        "--dalle_path", ckpt, "--slots", str(GW_SLOTS),
                        "--steps_per_sync", str(GW_STEPS_PER_SYNC),
                        "--flight_dir", "off", "--profiler_dir", "off"],
                       spawn_timeout_s=FLEET_SPAWN_TIMEOUT_S, heartbeat_s=0.25,
                       max_missed=3, env={"PYTHONPATH": root})
    ctl = fgw = None
    try:
        plan = chaos.FaultPlan([chaos.Fault(kind="kill", step=FLEET_KILL_STEP)])
        spawned, spawn_s = {}, {}

        def spawn(name, extra_env):
            t0 = time.perf_counter()
            spawned[name] = mgr.spawn(extra_env=extra_env)
            spawn_s[name] = time.perf_counter() - t0
        threads = [threading.Thread(target=spawn, args=("victim", plan.env())),
                   threading.Thread(target=spawn, args=("survivor", None))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        check(set(spawned) == {"victim", "survivor"}, f"fleet: spawned {sorted(spawned)}")
        victim, survivor = spawned["victim"], spawned["survivor"]
        router = ReplicaRouter([victim.remote, survivor.remote])
        fgw = Gateway(router).start()
        ctl = FleetController(router, mgr, min_replicas=2, max_replicas=2,
                              slots_per_replica=GW_SLOTS)
        for rp in (victim, survivor):
            ctl.adopt(rp)
        ctl.start(interval_s=0.25)
        killed_at = {}

        def watch():
            while victim.proc.poll() is None:
                time.sleep(0.005)
            killed_at["t"] = time.time()
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        faddr = fgw.httpd.server_address[:2]
        body = {"text": ftexts[0].tolist(), "seed": 8000, "stream": True}
        res = _gw_request(faddr, "POST", "/v1/generate", body)
        check(res["status"] == 200, f"fleet: {res['status']}")
        done, rows_ = _gw_done(res)
        watcher.join(timeout=30)
        check(victim.proc.returncode == -signal.SIGKILL,
              f"fleet: the victim exited {victim.proc.returncode}")
        resets = obs.metrics_snapshot().get('gateway.failover_total{reason="conn_reset"}')
        check(done["tokens"] == ref_tokens and done["failovers"] == 1
              and done["replica"] == survivor.replica_id and resets == 1.0,
              f"fleet: failovers {done['failovers']} on {done['replica']}, tokens equal "
              f"{done['tokens'] == ref_tokens}, conn_reset failovers {resets}")
        deadline = time.time() + FLEET_SPAWN_TIMEOUT_S + 30
        while not any(d["action"] == "replace" and d.get("pid") for d in ctl.decisions):
            check(time.time() < deadline, f"fleet: no replacement: {ctl.decisions}")
            time.sleep(0.1)
        repl = next(d for d in ctl.decisions if d["action"] == "replace" and d.get("pid"))
        check(len(router.replicas) == 2 and victim.remote not in router.replicas,
              f"fleet: {len(router.replicas)} replicas after the replacement")
        again = _gw_request(faddr, "POST", "/v1/generate", {**body, "stream": False})
        check(again["status"] == 200 and again["json"]["tokens"] == ref_tokens,
              f"fleet: after the replacement {again['status']}")
        health = _gw_request(faddr, "GET", "/healthz")
        check(health["status"] == 200, f"fleet: healthz {health['status']}")
        violations = [str(v) for v in wiretap.conformance(wiretap.golden())]
        check(not violations and wiretap.observed(), f"fleet: wire violations {violations}")
        emit("serve_gateway_fleet", depth=CLI_DEPTH, slots=GW_SLOTS, replicas=2,
             spawn_to_handshake_s=spawn_s,
             kill_to_replacement_s=repl["t"] - killed_at["t"],
             replacement=repl["replica"], decisions=[
                 {k: d.get(k) for k in ("action", "reason", "replica")}
                 for d in ctl.decisions],
             failover_reason="conn_reset", rows=len(rows_),
             frame_shapes=len(wiretap.observed()), wire_violations=0,
             served_after=again["json"]["replica"], card=card)
        out = dict(spawn_to_handshake_s=spawn_s,
                   kill_to_replacement_s=repl["t"] - killed_at["t"])
    finally:
        if ctl is not None:
            ctl.stop()
        if fgw is not None:
            fgw.shutdown(drain=True, timeout=60)
        mgr.shutdown()
        wiretap.uninstall()
    return out


def phase_serve_gateway(torch, card):
    """The serving plane on the card (see the module docstring, phase 30):
    (a) the HTTP/SSE gateway over 2 in-process replicas at DALL·E-1.4B,
    int8w; (b) the fleet at depth 2, full width, of serve_replica
    processes under a FleetController, one SIGKILLed mid-stream."""
    import os
    import shutil

    import numpy as np

    from dalle_tpu_torch import (ClipConfig, DalleWithVae, DiscreteVAEAdapter, DVAEConfig,
                                 dalle_1p4b, init_clip, init_dalle, init_dvae, obs)
    from dalle_tpu_torch.obs import lockorder
    from dalle_tpu_torch.ops import _build
    from dalle_tpu_torch.ops import decode_attention as dec
    from dalle_tpu_torch.ops import int8w_linear as w8
    from dalle_tpu_torch.serve import RequestQueue
    from dalle_tpu_torch.train.checkpoints import CheckpointManager

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "serve_gateway_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    row = {"card": card}
    obs.configure()
    try:
        # (a) the in-process plane at DALL·E-1.4B, int8w
        cfg = dalle_1p4b()
        vae = DiscreteVAEAdapter(init_dvae(DVAEConfig(), seed=SMOKE_SEED))
        clip = init_clip(ClipConfig(num_text_tokens=49408, visual_image_size=128,
                                    visual_patch_size=16), seed=SMOKE_SEED)
        wrapper = DalleWithVae(init_dalle(cfg, seed=SMOKE_SEED), vae, clip)
        wrapper._resolve_precision("int8w")            # the one-time quantization
        torch.cuda.synchronize()
        texts, calls = _gw_traffic(cfg)

        reps, gw = _gw_plane(wrapper, vae, clip, None)
        addr = gw.httpd.server_address[:2]
        _zero_engine_counts(dec, w8)                   # the main path starts here
        tokens, results, gw_wall = _gw_serve(torch, cfg, gw, calls)
        launches = _engine_counts(dec, w8)
        check(launches["decode_attend_window"] > 0 and launches["w8"] > 0
              and launches["decode_attend_window_paged"] == 0,
              f"serve_gateway: launches {launches}")
        # the asked-for refusals, then health and metrics
        extra = {
            "over_quota": _gw_request(addr, "POST", "/v1/generate",
                                      {"text": texts[0].tolist(), "seed": 1,
                                       "tenant": "capped"}),
            "malformed": _gw_request(addr, "POST", "/v1/generate", {"text": "x", "seed": 1}),
            "healthz": _gw_request(addr, "GET", "/healthz"),
            "metrics": _gw_request(addr, "GET", "/metrics")}
        check(extra["over_quota"]["status"] == 429
              and extra["over_quota"]["json"]["error"] == "quota",
              f"serve_gateway: over quota {extra['over_quota']}")
        check(extra["malformed"]["status"] == 400
              and extra["malformed"]["json"]["error"] == "bad_request",
              f"serve_gateway: malformed {extra['malformed']}")
        check(extra["healthz"]["status"] == 200 and extra["healthz"]["json"]["status"] == "ok"
              and all(r["healthy"] for r in extra["healthz"]["json"]["replicas"]),
              f"serve_gateway: healthz {extra['healthz']}")
        check(extra["metrics"]["status"] == 200
              and "dalle_gateway_completed_total" in extra["metrics"]["text"]
              and "dalle_gateway_rejected_total" in extra["metrics"]["text"],
              "serve_gateway: /metrics lacks the gateway counters")
        snap = obs.metrics_snapshot()
        spans = obs.get_tracer().snapshot_spans()
        served_by = {}
        gen_done = []
        for i, res in enumerate(results[:16]):
            done, _ = _gw_done(res)
            served_by[done["replica"]] = served_by.get(done["replica"], 0) + 1
            gen_done.append((res, done))
        lat = [d["latency_s"] for _, d in gen_done]
        ttft = [d["ttft_s"] for _, d in gen_done]
        first_row = [r["t_first_row"] - r["t0"] for r, _ in gen_done if r["t_first_row"]]
        client = [r["t_end"] - r["t0"] for r in results]
        n_tokens = sum(len(t) for t in tokens.values())
        pipe = {name: [dur * 1e3 for n, _rel, dur, *_ in spans if n == name]
                for name in ("pipeline/decode_pixels", "pipeline/rerank")}
        row.update(
            replicas=2, slots=GW_SLOTS, precision="int8w", steps_per_sync=GW_STEPS_PER_SYNC,
            requests=len(calls), sequences=len(tokens), tokens_a_sequence=cfg.image_seq_len,
            served_by=served_by,
            wall_s=gw_wall, image_tokens_per_s=n_tokens / gw_wall,
            ttft_p50_s=float(np.percentile(ttft, 50)), ttft_p95_s=float(np.percentile(ttft, 95)),
            latency_p50_s=float(np.percentile(lat, 50)),
            latency_p95_s=float(np.percentile(lat, 95)),
            client_first_row_p50_s=float(np.percentile(first_row, 50)),
            client_first_row_p95_s=float(np.percentile(first_row, 95)),
            client_latency_p50_s=float(np.percentile(client, 50)),
            client_latency_p95_s=float(np.percentile(client, 95)),
            ttft_p50_s_hist=_hist_quantile(snap, "gateway.ttft_seconds", 0.5),
            images_decode_ms=pipe["pipeline/decode_pixels"],
            images_rerank_ms=pipe["pipeline/rerank"],
            engine_ms_per_step={r.replica_id: r.engine.stats.step_seconds * 1e3
                                / max(r.engine.stats.steps, 1) for r in reps},
            launches=launches,
            completed_total=snap.get("gateway.completed_total"))
        check(len(pipe["pipeline/decode_pixels"]) == len(pipe["pipeline/rerank"]) == 2,
              f"serve_gateway: pipeline spans {({k: len(v) for k, v in pipe.items()})}")
        gw.shutdown(drain=True, timeout=300)
        del reps, gw

        # every sequence against a lone engine of the same configuration;
        # under use_kernel None each that parts must part at a near-tie
        lone, lone_wall = _gw_lone(torch, wrapper, calls, None)
        row["lone_wall_s"] = lone_wall
        row["lone_image_tokens_per_s"] = n_tokens / lone_wall
        parted = _gw_partings(tokens, lone)
        gaps = _gw_part_gaps(torch, wrapper, cfg, calls, parted, tokens, lone)
        row["unpinned_parted"] = gaps
        check(all(d["gap_share"] <= 1.0 for d in gaps.values()),
              f"serve_gateway: a sequence parts from the lone engine's away from a "
              f"near-tie: {gaps}")
        row["tokens_equal"] = "pinned" if parted else "unpinned"

        # the engine's ms a step with pixel previews off and on, then the
        # same requests on an engine driven directly (the HTTP/SSE cost)
        previews = _gw_preview_steps(torch, wrapper, vae, clip, texts)
        direct = _gw_direct_steps(torch, wrapper, texts)
        row.update(preview_steps={str(k): v for k, v in previews.items()},
                   direct_steps=direct,
                   gateway_over_direct_tokens_per_s=statistics.mean(
                       r["image_tokens_per_s"] for r in previews[False])
                   / direct["image_tokens_per_s"])
        gw_launches = launches

        # the depth-2, full-width model: the pinned rerun and the fleet
        fcfg = dalle_1p4b(depth=CLI_DEPTH)
        fmodel = init_dalle(fcfg, seed=SMOKE_SEED)
        fwrap = DalleWithVae(fmodel, vae, clip)
        if parted:
            # the replicas admit other batch mixes than the lone engine, and
            # under use_kernel None the admission paths round at other
            # points; pinned, every path runs the JAX package's formula. The
            # rerun is at depth 2, full width, as phase decode_surface's
            # pinned check: the depth-24 pinned engine is ~2.5x slower
            preps, pgw = _gw_plane(fwrap, vae, clip, False)
            try:
                ptokens, _, pwall = _gw_serve(torch, fcfg, pgw, calls)
            finally:
                pgw.shutdown(drain=True, timeout=600)
            plone, plone_wall = _gw_lone(torch, fwrap, calls, False)
            pparted = _gw_partings(ptokens, plone)
            check(not pparted and len(plone) == len(tokens),
                  f"serve_gateway: pinned tokens part from the lone engine's: {pparted}")
            row.update(pinned_depth=CLI_DEPTH, pinned_wall_s=pwall,
                       pinned_lone_wall_s=plone_wall, pinned_sequences_equal=len(plone))
            del preps, pgw

        # from here on the lock-order tracker sees every lock the plane
        # creates: the failover plane's and the fleet's (off above, where
        # the plane's times are read)
        lockorder.install()
        try:
            # mid-stream failover: one request alone, unfailed, then with its
            # replica failing after 2 rows; the client's tokens equal bit for bit
            freps, fgw = _gw_plane(wrapper, vae, clip, None)
            faddr = fgw.httpd.server_address[:2]
            body = {"text": texts[3].tolist(), "seed": 7003, "stream": True,
                    "max_tokens": GW_FAILOVER_TOKENS}
            unfailed = _gw_request(faddr, "POST", "/v1/generate", body)
            check(unfailed["status"] == 200, f"serve_gateway failover: {unfailed['status']}")
            u_done, _ = _gw_done(unfailed)
            victim = next(r for r in freps if r.replica_id == u_done["replica"])
            victim.fail_after_rows(2)
            fo_key = 'gateway.failover_total{reason="worker_death"}'
            fo0 = obs.metrics_snapshot().get(fo_key, 0.0)
            t0 = time.perf_counter()
            failed = _gw_request(faddr, "POST", "/v1/generate", body)
            check(failed["status"] == 200, f"serve_gateway failover: {failed['status']}")
            f_done, f_rows = _gw_done(failed)
            check(f_done["tokens"] == u_done["tokens"] and f_done["failovers"] == 1
                  and f_done["replica"] != victim.replica_id and not victim.healthy
                  and [r["row"] for r in f_rows]
                  == list(range(GW_FAILOVER_TOKENS // cfg.image_fmap_size)),
                  f"serve_gateway failover: {f_done['failovers']} failovers on "
                  f"{f_done['replica']}, rows {[r['row'] for r in f_rows]}, tokens equal "
                  f"{f_done['tokens'] == u_done['tokens']}")
            fo1 = obs.metrics_snapshot().get(fo_key, 0.0)
            check(fo1 == fo0 + 1, f"serve_gateway failover: {fo_key} {fo0} → {fo1}")
            row.update(failover=dict(unfailed_latency_s=unfailed["t_end"] - unfailed["t0"],
                                     failed_latency_s=failed["t_end"] - t0,
                                     tokens=len(f_done["tokens"]), reason="worker_death"))
            fgw.shutdown(drain=True, timeout=120)
            del freps, fgw, wrapper
            torch.cuda.empty_cache()
            emit("serve_gateway_plane", **row)

            # (b) the fleet at depth 2, full width: serve_replica processes,
            # which load the kernels built here (build/kernels) and compile
            # none
            _build.build_all()
            ckpt = os.path.join(work, "dalle")
            CheckpointManager(ckpt).save(0, {"model": fmodel.state_dict()},
                                         {"model_class": "DALLE", "hparams": fcfg.to_dict()},
                                         wait=True)
            ftexts = _serve_text(fcfg, 2, SMOKE_SEED + 29)
            q = RequestQueue()
            q.submit(ftexts[0], 8000, request_id=0)
            q.close()
            ref = fwrap.serve_engine(slots=GW_SLOTS, steps_per_sync=GW_STEPS_PER_SYNC).run(q)
            ref_tokens = ref[0].tokens.tolist()
            del fwrap, fmodel, ref
            torch.cuda.empty_cache()
            row["fleet"] = _gw_fleet(card, ckpt, ftexts, ref_tokens)
            cycles = lockorder.cycles()
            check(not cycles, "serve_gateway: lock cycles "
                              + "; ".join(lockorder.format_edge(e) for c in cycles for e in c))
            edges = len(lockorder.observed_edges())
        finally:
            lockorder.uninstall()
    finally:
        obs.disable()
        shutil.rmtree(work, ignore_errors=True)
    emit("serve_gateway_phase", seconds=time.perf_counter() - t_phase, lock_edges=edges,
         lock_cycles=0, card=card)
    return gw_launches, row


# phase name → (its function, the results it takes from earlier phases and
# the stand-ins used when those did not run: phase train's Adam row as
# PERF.md §5 records it; phase generate's rows)
K1_ROW = {"peak_gib": 28.4, "ms_per_step": 166.7, "tokens_per_s": None, "losses": [None]}
PHASES = ("kernel", "train_kernel", "serve_kernel", "flash_kernel", "persist_kernel",
          "chunked_kernel", "ring_kernel", "decode_vs_forward", "train_parity",
          "serve_parity", "flash_parity", "persist_parity", "ring_parity", "generate", "serve",
          "decode_surface", "serve_obs", "serve_gateway", "train", "recipe", "train_persist", "train_long",
          "train_ring", "cli", "paper", "taming", "reversible", "train_obs", "train_data")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Build and drive the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--phases", type=str, default=None,
                    help="comma-separated phases to run after env (default: all, in order; "
                         f"of {', '.join(PHASES)})")
    args = ap.parse_args(argv)
    want = None if args.phases is None else [p for p in args.phases.split(",") if p]
    if want is not None and set(want) - set(PHASES):
        print(f"chip_smoke: unknown phases {sorted(set(want) - set(PHASES))}", file=sys.stderr)
        return 2
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

    def on(name):
        return want is None or name in want

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        emit("phase_seconds", name=name, seconds=time.perf_counter() - t0)
        return out

    t_script = time.perf_counter()
    card = phase_env(torch)
    r = {}
    for name, fn in (("kernel", phase_kernel), ("train_kernel", phase_train_kernel),
                     ("serve_kernel", phase_serve_kernel), ("flash_kernel", phase_flash_kernel),
                     ("persist_kernel", phase_persist_kernel),
                     ("chunked_kernel", phase_chunked_kernel), ("ring_kernel", phase_ring_kernel)):
        if on(name):
            r[name] = timed(name, fn, torch, card)
    for name, fn in (("decode_vs_forward", phase_decode_vs_forward),
                     ("train_parity", phase_train_parity), ("serve_parity", phase_serve_parity),
                     ("flash_parity", phase_flash_parity),
                     ("persist_parity", phase_persist_parity), ("ring_parity", phase_ring_parity)):
        if on(name):
            timed(name, fn, torch)
    if on("generate"):
        r["generate"] = timed("generate", phase_generate, torch, card)
    if on("serve"):
        r["serve"] = timed("serve", phase_serve, torch, card)
    gen_rows = r["generate"][1] if "generate" in r else [
        {"precision": "bf16_int8kv", "ms_per_token": None}]
    if on("decode_surface"):
        r["decode_surface"] = timed("decode_surface", phase_decode_surface, torch, card, gen_rows)
    if on("serve_obs"):
        r["serve_obs"] = timed("serve_obs", phase_serve_obs, torch, card)
    if on("serve_gateway"):
        r["serve_gateway"] = timed("serve_gateway", phase_serve_gateway, torch, card)
    if on("train"):
        r["train"] = timed("train", phase_train, torch, card)
    k1_row = r["train"][1] if "train" in r else K1_ROW
    if on("recipe"):
        r["recipe"] = timed("recipe", phase_recipe, torch, card, k1_row)
    if on("train_persist"):
        r["train_persist"] = timed("train_persist", phase_train_persist, torch, card, k1_row)
    if on("train_long"):
        r["train_long"] = timed("train_long", phase_train_long, torch, card)
    if on("train_ring"):
        check("train_long" in r, "phase train_ring compares with phase train_long: run both")
        r["train_ring"] = timed("train_ring", phase_train_ring, torch, card, r["train_long"][1])
    for name, fn in (("cli", phase_cli), ("paper", phase_paper), ("taming", phase_taming)):
        if on(name):
            r[name] = timed(name, fn, torch, card)
    if on("reversible"):
        r["reversible"] = timed("reversible", phase_reversible, torch, card, k1_row)
    if on("train_obs"):
        r["train_obs"] = timed("train_obs", phase_train_obs, torch, card)
    if on("train_data"):
        r["train_data"] = timed("train_data", phase_train_data, torch, card, k1_row)
    emit("script_seconds", seconds=time.perf_counter() - t_script, phases=want or "all")

    if want is not None:
        # a selection prints what it ran; the kernels line needs every phase
        print(card, flush=True)
        print(json.dumps({"phases_run": [p for p in PHASES if p in want]}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    errs, timing = r["kernel"]
    k1_errs, k1_timing = r["train_kernel"]
    w_errs, w_timing = r["serve_kernel"]
    k4_errs, k4_timing = r["flash_kernel"]
    k8_errs, k8_timing = r["persist_kernel"]
    k7_errs, k7_timing = r["chunked_kernel"]
    k6_errs, k6_timing = r["ring_kernel"]
    launches, gen_rows = r["generate"]
    serve_launches, _ = r["serve"]
    surface = r["decode_surface"]
    obs_launches, obs_row = r["serve_obs"]
    gw_launches, _ = r["serve_gateway"]
    k1_launches, k1_row = r["train"]
    recipe_launches, _ = r["recipe"]
    k8_launches, _ = r["train_persist"]
    k4_launches, k4_row = r["train_long"]
    k6_launches, k6_row = r["train_ring"]
    cli_launches = r["cli"]
    paper_launches = r["paper"]
    taming = r["taming"]
    rev_launches, rev_row = r["reversible"]
    obs_train_launches, _ = r["train_obs"]
    data_launches, _ = r["train_data"]

    f32 = timing["float32"]
    kernels = [{
        "name": "decode_attend", "route": "cuda",
        "source": "dalle_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dalle_tpu/ops/decode_attention.py:94",
        "launches": launches, "launches_cli": cli_launches["decode_attend"],
        "launches_decode_surface": surface["launches"]["decode_attend"],
        "launches_paper": paper_launches["decode_attend"],
        "launches_serve_obs_generate_trace": obs_launches["generate_trace"]["decode_attend"],
        "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs,
        "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
        "timed_at": "b=8 h=14 d=128 S=512 length=512, float32 cache",
        "kernel_functions": "decode_split_kernel",
        "design": "a cluster of nsplit CTAs per (b, h), a two-slot cp.async ring of "
                  "stages of up to 64 positions (decode_plan), rank-order merge through "
                  "distributed shared memory",
        "by_cache_dtype": timing, "tolerance": TOL,
        "launches_taming_sample": taming["k2_launches"],
        "launches_taming_cli": taming["k2_launches_cli"],
        "taming_gpt_case": taming["k2"],
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
            "launches_reversible": rev_launches[name],
            "launches_train_obs": obs_train_launches[name],
            "launches_train_data": data_launches[name],
            "reversible_profiler_kernels": rev_row["profiler_k1_kernels"],
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
            "launches_serve_obs": sum(v[name] for k, v in obs_launches.items()
                                      if k != "generate_trace"),
            "launches_serve_gateway": gw_launches[name],
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
        "launches_serve_obs": sum(v["w8"] for k, v in obs_launches.items()
                                  if k != "generate_trace"),
        "launches_serve_gateway": gw_launches["w8"],
        "max_abs_err": surface["w8_err"], "worst_share_of_tolerance": surface["w8_share"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": "torch.matmul on the dequantized bf16 weight",
        "timed_at": "1.4B w1: x (8, 1792) bf16, q (14336, 1792) int8, bias",
        "kernel_functions": {"bfloat16": "wg_kernel<NT> (wgmma with the weights converted "
                                         "in registers from a TMA ring; split contraction "
                                         "summed in rank order)", "float32": "fma_kernel"},
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
