#!/usr/bin/env python3
"""Time K2 and K7 over their launch plans on one card.

    python3 chip_decode_sweep.py [PARENT_DIR]

K2 (``decode_attend``) at DALL·E-1.4B's cache (b=8, h=14, S=512, d=128) for
f32, bf16 and int8 caches at lengths 0 (the launch's fixed cost), 280, 400
and 512, and K7
(``decode_attend_chunked``, blk 256) over the whole cache at the JAX
package's bench shapes and the long-sequence model's cache, each through its
library with every (nsplit, rows, stages) that fits a block, held to its
plain version first. Prints the five fastest and ``decode_plan``'s pick
beside them; with PARENT_DIR (another checkout), also the time of that
checkout's K2 and K7 sources built here. CUDA-event medians, L2 flushed
before each launch, as chip_smoke.py times kernels. Writes
build/decode_sweep.json. Without CUDA it exits 2.
"""

import ctypes
import json
import os
import subprocess
import sys


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_decode_sweep: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_decode_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from dalle_tpu_torch.ops import _build
    from dalle_tpu_torch.ops import decode_attention as dec

    card = cs.phase_env(torch)
    print(card, flush=True)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    k2 = _build.library("decode_attention").decode_attend
    k2.argtypes = [P, I, P, I, P, P, P, I, I, I, I, I, F, I, I, I, P]
    k7 = _build.library("decode_chunked_attention").decode_attend_chunked
    k7.argtypes = [P, I, P, I, P, P, P, I, I, I, I, I, I, F, I, I, I, P]
    k2.restype = k7.restype = I
    old2 = old7 = None
    if len(sys.argv) > 1:              # the other checkout's sources, built here
        libs = {}
        for src in ("decode_attention", "decode_chunked_attention"):
            so = os.path.join(here, "build", f"other_{src}.so")
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                            os.path.join(os.path.abspath(sys.argv[1]),
                                         "dalle_tpu_torch", "csrc", f"{src}.cu")],
                           check=True, capture_output=True)
            libs[src] = ctypes.CDLL(so)
        old2 = libs["decode_attention"].decode_attend
        old2.argtypes = [P, I, P, I, P, P, P, I, I, I, I, I, F, P]
        old7 = libs["decode_chunked_attention"].decode_attend_chunked
        old7.argtypes = [P, I, P, I, P, P, P, P, I, I, I, I, I, I, F, P]
        old2.restype = old7.restype = I
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator("cuda").manual_seed(cs.SMOKE_SEED)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    res = {}

    def setup(b, h, d, S, dt):
        dtype = getattr(torch, dt)
        qdt = torch.float32 if dt == "float32" else torch.bfloat16
        cache = cs._cache(torch, b, h, d, S, dtype, gen)
        q = torch.randn(b, h, 1, d, device="cuda", generator=gen).to(qdt)
        out = torch.empty_like(q)
        args = (q.data_ptr(), dec._DTYPE_CODE[qdt], cache.kv.data_ptr(), dec._DTYPE_CODE[dtype],
                None if cache.scale is None else cache.scale.data_ptr(), None, out.data_ptr())
        return dtype, cache, q, out, args

    def report(name, row, plan):
        cfg = sorted((kv for kv in row.items() if kv[0][0] == "n"), key=lambda kv: kv[1])
        pick = f"n{plan.nsplit}r{plan.rows}s{plan.stages}"
        print(name, "plan", pick, row.get(pick), "other", row.get("other"), "best",
              [(k, round(v, 5)) for k, v in cfg[:5]], flush=True)
        res[name] = row

    b, h, d, S = 8, 14, 128, 512
    for dt in ("bfloat16", "int8", "float32"):
        dtype, cache, q, out, args = setup(b, h, d, S, dt)
        plan = dec.decode_plan(b, h, S, d, dtype, sm)
        for L in (0, 280, 400, 512):
            ref = dec.decode_attend_plain(q, cache.kv, cache.scale, L)
            row = {}
            if old2 is not None:
                row["other"] = cs.median_ms(
                    lambda: old2(*args, b, h, S, d, L, d ** -0.5, st), 40, flush)
            for ns in (1, 2, 4, 8):
                for rows in (16, 32, 64):
                    for nst in (1, 2, 3, 4):
                        if dec.decode_smem_bytes(dtype, d, rows, nst, None, ns) > 227 * 1024:
                            continue
                        call = (*args, b, h, S, d, L, d ** -0.5, ns, rows, nst, st)
                        if k2(*call) != 0:
                            raise RuntimeError(f"K2 refused {call[-5:]}")
                        torch.cuda.synchronize()
                        err = (out.float() - ref.float()).abs().max().item()
                        cs.check(err <= cs.TOL[dt], f"K2 {dt} L{L} {call[-5:-1]}: {err}")
                        row[f"n{ns}r{rows}s{nst}"] = cs.median_ms(lambda: k2(*call), 40, flush)
            report(f"K2/{dt}/L{L}", row, plan)
        del cache
    for b, h, S, d in ((16, 14, 2560, 128), (64, 8, 1280, 64), (2, 8, 4352, 64)):
        for dt in ("bfloat16", "int8", "float32"):
            dtype, cache, q, out, args = setup(b, h, d, S, dt)
            plan = dec.decode_plan(b, h, S, d, dtype, sm, blk=256)
            ref = dec.decode_attend_chunked_plain(q, cache.kv, cache.scale, S, blk=256)
            tol = dec.chunked_tolerance(q, cache.kv, cache.scale, S, ref)
            row = {}
            if old7 is not None:
                part = torch.empty(b, h, S // 256, d + 2, device="cuda")
                pa = args[:6] + (part.data_ptr(),) + args[6:]
                row["other"] = cs.median_ms(
                    lambda: old7(*pa, b, h, S, d, S, 256, d ** -0.5, st), 20, flush)
            for ns in (1, 2, 4, 8):
                for rows in (16, 32, 64):
                    for nst in (1, 2):
                        if dec.decode_smem_bytes(dtype, d, rows, nst, 256, ns) > 227 * 1024:
                            continue
                        call = (*args, b, h, S, d, S, 256, d ** -0.5, ns, rows, nst, st)
                        if k7(*call) != 0:
                            raise RuntimeError(f"K7 refused {call[-5:]}")
                        torch.cuda.synchronize()
                        cs.check(bool(((out.float() - ref.float()).abs() <= tol).all()),
                                 f"K7 {dt} {call[-5:-1]} outside chunked_tolerance")
                        row[f"n{ns}r{rows}s{nst}"] = cs.median_ms(lambda: k7(*call), 20, flush)
            report(f"K7/{b}_{h}_{S}_{d}/{dt}", row, plan)
            del cache
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    with open(os.path.join(here, "build", "decode_sweep.json"), "w") as f:
        json.dump({"card": card, "ms": res}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
