#!/usr/bin/env python3
"""Where the int8-weight product W8's decode time goes, on the card.

    python3 chip_w8_anatomy.py [rows]

Builds three variants of ``dalle_tpu_torch/csrc/int8w_linear.cu`` by text
substitution (into build/w8_anatomy/, one ``nvcc`` each, in parallel) and
times each at the DALL·E-1.4B QLinear shapes with x of ``rows`` rows (default
8), each at the split ``w8_plan`` gives it, as ``chip_smoke._w8_timing``
times W8 (median of single launches after a 512 MiB read flush):

* ``kernel``: the kernel as it is;
* ``stream``: the TMA ring and the consumers' reads of their weight words,
  with no dequantization and no products (its outputs are wrong);
* ``no_cluster_sum``: the kernel without the split's cluster: each rank
  stores its own range's sum (its outputs are wrong).

Beside them ``torch.matmul`` on the bf16 weight (cuBLAS) and a one-element
``zero_`` (the floor of this way of timing a launch). Prints the card's
name and power limit, one JSON line per shape and the sums over a decode
step's 97 projections. Without CUDA it exits 2. The variants' outputs are
not checked: they only time parts of the kernel.
"""

import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

DEQ = """    a[j][0] = deq2(v00, L.sel0, L.sel1, L.sb[0], L.cm[0]);
    a[j][1] = deq2(v10, L.sel0, L.sel1, L.sb[1], L.cm[1]);
    a[j][2] = deq2(v01, L.sel0, L.sel1, L.sb[0], L.cm[0]);
    a[j][3] = deq2(v11, L.sel0, L.sel1, L.sb[1], L.cm[1]);"""
RAW = "    a[j][0] = v00; a[j][1] = v10; a[j][2] = v01; a[j][3] = v11;"
MMA = "    Wgmma<NT>::mma(acc, a[j], sw128_desc(xs + (j >> 2) * NT * 128 + (j & 3) * 32));"
FOLD = "    acc[j % R] += __uint_as_float(a[j][0] ^ a[j][1] ^ a[j][2] ^ a[j][3]);"


def _sub(src, a, b):
    if a not in src:
        raise RuntimeError(f"chip_w8_anatomy: the kernel source no longer holds {a[:60]!r}")
    return src.replace(a, b)


def variants(src):
    stream = _sub(_sub(src, DEQ, RAW), MMA, FOLD)
    nosum = _sub(src, "  if (ranks > 1) {\n    // rank 0 adds", "  if (false) {\n    // rank 0 adds")
    nosum = _sub(nosum, "  cfg.numAttrs = ranks > 1 ? 1 : 0;", "  cfg.numAttrs = 0;")
    nosum = _sub(nosum, "  if (NT < 128 && ranks > 1) asm volatile",
                 "  if (false) asm volatile")
    return {"kernel": src, "stream": stream, "no_cluster_sum": nosum}


def build(name, src, out_dir):
    from dalle_tpu_torch.ops import _build
    path = os.path.join(out_dir, f"{name}.cu")
    lib = os.path.join(out_dir, f"{name}.so")
    with open(path, "w") as f:
        f.write(src)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    run = subprocess.run([_build._nvcc(), *flags, "-I", str(_build.CSRC), "-o", lib, path],
                         capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{run.stdout}{run.stderr}")
    fn = ctypes.CDLL(lib).int8w_linear
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_w8_anatomy: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_w8_anatomy: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dalle_tpu_torch import dalle_1p4b
    from dalle_tpu_torch.ops import _build
    from dalle_tpu_torch.ops import int8w_linear as w8
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    out_dir = os.path.join(HERE, "build", "w8_anatomy")
    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(str(_build.CSRC), "int8w_linear.cu")).read()
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = {k: ex.submit(build, k, v, out_dir) for k, v in variants(src).items()}
        fns = {k: f.result() for k, f in futs.items()}
    print(cs.card_line(), flush=True)
    cfg = dalle_1p4b()
    flush = cs._ReadFlush(torch)
    gen = torch.Generator("cuda").manual_seed(cs.SMOKE_SEED + 23)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_step = {name: (1 if name == "to_logits" else cfg.depth) for name in cs.w8_shapes(cfg)}
    step = {}
    for name, (N, K, _) in cs.w8_shapes(cfg).items():
        q = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand(N, generator=gen, device="cuda") * 0.02 + 1e-3
        x = torch.randn(rows, K, generator=gen, device="cuda").bfloat16()
        out = torch.empty(rows, N, device="cuda", dtype=torch.bfloat16)
        wbf = w8.dequantize(q, s, torch.bfloat16)
        split, nt = w8.w8_plan(N, K, sms), w8.tile_rows(rows)
        ranks = w8.walk_ranks(rows, N, split, sms) if nt == 128 else split
        line = {"split": split,
                "cublas_bf16_us": cs.median_ms(lambda: torch.matmul(x, wbf.t()), 30, flush) * 1e3,
                "floor_us": cs.median_ms(lambda: out[:1, :1].zero_(), 30, flush) * 1e3}
        for vname, fn in fns.items():
            def call(fn=fn):
                rc = fn(x.data_ptr(), 1, q.data_ptr(), s.data_ptr(), None, out.data_ptr(),
                        rows, N, K, nt, split, ranks, stream)
                if rc:
                    raise RuntimeError(f"{vname} failed to launch: CUDA error {rc}")
            line[f"{vname}_us"] = cs.median_ms(call, 30, flush) * 1e3
        for k, v in line.items():
            if k.endswith("_us"):
                step[k] = step.get(k, 0.0) + per_step[name] * v
        print(json.dumps({"shape": name, "rows": rows, "N": N, "K": K, **line}), flush=True)
    print(json.dumps({"per_decode_step_ms": {k[:-3]: v / 1e3 for k, v in step.items()},
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
