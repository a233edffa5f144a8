#!/usr/bin/env python3
"""Run chip_smoke.py's phases for two checkouts on one card, in turns.

    python3 chip_compare.py PARENT_DIR [phase ...]

PARENT_DIR is another checkout of the repository (for example an unpacked
``git archive`` of the parent commit inside a directory that .gitignore
lists). Each side runs in its own process, in the order parent, this, this,
parent, so that two versions are compared only within one call on one card.
Every process builds its checkout's kernels (phase env), prints nvcc's report
of the windowed decode kernels (K3/K5), the host's µs per ``decode_attend``
call (K2 at the DALL·E-1.4B cache, bf16, length 1, 500 calls back to back,
median of five), then the named phases (default: kernel, chunked_kernel,
generate). Each process's whole output goes to
build/compare_<turn>_<side>.log; a summary goes to standard output.
Without CUDA it exits 2.
"""

import json
import os
import subprocess
import sys
import time

CHILD = r'''
import inspect, json, statistics, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from dalle_tpu_torch.ops import decode_attention as dec
card = cs.phase_env(torch)
print(json.dumps({"phase": "k3k5_ptxas",
                  "report": cs.ptxas_report("decode_window_attention", "window_kernel")}))
gen = torch.Generator("cuda").manual_seed(0)
cache = cs._cache(torch, 8, 14, 128, 512, torch.bfloat16, gen)
q = torch.randn(8, 14, 1, 128, device="cuda", generator=gen).to(torch.bfloat16)
runs = []
for _ in range(5):
    for _ in range(20):
        dec.decode_attend(q, cache, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        dec.decode_attend(q, cache, 1)
    runs.append((time.perf_counter() - t0) * 1e6 / 500)
    torch.cuda.synchronize()
print(json.dumps({"phase": "host_us_per_call", "median": statistics.median(runs), "runs": runs}))
del cache
for ph in PHASES:
    fn = getattr(cs, "phase_" + ph)
    t0 = time.perf_counter()
    fn(torch, card) if "card" in inspect.signature(fn).parameters else fn(torch)
    print(json.dumps({"phase": "seconds", "of": ph, "s": time.perf_counter() - t0}), flush=True)
'''

SUMMARY = {
    "kernel_timing": lambda r: {k: {x: v.get(x) for x in ("ms", "k3_split_ms", "library_ms",
                                                         "roofline_share")}
                                for k, v in r["by_cache_dtype"].items()},
    "chunked_kernel_timing": lambda r: {k: {x: v.get(x) for x in ("ms", "k2_ms", "library_ms",
                                                                 "roofline_share")}
                                        for k, v in r["by_case"].items()},
    "host_us_per_call": lambda r: r["median"],
    "generate": lambda r: {x: r[x] for x in ("precision", "cond_scale", "ms_per_token",
                                             "kernel_launches")},
    "profile": lambda r: {x: r.get(x) for x in ("wall_ms_per_step_unprofiled",
                                                "device_ms_per_step", "k2_device_ms_per_step",
                                                "device_busy_share")},
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_compare: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("chip_compare: needs a CUDA device and a parent checkout (usage in the "
              "docstring)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(sys.argv[1])
    phases = sys.argv[2:] or ["kernel", "chunked_kernel", "generate"]
    out_dir = os.path.join(here, "build")
    os.makedirs(out_dir, exist_ok=True)
    rc = 0
    for turn, (side, root) in enumerate((("parent", parent), ("this", here), ("this", here),
                                         ("parent", parent))):
        t0 = time.time()
        run = subprocess.run([sys.executable, "-c", CHILD.replace("PHASES", repr(phases))],
                             cwd=root, capture_output=True, text=True)
        with open(os.path.join(out_dir, f"compare_{turn}_{side}.log"), "w") as f:
            f.write(run.stdout + "\n---- stderr\n" + run.stderr)
        print(f"=== turn {turn} {side} rc={run.returncode} {time.time() - t0:.0f}s", flush=True)
        for line in run.stdout.splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("phase") in SUMMARY:
                print(side, rec["phase"], json.dumps(SUMMARY[rec["phase"]](rec)), flush=True)
        if run.returncode:
            print(run.stderr[-4000:])
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
