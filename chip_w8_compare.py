#!/usr/bin/env python3
"""Time the int8-weight product W8 for two checkouts on one card, in turns.

    python3 chip_w8_compare.py PARENT_DIR [rows ...]

PARENT_DIR is another checkout of the repository (for example an unpacked
``git archive`` of the parent commit inside a directory that .gitignore
lists). Each side runs in its own process, in the order parent, this, this,
parent, so that two versions are compared only within one call on one card.
Every process builds its checkout's kernels (``chip_smoke.phase_env``) and
runs its own ``chip_smoke._w8_timing`` at the DALL·E-1.4B QLinear shapes and
the given row counts (default 8, 16, 24, 32, 40, 48, 64; each side must take
them on its kernel route): per shape and row count its kernel, the route
"dequantize, then torch.matmul", the plain version, ``torch.matmul`` on the
bf16 weight (cuBLAS) and the bound, each the median of single launches after
a 512 MiB read flush; then the sums over a decode step's 97 projections;
and the host's µs per ``int8w_linear`` call at the w1 shape and 8 rows
(``chip_smoke.host_us_per_call``: 500 calls back to back, median of three).
Each process's whole output goes to build/w8_compare_<turn>_<side>.log; the
card's name and power limit and the per-step sums go to standard output, one
JSON line per turn. Without CUDA it exits 2.
"""

import json
import os
import subprocess
import sys
import time

CHILD = r'''
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from dalle_tpu_torch import dalle_1p4b
card = cs.phase_env(torch)
timing, step = cs._w8_timing(torch, dalle_1p4b(), rows=ROWS)
from dalle_tpu_torch.ops import int8w_linear as w8
gen = torch.Generator("cuda").manual_seed(0)
q = torch.randint(-127, 128, (14336, 1792), generator=gen, device="cuda", dtype=torch.int8)
s = torch.rand(14336, generator=gen, device="cuda") * 0.02 + 1e-3
b = torch.randn(14336, generator=gen, device="cuda").bfloat16()
x = torch.randn(1, 8, 1792, generator=gen, device="cuda").bfloat16()
host = cs.host_us_per_call(torch, lambda: w8.int8w_linear(x, q, s, b))
print(json.dumps({"phase": "w8_compare", "card": card, "step": {str(k): v for k, v in step.items()},
                  "host_us_per_call_w1_m8": host, "timing": timing}), flush=True)
'''


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_w8_compare: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("chip_w8_compare: needs a CUDA device and a parent checkout (usage in the "
              "docstring)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(sys.argv[1])
    rows = tuple(int(r) for r in sys.argv[2:]) or (8, 16, 24, 32, 40, 48, 64)
    out_dir = os.path.join(here, "build")
    os.makedirs(out_dir, exist_ok=True)
    rc = 0
    for turn, (side, root) in enumerate((("parent", parent), ("this", here), ("this", here),
                                         ("parent", parent))):
        t0 = time.time()
        run = subprocess.run([sys.executable, "-c", CHILD.replace("ROWS", repr(rows))],
                             cwd=root, capture_output=True, text=True)
        with open(os.path.join(out_dir, f"w8_compare_{turn}_{side}.log"), "w") as f:
            f.write(run.stdout + "\n---- stderr\n" + run.stderr)
        print(f"=== turn {turn} {side} rc={run.returncode} {time.time() - t0:.0f}s", flush=True)
        for line in run.stdout.splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("phase") == "w8_compare":
                print(json.dumps({"turn": turn, "side": side, "card": rec["card"],
                                  "host_us_per_call_w1_m8": rec["host_us_per_call_w1_m8"],
                                  "step": rec["step"]}), flush=True)
        if run.returncode:
            print(run.stderr[-4000:])
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
