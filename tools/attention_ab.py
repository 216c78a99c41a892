#!/usr/bin/env python3
"""Compare the attention kernels of two checkouts of the port on one CUDA
card, at the serving shapes both checkouts run.

    python3 tools/attention_ab.py PARENT_DIR CHANGE_DIR

Runs a worker in each checkout in turns (parent, change, change, parent),
each a fresh process that imports that checkout's ``repro_torch`` and
``chip_smoke.py`` and times, in bf16 by CUDA-graph replay,
``chip_smoke._decode_case`` at internlm2-1.8b's heads (4 slots, the serve
cache of 740 and a cache of 4096) and at granite-moe-1b-a400m's, and
``chip_smoke._flash_case`` at both models' heads for a 333-token prompt,
each beside its SDPA time. Prints one JSON line a run and the card's name
and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def worker() -> None:
    sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = torch.bfloat16
    cases = {}
    for arch in (cs.ARCH, cs.MOE_ARCH):
        for skv, lengths in cs.DECODE_CASES[:1 if arch == cs.MOE_ARCH
                                            else 2]:
            cases[f"decode {arch} cache {skv}"] = cs._decode_case(
                arch, bf16, skv, lengths)
        cases[f"flash {arch} sq {cs.PROMPT_LENS[0]}"] = cs._flash_case(
            arch, cs.PROMPT_LENS[0], bf16)
    print(json.dumps({"tree": os.getcwd(), **{
        name: {"ms": c["ms"], "library_ms": c["library_ms"],
               "max_abs_err": c["max_abs_err"]}
        for name, c in cases.items()}}), flush=True)


def main() -> None:
    if sys.argv[1:] == ["--worker"]:
        worker()
        return
    parent, change = (os.path.abspath(d) for d in sys.argv[1:3])
    for tree in (parent, change, change, parent):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker"], cwd=tree, capture_output=True,
                             text=True, timeout=600)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode or not lines:
            raise SystemExit(f"{tree}: rc {out.returncode}\n"
                             f"{out.stderr[-3000:]}")
        print(lines[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
