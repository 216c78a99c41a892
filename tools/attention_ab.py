#!/usr/bin/env python3
"""Compare the attention kernels of two checkouts of the port on one CUDA
card, at the serving shapes both checkouts run.

    python3 tools/attention_ab.py PARENT_DIR CHANGE_DIR [--above-256]

Runs a worker in each checkout in turns (parent, change, change, parent),
each a fresh process that imports that checkout's ``repro_torch`` and
``chip_smoke.py`` and times, in bf16 by CUDA-graph replay,
``chip_smoke._decode_case`` at internlm2-1.8b's heads (4 slots, the serve
cache of 740 and a cache of 4096) and at granite-moe-1b-a400m's, and
``chip_smoke._flash_case`` at both models' heads for a 333-token prompt,
each beside its SDPA time. With ``--above-256`` it times instead the
flash forward and backward above a head dim of 256 in bf16
(``chip_smoke._contract_flash_case`` at b 8, s 256, causal: 8/8 d 257,
8/2 d 288, 8/8 d 512 and 8/1 d 576), each with its design, error, plain
and SDPA times. Prints one JSON line a run and the card's name and power
limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


ABOVE_256 = ((8, 8, 257), (8, 2, 288), (8, 8, 512), (8, 1, 576))


def worker_above_256() -> None:
    sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": os.getcwd()}
    for hq, hkv, d in ABOVE_256:
        c = cs._contract_flash_case(hq, hkv, d, torch.bfloat16)
        out[f"flash {hq}/{hkv} d {d}"] = {
            **{k: c[k] for k in ("design", "ms", "plain_ms", "library_ms",
                                 "bound_ms", "max_abs_err")},
            "bwd": {k: c["bwd"][k] for k in (
                "design", "ms", "plain_ms", "library_ms", "bound_ms",
                "max_abs_err")}}
    print(json.dumps(out), flush=True)


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
    if sys.argv[1:2] == ["--worker"]:
        worker_above_256() if "--above-256" in sys.argv else worker()
        return
    parent, change = (os.path.abspath(d) for d in sys.argv[1:3])
    flags = ["--above-256"] if "--above-256" in sys.argv[3:] else []
    for tree in (parent, change, change, parent):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", *flags], cwd=tree,
                             capture_output=True, text=True, timeout=600)
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
