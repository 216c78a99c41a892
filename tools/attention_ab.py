#!/usr/bin/env python3
"""Compare the attention kernels of two checkouts of the port on one CUDA
card, at the serving shapes both checkouts run.

    python3 tools/attention_ab.py PARENT CHANGE [--above-256 | --contract
                                                 | --simt | --train]

Runs a worker in each checkout in turns (parent, change, change, parent),
each a fresh process that imports that checkout's ``repro_torch`` and
``chip_smoke.py`` and times, in bf16 by CUDA-graph replay,
``chip_smoke._decode_case`` at internlm2-1.8b's heads (4 slots, the serve
cache of 740 and a cache of 4096) and at granite-moe-1b-a400m's, and
``chip_smoke._flash_case`` at both models' heads for a 333-token prompt,
each beside its SDPA time. With ``--above-256`` it times instead the
flash forward and backward on route ``"wide"`` (the CUDA-core column
tiles: ``chip_smoke._contract_flash_case`` at b 8, s 256, causal, fp32 at
8/8 d 257, 8/2 d 288, 8/8 d 512 and 8/1 d 576, and bf16 at 8/8 d 800),
each with its design, error, plain and SDPA times and each CUDA kernel's
device time a call (``chip_smoke.device_us``, torch.profiler), and beside
them routes those shapes leave: bf16 at 8/8 d 257 (``wgmma_wide_staged``)
and 8/2 d 288 (``wgmma_wide``), fp32 at 32/32 d 96 (``simt``) and
internlm2's serve flash; and each tree's ptxas registers and spills of the
flash kernels above 256 and the copies. With ``--contract`` it times the
bf16 flash backward where the rows are not whole 16-byte chunks (8/8 d
100, 8/2 d 99) and bf16 decode at gemma-2b's 8/1 d 256 in plain and partial mode
(``chip_smoke._contract_decode_case``: 4 slots, cache 740), each beside
SDPA and the plain version, and beside them routes those shapes do not
take: the wgmma backward at 32/32 d 96, the fp32 backward at 8/8 d 100,
decode in bf16 at 8/1 d 250 and in fp32 at 8/1 d 256, and internlm2's
serve decode; the bf16 cases at d 100, 99 and 256 also with each CUDA
kernel's device time a call (``chip_smoke.device_us``, torch.profiler).
With ``--simt`` it times the flash shapes that ran the CUDA-core ``simt``
kernels up to d 256 until route ``wide`` took fp32 above 32 and
``wgmma_staged`` the bf16 forward at d not a multiple of 8 (ROADMAP Queue
2 item 1's rows 4-6, 8-10, 13 and 16: fp32 at 8/1 d 256, 8/2 d 99, 32/32
d 80 and 96, 8/8 d 100 and 32/8 d 160, bf16 at 8/2 d 99 and 8/8 d 100),
route ``wide`` above 256 (row 7: fp32 at 8/8 d 257, 8/1 d 576, 8/2 d 288
and 8/8 d 512), and beside them routes those shapes leave (bf16 8/8 d 257
and 8/2 d 288, internlm2's serve and train flash and its training
backward), each through ``chip_smoke._contract_flash_case`` (b 8, s 256,
causal: forward and backward with design, error, plain and SDPA times)
with each CUDA kernel's device time a call. With ``--train`` it times
internlm2-1.8b's training flash forward and backward alone, first in a
fresh process, as ``--simt`` times them after its other cases.
Prints one JSON line a run and the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys


# (hq, hkv, d, dtype name): route "wide", each with its kernels' times.
ABOVE_256 = ((8, 8, 257, "float32"), (8, 2, 288, "float32"),
             (8, 8, 512, "float32"), (8, 1, 576, "float32"),
             (8, 8, 800, "bfloat16"))
# Routes the cases above leave, timed beside them.
ABOVE_256_BESIDE = ((8, 8, 257, "bfloat16"), (8, 2, 288, "bfloat16"),
                    (32, 32, 96, "float32"))
# (hq, hkv, d, dtype name): the contract cases, then routes they leave.
CONTRACT_FLASH = ((8, 8, 100, "bfloat16"), (8, 2, 99, "bfloat16"),
                  (32, 32, 96, "bfloat16"), (8, 8, 100, "float32"))
CONTRACT_DECODE = ((8, 1, 256, "bfloat16"), (8, 1, 250, "bfloat16"),
                   (8, 1, 256, "float32"))
KEYS = ("design", "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")
# (hq, hkv, d, dtype name): the simt rows and row 7, then routes they leave.
SIMT_ROWS = ((8, 1, 256, "float32"), (8, 2, 99, "float32"),
             (32, 32, 80, "float32"), (32, 32, 96, "float32"),
             (8, 8, 100, "float32"), (32, 8, 160, "float32"),
             (8, 2, 99, "bfloat16"), (8, 8, 100, "bfloat16"),
             (8, 8, 257, "float32"), (8, 1, 576, "float32"),
             (8, 2, 288, "float32"), (8, 8, 512, "float32"))
SIMT_BESIDE = ((8, 8, 257, "bfloat16"), (8, 2, 288, "bfloat16"))


def _split_us(cs, kf, hq, hkv, d, dtype) -> dict:
    """Each CUDA kernel's device time a call (µs) of the forward and
    backward on the contract case's inputs."""
    b, s = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    q, k, v, dout = (cs.randn(sh, dtype, i) for i, sh in enumerate((
        (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d))))
    sc = kf._scale(q, None)
    o, lse = kf._kernel_forward(q, k, v, True, sc, with_lse=True)
    return {"fwd_kernel_us": cs.device_us(lambda: kf._kernel_forward(
                q, k, v, True, sc)),
            "bwd_kernel_us": cs.device_us(lambda: kf._kernel_backward(
                q, k, v, o, dout, lse, True, sc))}


def worker_above_256() -> None:
    sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kf

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": os.getcwd(), "regs": [
        p for p in cs._ptxas_summary(_build.build().ptxas)
        if re.search(r"wide_kernel|stage_rows", p)]}
    for hq, hkv, d, dt in ABOVE_256 + ABOVE_256_BESIDE:
        c = cs._contract_flash_case(hq, hkv, d, getattr(torch, dt))
        row = out[f"flash {hq}/{hkv} d {d} {dt}"] = {
            **{k: c[k] for k in KEYS},
            "bwd": {k: c["bwd"][k] for k in KEYS}}
        if (hq, hkv, d, dt) in ABOVE_256:
            row.update(_split_us(cs, kf, hq, hkv, d, getattr(torch, dt)))
    c = cs._flash_case(cs.ARCH, cs.PROMPT_LENS[0], torch.bfloat16)
    out[f"flash {cs.ARCH} sq {cs.PROMPT_LENS[0]}"] = {
        k: c[k] for k in ("ms", "library_ms", "max_abs_err")}
    print(json.dumps(out), flush=True)


def worker_simt() -> None:
    sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as kf

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": os.getcwd()}
    for hq, hkv, d, dt in SIMT_ROWS + SIMT_BESIDE:
        c = cs._contract_flash_case(hq, hkv, d, getattr(torch, dt))
        row = out[f"flash {hq}/{hkv} d {d} {dt}"] = {
            **{k: c[k] for k in KEYS},
            "bwd": {k: c["bwd"][k] for k in KEYS}}
        if (hq, hkv, d, dt) in SIMT_ROWS:
            row.update(_split_us(cs, kf, hq, hkv, d, getattr(torch, dt)))
        torch.cuda.empty_cache()
    bf16 = torch.bfloat16
    c = cs._flash_case(cs.ARCH, cs.PROMPT_LENS[0], bf16)
    out[f"flash {cs.ARCH} sq {cs.PROMPT_LENS[0]}"] = {
        k: c[k] for k in ("ms", "library_ms", "max_abs_err")}
    out.update(_train_cases(cs, bf16))
    print(json.dumps(out), flush=True)


def _train_cases(cs, bf16) -> dict:
    """internlm2-1.8b's training flash forward and backward."""
    c = cs._flash_case(cs.ARCH, cs.TRAIN_SEQ, bf16, b=cs.TRAIN_BATCH)
    fwd = {k: c[k] for k in ("ms", "library_ms", "max_abs_err")}
    c = cs._flash_bwd_case(cs.ARCH, cs.TRAIN_BATCH, cs.TRAIN_SEQ, bf16)
    return {f"flash {cs.ARCH} train": fwd, f"flash_bwd {cs.ARCH} train": {
        k: c[k] for k in ("design", "ms", "library_ms", "max_abs_err")}}


def worker_train() -> None:
    sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"tree": os.getcwd(),
                      **_train_cases(cs, torch.bfloat16)}), flush=True)


def worker_contract() -> None:
    sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]
    import torch

    import chip_smoke as cs

    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf

    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = torch.bfloat16
    out = {"tree": os.getcwd()}
    for hq, hkv, d, dt in CONTRACT_FLASH:
        c = cs._contract_flash_case(hq, hkv, d, getattr(torch, dt))
        row = out[f"flash bwd {hq}/{hkv} d {d} {dt}"] = {
            k: c["bwd"][k] for k in KEYS}
        if dt == "bfloat16" and d % 8:      # the inputs of the case
            b, s = cs.TRAIN_BATCH, cs.TRAIN_SEQ
            q, k, v, dout = (cs.randn(sh, bf16, i) for i, sh in enumerate((
                (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                (b, s, hq, d))))
            sc = kf._scale(q, None)
            o, lse = kf._kernel_forward(q, k, v, True, sc, with_lse=True)
            row["kernel_us"] = cs.device_us(lambda: kf._kernel_backward(
                q, k, v, o, dout, lse, True, sc))
    for hq, hkv, d, dt in CONTRACT_DECODE:
        for lse in (False, True):
            c = cs._contract_decode_case(hq, hkv, d, getattr(torch, dt), lse)
            row = out[f"decode {hq}/{hkv} d {d} {dt} {c['mode']}"] = {
                "route": c["route"],
                **{k: c[k] for k in KEYS if k != "design"}}
            if (d, dt) == (256, "bfloat16"):
                skv, lengths = cs.DECODE_CASES[0]
                q, k, v = (cs.randn(sh, bf16, i) for i, sh in enumerate((
                    (cs.SLOTS, hq, d), (cs.SLOTS, skv, hkv, d),
                    (cs.SLOTS, skv, hkv, d))))
                n = torch.tensor(lengths, dtype=torch.int32, device="cuda")
                row["kernel_us"] = cs.device_us(
                    lambda: kd.decode_attention(q, k, v, n, return_lse=lse))
    skv, lengths = cs.DECODE_CASES[0]
    c = cs._decode_case(cs.ARCH, torch.bfloat16, skv, lengths)
    out[f"decode {cs.ARCH} cache {skv}"] = {
        k: c[k] for k in ("ms", "library_ms", "max_abs_err")}
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
        if "--above-256" in sys.argv:
            worker_above_256()
        elif "--simt" in sys.argv:
            worker_simt()
        elif "--contract" in sys.argv:
            worker_contract()
        elif "--train" in sys.argv:
            worker_train()
        else:
            worker()
        return
    parent, change = (os.path.abspath(d) for d in sys.argv[1:3])
    flags = [f for f in ("--above-256", "--contract", "--simt", "--train")
             if f in sys.argv[3:]]
    for tree in (parent, change, change, parent):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", *flags], cwd=tree,
                             capture_output=True, text=True, timeout=900)
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
