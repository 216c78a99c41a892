#!/usr/bin/env python3
"""Time variants of the attention sources against each other on one CUDA
card: flash above a head dim of 256 in bf16; with ``--staged`` flash at
the bf16 head dims whose rows are not whole 16-byte chunks (8/8 d 100, 8/2
d 99: the backward's ``wgmma_staged`` route, or a variant's other design
there); with ``--wide-staged`` flash above 256 in bf16 at 8/8 d 257, 8/2
d 300 (route ``wgmma_wide_staged``) and 8/8 d 264 (``wgmma_wide``, or
where a variant's ``tc_wide_staged_route`` takes it, staged too: the
wrapper's bf16 routes above 256 follow the variant's ``common.cuh``
predicates, evaluated from its source), with each CUDA kernel's device
time a call (``chip_smoke.device_us``);
with ``--decode`` bf16 decode on route ``mma`` (8/1 and 16/16 at
d 256, 4 slots, cache 740, plain and partial mode); with ``--wide-f32``
flash on route ``wide`` (the CUDA-core column tiles) in fp32 at 8/8 d 257,
8/2 d 288, 8/8 d 512 and 8/1 d 576 and in bf16 at 8/8 d 800, with each
CUDA kernel's device time a call; with ``--simt-tile`` flash below 257 at
the shapes route ``wide`` at one tile and route ``wgmma_staged``'s
forward took from the CUDA-core ``simt`` kernels (fp32 at 8/1 d 256 and
32/8 d 160, where the dK/dV grid is short of blocks or not; bf16 at 8/8 d
100 and 8/2 d 99, where the staged rows' copy is timed), with each CUDA
kernel's device time a call.

    python3 tools/flash_variants_ab.py [--staged | --wide-staged | --decode
        | --wide-f32 | --simt-tile] VARIANT_DIR ...

Each VARIANT_DIR holds a copy of ``src/repro_torch/csrc``, edited as the
variant wants. Runs a worker for each
variant in turns (the variants in order, then in reverse), each a fresh
process that builds its own library from that directory (into
``VARIANT_DIR/_build``), then at b 8, s 256, causal times by CUDA-graph
replay ``_kernel_forward`` and ``_kernel_backward`` at each of SHAPES
(STAGED_SHAPES with ``--staged``, WIDE_STAGED_SHAPES with
``--wide-staged``), with the forward's max abs error and
the backward's error over (1 + max-abs) against the plain versions; with
``--decode`` it times ``chip_smoke._contract_decode_case`` (error, SDPA
with a mask beside), the decode wrapper's split-plan constants
(``MMA_TILE``, ``MMA_BLOCKS``, ``MMA_MIN_ROWS``) read from the variant's
``common.cuh``. Prints one JSON line a run (with ptxas's registers and
spills of the ``wgmma_wide`` kernels (and with ``--wide-staged`` the
copy's), with ``--staged`` of the backward's wgmma and staging kernels,
with ``--decode`` of ``decode_mma_kernel``, with ``--wide-f32`` of route
``wide``'s kernels) and the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = [(8, 2, 288), (8, 8, 512), (8, 1, 576), (8, 8, 384), (8, 8, 768),
          (8, 8, 448)]      # (hq, hkv, d)
STAGED_SHAPES = [(8, 8, 100), (8, 2, 99)]
WIDE_STAGED_SHAPES = [(8, 8, 257), (8, 2, 300), (8, 8, 264)]
# route "wide": (hq, hkv, d, dtype name)
WIDE_F32_SHAPES = [(8, 8, 257, "float32"), (8, 2, 288, "float32"),
                   (8, 8, 512, "float32"), (8, 1, 576, "float32"),
                   (8, 8, 800, "bfloat16")]
# route "wide" at one tile, and the staged bf16 forward
SIMT_TILE_SHAPES = [(8, 1, 256, "float32"), (32, 8, 160, "float32"),
                    (8, 8, 100, "bfloat16"), (8, 2, 99, "bfloat16")]


def _follow_routes(kf, common: str) -> None:
    """Point the wrapper's bf16 routes above 256 at the variant's
    ``tc_wide_route`` and ``tc_wide_staged_route`` (each a one-statement
    predicate of d in its ``common.cuh``), so it allocates the scratch
    wherever the variant's dispatch stages the rows."""
    import re

    import torch
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (\w+) = (\d+);", common)}

    def pred(name):
        body = re.search(rf"inline bool {name}\(int d\) \{{\s*return "
                         rf"([^;]+);", common).group(1)
        body = " ".join(body.split()).replace("&&", " and ")
        return lambda d: eval(body, dict(const, d=d))
    aligned, staged = pred("tc_wide_route"), pred("tc_wide_staged_route")

    def follow(design):
        def route(dtype, d):
            if dtype == torch.bfloat16 and d > kf.MAX_HEAD_DIM:
                if staged(d):
                    return "wgmma_wide_staged"
                if aligned(d):
                    return "wgmma_wide"
            return design(dtype, d)
        return route
    kf.fwd_design, kf.bwd_design = follow(kf.fwd_design), \
        follow(kf.bwd_design)


DECODE_SHAPES = [(8, 1, 256), (16, 16, 256)]
DECODE_CONSTS = {"MMA_TILE": "kDecodeMmaTile",
                 "MMA_BLOCKS": "kDecodeMmaBlocks",
                 "MMA_MIN_ROWS": "kDecodeMmaMinRows"}


def decode_worker(vdir: str) -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import re

    import torch

    from repro_torch.kernels import _build
    _build.CSRC_DIR = pathlib.Path(vdir)
    _build.BUILD_ROOT = pathlib.Path(vdir) / "_build"
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as kd

    common = (pathlib.Path(vdir) / "common.cuh").read_text()
    for py, c in DECODE_CONSTS.items():
        setattr(kd, py, int(re.search(rf"constexpr int {c} = (\d+);",
                                      common).group(1)))
    info = _build.build()
    out = {"variant": os.path.basename(vdir), "build_s": info.seconds,
           **{py: getattr(kd, py) for py in DECODE_CONSTS},
           "regs": [p for p in cs._ptxas_summary(info.ptxas)
                    if "decode_mma" in p]}
    for hq, hkv, d in DECODE_SHAPES:
        for lse in (False, True):
            c = cs._contract_decode_case(hq, hkv, d, torch.bfloat16, lse)
            out[f"{hq}/{hkv} d{d} {'partial' if lse else 'plain'}"] = {
                k: c[k] for k in ("ms", "library_ms", "max_abs_err")}
    print(json.dumps(out), flush=True)


def worker(vdir: str, staged: bool = False, wide_staged: bool = False,
           wide_f32: bool = False, simt_tile: bool = False) -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from repro_torch.kernels import _build
    _build.CSRC_DIR = pathlib.Path(vdir)
    _build.BUILD_ROOT = pathlib.Path(vdir) / "_build"
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as kf

    if wide_staged:
        _follow_routes(kf, (pathlib.Path(vdir) / "common.cuh").read_text())
    info = _build.build()
    out = {"variant": os.path.basename(vdir), "build_s": info.seconds,
           "regs": [p for p in cs._ptxas_summary(info.ptxas)
                    if ("wgmma_kernel<bf16,128" in p or "stage_rows" in p
                        if staged else
                        "wide_kernel" in p and "wgmma" not in p
                        if wide_f32 else
                        "stage_rows" in p or "wide_kernel<f32" in p and
                        ",2>" in p or "flash_fwd_wgmma_kernel" in p
                        if simt_tile else "wgmma_wide" in p or
                        wide_staged and "flash_stage_rows" in p)]}

    def rnd(shape, seed, dtype=torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    shapes = STAGED_SHAPES if staged else \
        WIDE_STAGED_SHAPES if wide_staged else \
        WIDE_F32_SHAPES if wide_f32 else \
        SIMT_TILE_SHAPES if simt_tile else SHAPES
    for hq, hkv, d, *dt in shapes:
        b, s = 8, 256
        dtype = getattr(torch, dt[0]) if dt else torch.bfloat16
        q, k, v = rnd((b, s, hq, d), 0, dtype), \
            rnd((b, s, hkv, d), 1, dtype), rnd((b, s, hkv, d), 2, dtype)
        do = rnd((b, s, hq, d), 3, dtype)
        sc = d ** -0.5
        o, lse = kf._kernel_forward(q, k, v, True, sc, with_lse=True)
        err = (o.float() - kf.plain(q, k, v).float()).abs().max().item()
        got = kf._kernel_backward(q, k, v, o, do, lse, True, sc)
        want = kf.plain_bwd(q, k, v, o, do, lse, causal=True, scale=sc)
        berr = max(((a.float() - c.float()).abs().max() /
                    (1 + c.float().abs().max())).item()
                   for a, c in zip(got, want))
        name = f"{hq}/{hkv} d{d}" + (f" {dt[0]}" if dt else "")
        out[name] = {
            "fwd_ms": cs.time_ms(lambda: kf._kernel_forward(q, k, v, True,
                                                            sc)),
            "bwd_ms": cs.time_ms(lambda: kf._kernel_backward(
                q, k, v, o, do, lse, True, sc), 5),
            "fwd_err": err, "bwd_rel": berr}
        if wide_staged or wide_f32 or simt_tile:
            out[name].update(
                design=kf.fwd_design(dtype, d),
                fwd_kernel_us=cs.device_us(lambda: kf._kernel_forward(
                    q, k, v, True, sc)),
                bwd_kernel_us=cs.device_us(lambda: kf._kernel_backward(
                    q, k, v, o, do, lse, True, sc)))
    print(json.dumps(out), flush=True)


def main() -> None:
    flags = [a for a in sys.argv[1:]
             if a in ("--staged", "--wide-staged", "--decode",
                      "--wide-f32", "--simt-tile")]
    args = [a for a in sys.argv[1:] if a not in flags]
    if args[0] == "--worker":
        if "--decode" in flags:
            decode_worker(args[1])
        else:
            worker(args[1], "--staged" in flags, "--wide-staged" in flags,
                   "--wide-f32" in flags, "--simt-tile" in flags)
        return
    dirs = args
    for vdir in dirs + dirs[::-1]:
        r = subprocess.run([sys.executable, __file__, "--worker", vdir,
                            *flags],
                           capture_output=True, text=True, timeout=900)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        print(lines[-1] if lines else
              f"{vdir}: rc {r.returncode} {r.stderr[-2000:]}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
