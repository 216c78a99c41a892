#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. ``device``   card name and power limit (nvidia-smi), the card's power
                draw before any work beside the idle floor that the
                runtime's ``h100_sxm`` spec assumes, torch and CUDA
                versions. No card: exit non-zero before any result.
2. ``build``    nvcc builds ``src/repro_torch/csrc/*.cu`` for sm_90a; build
                time and each kernel's registers/spills from ``-Xptxas -v``;
                fails if an instantiation the main paths launch spills.
3. ``kernels``  each hand-written kernel against its plain PyTorch version
                on the card, at the full-width shapes each serving path
                gives it (rmsnorm at the three models' widths; flash at
                prompts of 101, 333, 512 and 700 tokens at internlm2's
                heads and of 333 at granite-moe's, bf16 on the wgmma
                kernel and fp32 on the CUDA-core one; decode at the serve
                cache at both models' heads and at a cache of 4096;
                ssd_scan at 512, 129, 101 and
                1024 steps in bf16 on its tensor-core design, with each of
                its kernels' device time from torch.profiler, and at 512
                and 129 in fp32 on its CUDA-core one), in bf16 and fp32:
                max error, kernel time, plain-version time, the time of
                the nearest PyTorch library call, and the bound (the least
                time the card could take for the same work).
                phi3-medium-14b, stablelm-12b, internvl2-1b,
                musicgen-large and bert-base add rmsnorm at d 5120,
                896, 2048 and 768, flash at their heads (stablelm-12b's
                32/8 at d 160 on the wgmma kernel's three boxes), decode at
                their heads (internvl2-1b's group of 7; stablelm-12b's d
                160 at the serve cache and at 4096) and at
                llama4-maverick's 40/8 (group 5), which has no full-width
                path: its launches, like int8_matmul's, are the ones
                checked here.
                ``int8_matmul`` has no model call site; this phase is its
                path, and its launches here are the ones reported; beside
                its library call (``torch._int_mm`` and the scales) it
                times ``torch._int_mm`` alone (``int_mm_ms``).
4. ``serve``    three paths, each full width in bf16 with random weights,
                8 requests through ``repro_torch.launch.serve.serve``,
                which runs them through the port's ``ClusterRuntime``
                (activation gating, modelled energy over ``h100_sxm()``):
                internlm2-1.8b (rmsnorm, flash and decode attention),
                mamba2-130m (rmsnorm, ssd_scan), granite-moe-1b-a400m
                (rmsnorm, flash and decode attention; MoE layers), and
                phi3-medium-14b, stablelm-12b, internvl2-1b (tokens only,
                as the JAX launcher serves it), musicgen-large and
                bert-base (rmsnorm, flash and decode attention), each
                model freed before the next loads. Every
                kernel's launch count is reset just before each and read
                just after; the path's
                own kernels must have launched, the others not. The
                runtime's telemetry must equal, field for field, that of a
                run of the same counts on the CPU at smoke size (it is
                modelled per tick from counts alone).
5. ``profile``  one prefill and a few decode ticks of each model:
                host time per step, then under torch.profiler the kernels'
                device time per step and the device's idle share.
6. ``train``    internlm2-1.8b at full width in bf16 through the port's
                ``Trainer`` (``repro_torch.launch.train``'s config:
                ``default_train_config``, remat "full", seq 256, batch 8):
                8 steps with fp32 moments, each loss finite; launches a
                step checked (rmsnorm 97, rmsnorm_bwd 49, flash 48,
                flash_bwd 24, nothing else); a run saved at step 4,
                restored into a fresh ``Trainer`` and continued to step 8
                must give the unbroken run's losses bit for bit; then 3
                steps with int8 moments. Step ms, grad norm,
                ``max_memory_allocated``; one more step timed, then traced
                (device busy ms, idle share, top kernels).
7. ``train_parity`` fp32 internlm2-1.8b at full width with 2 layers: one
                ``loss_fn`` and its gradient on the card (kernels, their
                backward kernels) and on the CPU (plain versions): the
                loss and every gradient leaf, relative to its max-abs,
                within ``PARITY_TOL``.
8. ``parity``   each model in fp32 at cut depth, on the card (kernels)
                and on the CPU (plain versions): prefill and per-slot decode
                logits must agree. For the MoE model each MoE layer's
                top-k experts are recorded on both sides; a sequence whose
                routing differed in any layer (a near-tie of the k-th and
                next expert, flipped by fp32 rounding) has its later logits
                left out of the comparison and counted on the line, and a
                flip at a top-k gap above ``FLIP_GAP`` fails the run.
                Without MoE layers the card's greedy tokens must equal the
                CPU's. stablelm-12b (d 160) and internvl2-1b (group 7, its
                256 frontend embeddings prefilled first) have this phase
                too.
9. ``fleet_parity`` the port's fleet engine, ``Fleet(backend="torch")`` on
                the card (one tick captured as a CUDA graph, replayed a
                block of 128 ticks at a time), against the port's
                ``Fleet(backend="vector")`` on the host, over fig16's
                parity set: the mixed 8 SoC + 2 Xeon fleet under each
                router on the short diurnal trace and under round-robin
                on the flash crowd, the 6-rack schedutil + thermal fleet,
                and an under-provisioned hedging fleet. Integer series
                (ticks, drained, active units, queued, hedges, scale
                events, throttled units) must be equal, the rest within
                the JAX engine's ``RTOL``/``ATOL``; the largest relative
                error of each series is printed.
10. ``fleet_sweep`` fig16's batched sweep, ``sweep()`` of 64 configs x 100
                racks (6000 SoCs) x 24 h at 300 s ticks on the card:
                warm seconds graph-replayed (each sweep captures its
                tick anew) and eager, scenarios/s beside
                the vector loop's (8 configs run one by one, extrapolated
                to 64 as fig16 does), ``max_memory_allocated``, a traced
                sweep's device-busy share and kernels a tick. Those 8 rows
                must be within 1e-9 of their dedicated vector runs, and a
                repeated sweep and an eager one equal to it bit for bit.
                Neither fleet phase runs a hand-written kernel: every
                launch count must stay 0 across them.

The ``kernels`` phase also holds the two backward kernels
(``rmsnorm_bwd``, ``flash_attention_bwd``) to their closed-form plain
backwards at the training shapes (2048 x 2048; b 8, s 256, 16/8 heads,
d 128, bf16 and fp32; the flash backward in bf16 at granite-moe's d 64
too), beside their library call's backward timed through autograd
(``F.rms_norm``, ``F.scaled_dot_product_attention``). Each flash backward
case names its route (``design``: the wgmma kernels for bf16 at d 64 and
128, the CUDA-core ones otherwise), and the ``train`` profile reads the
step's flash backward device time (``flash_bwd_device_ms``).

Then the summary line of kernels (one row per kernel and path: a kernel
several paths run, rmsnorm on all three and flash and decode on two, has
a row for each, with that path's launches and its case at that path's
shape; the training path has rows for rmsnorm, flash and both backward
kernels, with the launches of its 8-step run), the nvidia-smi line, and
the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.config import (ServeConfig, get_config,  # noqa: E402
                                smoke_config)
from repro_torch.core.cluster import (edge_server_cpu,  # noqa: E402
                                      h100_sxm, soc_cluster)
from repro_torch.fleet import (ROUTERS, Fleet,  # noqa: E402
                               JoinShortestQueueRouter, PowerAwareRouter,
                               RoundRobinRouter, SweepConfig, diurnal_trace,
                               flash_crowd_trace, homogeneous_fleet,
                               scale_to_users, sweep)
from repro_torch.fleet import torch_engine as tte  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import int8_matmul as kint8  # noqa: E402
from repro_torch.kernels import rmsnorm as krms  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import data_config, train_config  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.power import (SchedutilGovernor,  # noqa: E402
                               ThermalParams, sd865_opp_table)
from repro_torch.runtime import ScalePolicy  # noqa: E402
from repro_torch.serving.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.data import (PrefetchingLoader,  # noqa: E402
                                       _gen_batch)
from repro_torch.training.optimizer import adamw_update  # noqa: E402
from repro_torch.training.train_loop import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "internlm2-1.8b"
# Prompt lengths of the serve phase: 100..700 tokens, none a multiple of 64
# (the flash kernel's tile), so every prefill has a ragged edge.
PROMPT_LENS = [333, 129, 700, 517, 258, 450, 101, 611]
NEW_TOKENS = 32
SLOTS = 4
MAX_LEN = max(PROMPT_LENS) + NEW_TOKENS + 8
# The serve phase's CPU twin: the same counts at smoke size, one prompt
# length that keeps the smoke SSD contract (<= its chunk of 32).
CPU_PROMPT_LEN = 16
# What the serve line's telemetry and tokens/s are: the runtime counts
# each tick as one modelled second, and its unit_rate decides how many
# slots it wakes.
ENERGY_MODEL = ("h100_sxm (8 shares), assumed idle floor, "
                "1 modelled s a tick")
THROUGHPUT = "gated by unit_rate=0.25 req/s a share, not capacity"
# decode_attention cases: (cache rows, per-slot lengths); the first is the
# serve run's cache.
DECODE_CASES = ((MAX_LEN, [129, 334, 517, 731]),
                (4096, [4000, 2731, 1290, 65]))
PARITY_LAYERS = 2
PARITY_SIDES = {"card": "cuda", "cpu": "cpu"}   # side -> device

MAMBA_ARCH = "mamba2-130m"
# Each <= 256 (the SSD chunk: one ragged chunk) or a multiple of it (the
# state carried across chunks), as the JAX contract asks.
MAMBA_PROMPT_LENS = [512, 129, 1024, 256, 200, 768, 101, 255]
MAMBA_PARITY_PROMPTS = (77, 200)
# ssd_scan cases of the kernels phase, by dtype: the first is a 512-token
# prefill (the row of the summary line), then the serve run's shortest and
# longest prompts. bf16 runs the tensor-core design, fp32 the CUDA-core one.
SSD_LENS = {torch.bfloat16: (512, 129, 101, 1024), torch.float32: (512, 129)}
MOE_ARCH = "granite-moe-1b-a400m"
# The other dense, VLM and audio archs, each served at full width through
# the launcher; stablelm-12b's head_dim 160 and internvl2-1b's group of 7
# are new shapes for the flash and decode kernels, and get a parity phase.
NEW_ARCHS = ("phi3-medium-14b", "stablelm-12b", "internvl2-1b",
             "musicgen-large", "bert-base")
NEW_PARITY_ARCHS = ("stablelm-12b", "internvl2-1b")
# llama4-maverick-400b-a17b is not served at full width on one card; its
# decode heads (40/8, group 5) are checked in the kernels phase alone.
GROUP5_ARCH = "llama4-maverick-400b-a17b"
ATTN_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
# Kernels each model's path runs; every other kernel must stay at 0.
PATH_KERNELS = {ARCH: ATTN_KERNELS,
                MAMBA_ARCH: ("rmsnorm", "ssd_scan"),
                MOE_ARCH: ATTN_KERNELS,
                **{arch: ATTN_KERNELS for arch in NEW_ARCHS}}
# The training path: internlm2-1.8b at the launcher's seq and batch, full
# remat; per step every layer's forward runs twice (remat), the final norm
# once, and each backward once.
TRAIN_PATH = f"train {ARCH}"
TRAIN_SEQ, TRAIN_BATCH = 256, 8
TRAIN_STEPS, TRAIN_INT8_STEPS, TRAIN_SAVE_AT = 8, 3, 4
TRAIN_CKPT_DIR = "chiprun_train_ckpt"       # in the checkout, gitignored
_L = 24
TRAIN_LAUNCHES = {"rmsnorm": 4 * _L + 1, "rmsnorm_bwd": 2 * _L + 1,
                  "flash_attention": 2 * _L, "flash_attention_bwd": _L}
TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 128
# int8_matmul has no model call site: the kernels phase is its path, at
# the JAX benchmark's shape and an MLP up projection of a 333-token prefill.
KERNELS_PHASE = "kernels phase"
INT8_SHAPES = ((512, 1024, 512), (333, 2048, 8192))

# H100 SXM data sheet (dense): HBM rate and peak arithmetic rates by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12,   # tensor cores
            torch.float32: 67e12,     # fp32 outside the tensor cores
            torch.int8: 1979e12}      # int8 tensor cores

# Kernel vs plain version on the card. bf16: both compute in fp32 and round
# the output once, so they differ by about one bf16 ulp (2^-8 relative).
# fp32: the kernel sums in another order than the plain version's einsum
# (and on the CPU the tests hold the plain version to 2e-6).
KERNEL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# ssd_scan: the kernels' 64-step tiles against the plain version's chunk
# of 256 (chunk-invariant math, fp32 sums in another order; the bf16
# tensor-core design feeds operands with an fp32 factor as bf16 hi/lo
# pairs): fp32 y and the fp32 state at tests/test_kernels_ssd.py's 2e-4;
# bf16 y at one ulp.
SSD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
# int8_matmul: exact int32 sums and the same fp32 epilogue: bit for bit.
INT8_TOL = 0.0
# Logits of the fp32 model, card (kernels, cuBLAS) vs CPU (plain versions):
# 2048- and 8192-long fp32 sums in other orders, through two layers.
PARITY_TOL = 1e-3
# A routing flip, card vs CPU, is noise only where the k-th and the next
# expert's probabilities lie closer than fp32 rounding can move them.
FLIP_GAP = 1e-4

SOURCES = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:22"),
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:22"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:78"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:69"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:73"),
    "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                    "src/repro/kernels/int8_matmul.py:43"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing and bounds.
# ---------------------------------------------------------------------------
def _events_ms(run, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call: CUDA events around replays of a CUDA graph
    that holds ``iters`` calls, after a warm-up, so the host's launch cost
    is not in it. Inputs stay in the 50 MB L2 where they fit, as they do in
    the model (each input was just written by the op before)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def replay():
        for _ in range(reps):
            graph.replay()
    return _events_ms(replay, reps * iters)


def eager_ms(fn, iters: int = 50) -> float:
    """Time of one call launched from Python, back to back: where the host
    is slower than the device, this is the host's cost per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run, iters)


def bound(nbytes: float, nops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out: torch.Tensor, want: torch.Tensor, dtype,
            tol: float | None = None) -> float:
    """Max abs error; raises past atol = rtol = ``tol`` (default
    KERNEL_TOL[dtype])."""
    out, want = out.float(), want.float()
    err = (out - want).abs()
    tol = KERNEL_TOL[dtype] if tol is None else tol
    if not torch.isfinite(out).all() or bool((err > tol + tol * want.abs())
                                             .any()):
        raise AssertionError(f"kernel disagrees with plain version: max abs "
                             f"err {err.max().item()} (tol {tol})")
    return err.max().item()


def device_us(fn, iters: int = 10) -> dict:
    """Device time of each CUDA kernel ``fn`` launches, in microseconds a
    call, from torch.profiler over ``iters`` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"^(void )?(repro::)?(\(anonymous namespace\)::)?",
                          "", e.name).split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / iters
    return out


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------
def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = h100_sxm()
    info = {"phase": "device", "nvidia_smi": nvidia_smi(),
            "power_draw": nvidia_smi("power.draw"),
            "h100_sxm_assumed_idle_w": spec.unit.p_idle * spec.n_units,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return info


def _ptxas_summary(lines):
    """ptxas's 'Compiling entry function', spill and 'Used' lines of each
    kernel -> one short label per instantiation."""
    out, name, spill = [], None, None
    for ln in lines:
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            name, spill = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
            continue
        used = re.search(r"Used (\d+) registers", ln)
        if used and name:
            kern = re.search(r"(rmsnorm_kernel|rmsnorm_bwd_kernel|"
                             r"rmsnorm_dw_kernel|flash_fwd_wgmma_kernel|"
                             r"flash_fwd_simt_kernel|flash_bwd_\w+_kernel|"
                             r"decode_split_kernel|"
                             r"ssd_tc_states_kernel|ssd_tc_pass_kernel|"
                             r"ssd_tc_outputs_kernel|ssd_scan_simt_kernel|"
                             r"int8_wgmma_kernel)", name)
            # the flash wgmma kernel is bf16 only and has no dtype parameter
            dt = "bf16" if "bfloat16" in name or "flash_fwd_wgmma" in name \
                else "f32"
            args = ",".join([dt, *re.findall(r"L[ib](\d+)E", name)])
            out.append(f"{kern.group(1) if kern else name}<{args}>: "
                       f"{used.group(1)} regs, {spill or '?'} B spill")
            name = None
    return out


def _main_path_patterns() -> list:
    """Patterns of the ptxas labels of the instantiations the main paths
    launch: rmsnorm at each path's width in bf16, int8_matmul at the
    kernels phase's shapes (16-byte loads), flash and decode at each
    attention path's head dim in bf16 (decode at the bucket of its group),
    each of ssd_scan's three
    tensor-core kernels (the bf16 path) and its CUDA-core kernel (the fp32
    parity path), the training path's backward kernels at internlm2's
    width and head dim in bf16 (flash: the wgmma design), and the flash
    backward's CUDA-core kernels in fp32 at that head dim (the train_parity
    path)."""
    pats = [r"ssd_tc_states_kernel<bf16>", r"ssd_tc_pass_kernel<bf16>",
            r"ssd_tc_outputs_kernel<bf16>", r"ssd_scan_simt_kernel<\w+>",
            r"rmsnorm_dw_kernel<f32>"]
    cfg = get_config(ARCH)
    vec, nv, _ = krms.bwd_plan(1, cfg.d_model, 2, True, 1)
    pats.append(rf"rmsnorm_bwd_kernel<bf16,{8 if vec else 1},{nv}>")
    hd = cfg.resolved_head_dim
    pats += [rf"flash_bwd_{k}_kernel<bf16,{hd}>"
             for k in ("preprocess", "dkdv_wgmma", "dq_wgmma")]
    pats += [rf"flash_bwd_{k}_kernel<f32,{hd}>"
             for k in ("preprocess", "dkdv", "dq")]
    for arch in PATH_KERNELS:
        cfg = get_config(arch)
        vec, nv, wpr, _ = krms.plan(1, cfg.d_model, 2, True)
        pats.append(rf"rmsnorm_kernel<bf16,{8 if vec else 1},{nv},{wpr}>")
        if "flash_attention" in PATH_KERNELS[arch]:
            hd, g = cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads
            gm = kdec.group_bucket(g)
            pats += [rf"flash_fwd_wgmma_kernel<bf16,{hd}>",
                     rf"decode_split_kernel<bf16,{hd},{gm},{int(g == gm)}>"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, k, n in INT8_SHAPES:
        bm, bn = kint8.TILES[kint8.plan(m, k, n, 0, 0, sms)[1]]
        pats.append(rf"int8_wgmma_kernel<\w+,{bm // 64},{bn},\d+,1>")
    return pats


def phase_build() -> None:
    """Build, then report each kernel's registers and spills; a kernel the
    main paths launch must have been reported, and must not spill."""
    info = _build.build()
    ptxas = _ptxas_summary(info.ptxas)
    spills = [p for p in ptxas if not p.endswith(", 0 B spill")]
    pats = _main_path_patterns()
    main = [p for p in ptxas
            if any(re.fullmatch(pat, p.split(":")[0]) for pat in pats)]
    missing = [pat for pat in pats
               if not any(re.fullmatch(pat, p.split(":")[0]) for p in main)]
    emit({"phase": "build", "seconds": info.seconds, "cached": info.cached,
          "library": os.path.relpath(info.path), "entries": len(ptxas),
          "spills": spills, "main_path": main})
    if missing:
        raise AssertionError(f"ptxas reported no instantiation of {missing}")
    main_spills = [p for p in main if not p.endswith(", 0 B spill")]
    if main_spills:
        raise AssertionError(f"main-path kernels spill: {main_spills}")


def _rmsnorm_case(path, rows, d, dtype, lowp, seed=0):
    x, w = randn((rows, d), dtype, seed), randn((d,), torch.float32, seed + 1)
    out = krms.rmsnorm(x, w, 1e-5, lowp=lowp)
    torch.cuda.synchronize()
    err = max_err(out, krms.plain(x, w, 1e-5, lowp), dtype)
    wl = w.to(dtype)
    e = x.element_size()
    b_ms, by = bound(2 * rows * d * e + 4 * d, 4 * rows * d, torch.float32)
    return {"kernel": "rmsnorm", "path": path, "shape": [rows, d],
            "dtype": str(dtype),
            "lowp": lowp, "max_abs_err": err,
            "ms": time_ms(lambda: krms.rmsnorm(x, w, 1e-5, lowp=lowp)),
            "eager_ms": eager_ms(lambda: krms.rmsnorm(x, w, 1e-5, lowp=lowp)),
            "plain_ms": time_ms(lambda: krms.plain(x, w, 1e-5, lowp)),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), wl, 1e-5)),
            "bound_ms": b_ms, "bound_by": by}


def _rmsnorm_bwd_case(rows, d, dtype, seed=0):
    """The backward of one norm of a training step: ``rows`` = b x s."""
    x, w = randn((rows, d), dtype, seed), randn((d,), torch.float32, seed + 1)
    dy = randn((rows, d), dtype, seed + 2)
    dx, dw = krms._kernel_backward(x, w, dy, 1e-5)
    torch.cuda.synchronize()
    want_dx, want_dw = krms.plain_bwd(x, w, dy, 1e-5)
    err = max(max_err(dx, want_dx, dtype),
              max_err(dw, want_dw, torch.float32))
    # F.rms_norm's backward through autograd (its weight in x's dtype):
    # forward and backward replayed, less the forward alone.
    xl = x.clone().requires_grad_(True)
    wl = w.to(dtype, copy=True).requires_grad_(True)
    lib_fwd = lambda: F.rms_norm(xl, (d,), wl, 1e-5)
    lib_both = lambda: torch.autograd.grad(lib_fwd(), (xl, wl), dy)
    e = x.element_size()
    b_ms, by = bound(3 * rows * d * e + 8 * d, 8 * rows * d, torch.float32)
    return {"kernel": "rmsnorm_bwd", "path": TRAIN_PATH, "shape": [rows, d],
            "dtype": str(dtype), "max_abs_err": err,
            "ms": time_ms(lambda: krms._kernel_backward(x, w, dy, 1e-5)),
            "eager_ms": eager_ms(
                lambda: krms._kernel_backward(x, w, dy, 1e-5)),
            "plain_ms": time_ms(lambda: krms.plain_bwd(x, w, dy, 1e-5)),
            "library_ms": time_ms(lib_both) - time_ms(lib_fwd),
            "library_call": "F.rms_norm backward (autograd): forward and "
                            "backward less the forward, each replayed",
            "bound_ms": b_ms, "bound_by": by}


def _flash_bwd_case(arch, b, s, dtype, seed=0):
    """The backward of one layer's causal self-attention in training, at
    ``arch``'s heads; ``design`` names the route the call takes."""
    hq, hkv, d = _heads(arch)
    q = randn((b, s, hq, d), dtype, seed)
    k = randn((b, s, hkv, d), dtype, seed + 1)
    v = randn((b, s, hkv, d), dtype, seed + 2)
    dout = randn((b, s, hq, d), dtype, seed + 3)
    scale = d ** -0.5
    out, lse = kflash._kernel_forward(q, k, v, True, scale, with_lse=True)
    got = kflash._kernel_backward(q, k, v, out, dout, lse, True, scale)
    torch.cuda.synchronize()
    want = kflash.plain_bwd(q, k, v, out, dout, lse, causal=True,
                            scale=scale)
    err = max(max_err(g, w_, dtype) for g, w_ in zip(got, want))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dt_ = dout.transpose(1, 2)
    lib_fwd = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_both = lambda: torch.autograd.grad(lib_fwd(), (qt, kt, vt), dt_)
    e = q.element_size()
    pairs = s * (s + 1) // 2
    # Read q, k, v, out, dout (and lse) once, write dq, dk, dv; the five
    # products of the backward (S recomputed, dP, dV, dK, dQ) over the
    # causal pairs: 2.5x the forward's.
    nbytes = e * (3 * b * s * hq * d + 2 * b * s * hkv * d) + 4 * b * hq * s \
        + e * (b * s * hq * d + 2 * b * s * hkv * d)
    b_ms, by = bound(nbytes, 10 * b * hq * d * pairs, dtype)
    return {"kernel": "flash_attention_bwd", "path": TRAIN_PATH,
            "heads_of": arch, "shape": [b, s, hq, hkv, d],
            "dtype": str(dtype), "design": kflash.bwd_design(dtype, d),
            "max_abs_err": err,
            "kernel_us": device_us(lambda: kflash._kernel_backward(
                q, k, v, out, dout, lse, True, scale)),
            "ms": time_ms(lambda: kflash._kernel_backward(
                q, k, v, out, dout, lse, True, scale), 5),
            "eager_ms": eager_ms(lambda: kflash._kernel_backward(
                q, k, v, out, dout, lse, True, scale), 10),
            "plain_ms": time_ms(lambda: kflash.plain_bwd(
                q, k, v, out, dout, lse, causal=True, scale=scale), 3),
            "library_ms": time_ms(lib_both, 5) - time_ms(lib_fwd, 5),
            "library_call": "F.scaled_dot_product_attention(is_causal, "
                            "enable_gqa) backward (autograd): forward and "
                            "backward less the forward, each replayed",
            "bound_ms": b_ms, "bound_by": by}


def _heads(arch):
    cfg = get_config(arch)
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


def _flash_case(arch, sq, dtype, seed=0, b=1, path=None):
    """One layer's prefill of ``sq`` tokens at ``arch``'s heads (or, with
    ``b``, one layer's training forward)."""
    hq, hkv, d = _heads(arch)
    q = randn((b, sq, hq, d), dtype, seed)
    k = randn((b, sq, hkv, d), dtype, seed + 1)
    v = randn((b, sq, hkv, d), dtype, seed + 2)
    out = kflash.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = max_err(out, kflash.plain(q, k, v, causal=True), dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    e = q.element_size()
    pairs = sq * (sq + 1) // 2          # causal (query, key) pairs
    b_ms, by = bound(e * (2 * b * sq * hq * d + 2 * b * sq * hkv * d),
                     4 * b * hq * d * pairs, dtype)
    return {"kernel": "flash_attention", "path": path or arch,
            "shape": [b, sq, hq, hkv, d],
            "dtype": str(dtype), "max_abs_err": err,
            "ms": time_ms(lambda: kflash.flash_attention(q, k, v)),
            "eager_ms": eager_ms(lambda: kflash.flash_attention(q, k, v)),
            "plain_ms": time_ms(lambda: kflash.plain(q, k, v), 5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": by}


def _decode_case(arch, dtype, skv, lengths, seed=0, path=None):
    """One layer's decode tick of SLOTS slots against a cache of ``skv`` at
    ``arch``'s heads (``path``, where no serve run of ``arch`` gives the
    row its launches: the kernels phase, which counts its checked call)."""
    b, (hq, hkv, d) = SLOTS, _heads(arch)
    q = randn((b, hq, d), dtype, seed)
    k = randn((b, skv, hkv, d), dtype, seed + 1)
    v = randn((b, skv, hkv, d), dtype, seed + 2)
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = kdec.KERNEL.launches
    out = kdec.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    launches = kdec.KERNEL.launches - before
    err = max_err(out, kdec.plain(q, k, v, length), dtype)
    mask = (torch.arange(skv, device="cuda")[None, :] < length[:, None])
    mask = mask[:, None, None, :]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    e = q.element_size()
    b_ms, by = bound(e * (2 * b * hq * d + 2 * sum(lengths) * hkv * d)
                     + 4 * b, 4 * sum(lengths) * hq * d, dtype)
    return {"kernel": "decode_attention", "path": path or arch,
            "heads_of": arch, "shape": [b, skv, hq, hkv, d],
            "group_bucket": kdec.group_bucket(hq // hkv),
            "checked_launches": launches,
            "splits": kdec.num_splits(skv), "lengths": lengths,
            "dtype": str(dtype), "max_abs_err": err,
            "ms": time_ms(lambda: kdec.decode_attention(q, k, v, length)),
            "eager_ms": eager_ms(
                lambda: kdec.decode_attention(q, k, v, length)),
            "plain_ms": time_ms(lambda: kdec.plain(q, k, v, length), 10),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": by}


def _ssd_case(s, dtype, seed=0):
    """One SSD layer of mamba2-130m at batch 1 and ``s`` steps."""
    b, h, p, n, chunk = 1, 24, 64, 128, 256
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device="cuda").to(dtype)
    dt = 0.01 + 0.29 * torch.rand((b, s, h), generator=g, device="cuda")
    A = -(0.3 + 1.7 * torch.rand((h,), generator=g, device="cuda"))
    B = torch.randn((b, s, n), generator=g, device="cuda").to(dtype)
    C = torch.randn((b, s, n), generator=g, device="cuda").to(dtype)
    D = torch.randn((h,), generator=g, device="cuda")
    args = (x, dt, A, B, C, D)
    y, st = kssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    want_y, want_st = kssd.plain(*args, chunk=chunk)
    err = max(max_err(y, want_y, dtype, SSD_TOL[dtype]),
              max_err(st, want_st, torch.float32, SSD_TOL[torch.float32]))
    e = x.element_size()
    # Work of the chunked algorithm at the model's chunk, causal pairs only:
    # C.B^T once per batch and chunk (shared by the heads), then per head
    # M.(dt x), the read of the carried state and its update.
    q = min(chunk, s)
    nc, pairs = s // q, q * (q + 1) // 2
    nops = b * nc * (2 * n * pairs + h * (2 * p * pairs + 4 * q * n * p))
    nbytes = (e * (2 * b * s * h * p + 2 * b * s * n) + 4 * b * s * h
              + 8 * h + 4 * b * h * p * n)
    b_ms, by = bound(nbytes, nops, dtype)
    return {"kernel": "ssd_scan", "path": MAMBA_ARCH,
            "shape": [b, s, h, p, n], "chunk": chunk,
            "design": kssd.DESIGNS[kssd.plan(dtype, n, p)],
            "dtype": str(dtype), "max_abs_err": err,
            "kernel_us": device_us(lambda: kssd.ssd_scan(*args,
                                                          chunk=chunk)),
            "ms": time_ms(lambda: kssd.ssd_scan(*args, chunk=chunk)),
            "eager_ms": eager_ms(lambda: kssd.ssd_scan(*args, chunk=chunk)),
            "plain_ms": time_ms(lambda: kssd.plain(*args, chunk=chunk), 5),
            "library_ms": None,
            "library_note": "no single PyTorch call computes the SSD scan",
            "bound_ms": b_ms, "bound_by": by}


def _int8_case(m, k, n, out_dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                       dtype=torch.int8)
    sx = torch.rand((m,), generator=g, device="cuda") / 127
    sw = torch.rand((n,), generator=g, device="cuda") / 127
    before = kint8.KERNEL.launches
    out = kint8.int8_matmul(xq, sx, wq, sw, out_dtype)
    torch.cuda.synchronize()
    launches = kint8.KERNEL.launches - before
    err = max_err(out, kint8.plain(xq, sx, wq, sw, out_dtype), out_dtype,
                  INT8_TOL)

    def library():      # timed only: the port never calls torch._int_mm
        acc = torch._int_mm(xq, wq)
        return (acc.float() * sx[:, None] * sw[None, :]).to(out_dtype)
    vec, tile = kint8.plan(m, k, n, xq.data_ptr(), wq.data_ptr(),
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    b_ms, by = bound(m * k + k * n + 4 * (m + n) + m * n * out.element_size(),
                     2 * m * k * n, torch.int8)
    return {"kernel": "int8_matmul", "path": KERNELS_PHASE,
            "shape": [m, k, n], "vec": vec, "tile": kint8.TILES[tile],
            "dtype": str(out_dtype), "max_abs_err": err,
            "checked_launches": launches,
            "ms": time_ms(lambda: kint8.int8_matmul(xq, sx, wq, sw,
                                                    out_dtype)),
            "eager_ms": eager_ms(lambda: kint8.int8_matmul(xq, sx, wq, sw,
                                                           out_dtype)),
            "plain_ms": time_ms(lambda: kint8.plain(xq, sx, wq, sw,
                                                    out_dtype), 5),
            "library_ms": time_ms(library),
            "library_call": "torch._int_mm, then the scales",
            "int_mm_ms": time_ms(lambda: torch._int_mm(xq, wq)),
            "bound_ms": b_ms, "bound_by": by}


def phase_kernels() -> dict:
    """Returns, for each (kernel, path), the first bf16 case: the shape
    that path gives the kernel (int8_matmul: the JAX benchmark's shape, in
    fp32 as the JAX kernel's default output). The ``launches`` of a case
    whose path is the kernels phase (int8_matmul; decode at
    llama4-maverick's heads) are its checked calls here: no model path
    runs it at full width."""
    d_model = {a: get_config(a).d_model for a in PATH_KERNELS}
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        # rmsnorm at each path's width: one prefill (internlm2 and
        # granite-moe: 333 tokens, mamba2: 512) and one decode tick of
        # SLOTS rows, lowp off first as the configs run it.
        for arch, rows in ((ARCH, PROMPT_LENS[0]), (MAMBA_ARCH, 512),
                           (MOE_ARCH, PROMPT_LENS[0])):
            for r in (rows, SLOTS):
                for lowp in (False, True):
                    cases.append(_rmsnorm_case(arch, r, d_model[arch],
                                               dtype, lowp))
        # flash at the first prompt, then 512 and the serve run's shortest
        # and longest prompts; decode at the serve cache, then at a cache
        # of 4096 with lengths spread to 4000. granite-moe's heads (d 64)
        # at the first prompt and the serve cache.
        for sq in (PROMPT_LENS[0], 512, min(PROMPT_LENS), max(PROMPT_LENS)):
            cases.append(_flash_case(ARCH, sq, dtype))
        for skv, lengths in DECODE_CASES:
            cases.append(_decode_case(ARCH, dtype, skv, lengths))
        cases.append(_flash_case(MOE_ARCH, PROMPT_LENS[0], dtype))
        cases.append(_decode_case(MOE_ARCH, dtype, *DECODE_CASES[0]))
        # NEW_ARCHS: rmsnorm at each width (5120, 896, 2048, 768), flash at
        # the first prompt and decode at the serve cache at each arch's
        # heads; stablelm-12b's d 160 also at a cache of 4096, and
        # llama4-maverick's group of 5 (no full-width path).
        for arch in NEW_ARCHS:
            for r in (PROMPT_LENS[0], SLOTS):
                cases.append(_rmsnorm_case(arch, r, d_model[arch], dtype,
                                           False))
            cases.append(_flash_case(arch, PROMPT_LENS[0], dtype))
            cases.append(_decode_case(arch, dtype, *DECODE_CASES[0]))
        cases.append(_decode_case("stablelm-12b", dtype, *DECODE_CASES[1]))
        cases.append(_decode_case(GROUP5_ARCH, dtype, *DECODE_CASES[0],
                                  path=KERNELS_PHASE))
        for s in SSD_LENS[dtype]:
            cases.append(_ssd_case(s, dtype))
        # The training path: one norm and one attention of a step, forward
        # and backward, at b 8 x s 256.
        rows = TRAIN_BATCH * TRAIN_SEQ
        cases.append(_rmsnorm_case(TRAIN_PATH, rows, d_model[ARCH], dtype,
                                   False))
        cases.append(_rmsnorm_bwd_case(rows, d_model[ARCH], dtype))
        cases.append(_flash_case(ARCH, TRAIN_SEQ, dtype, b=TRAIN_BATCH,
                                 path=TRAIN_PATH))
        cases.append(_flash_bwd_case(ARCH, TRAIN_BATCH, TRAIN_SEQ, dtype))
        if dtype == torch.bfloat16:     # the wgmma design at d 64 too
            cases.append(_flash_bwd_case(MOE_ARCH, TRAIN_BATCH, TRAIN_SEQ,
                                         dtype))
    for m, k, n in INT8_SHAPES:
        for out_dtype in (torch.float32, torch.bfloat16):
            cases.append(_int8_case(m, k, n, out_dtype))
    emit({"phase": "kernels", "tolerance": {
        "bfloat16": KERNEL_TOL[torch.bfloat16],
        "float32": KERNEL_TOL[torch.float32],
        "ssd_scan": {"bfloat16": SSD_TOL[torch.bfloat16],
                     "float32": SSD_TOL[torch.float32]},
        "int8_matmul": INT8_TOL}, "cases": cases})
    # bf16 is the serving dtype; the first bf16 case of each (kernel, path)
    # is the shape that path gives it (one prompt of PROMPT_LENS[0] tokens
    # or one 512-token mamba2 prefill, lowp off as in the configs; decode
    # at SLOTS slots and MAX_LEN).
    head = {}
    for c in cases:
        head.setdefault((c["kernel"], c["path"]), c)
    for (name, path), c in head.items():
        if path == KERNELS_PHASE:
            c["launches"] = sum(x["checked_launches"] for x in cases
                                if (x["kernel"], x["path"]) == (name, path))
    return head


def phase_serve(smi: str, arch: str, prompt_lens) -> dict:
    """Serve ``prompt_lens`` through the launcher (and so the runtime); the
    path's own kernels must launch and the other model kernels must not,
    and the modelled telemetry must equal a CPU run's of the same
    counts."""
    cfg = get_config(arch)
    _free_card()                    # the previous model's weights
    # Warm-up (cuBLAS handles, allocator), then the measured run.
    serve(cfg, [prompt_lens[0]], max_new_tokens=2, slots=SLOTS, seed=0)
    _free_card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rep = serve(cfg, prompt_lens, max_new_tokens=NEW_TOKENS, slots=SLOTS,
                seed=0)
    launches = ops.launch_counts()
    if rep["served"] != len(prompt_lens):
        raise AssertionError(f"served {rep['served']} of {len(prompt_lens)}")
    if rep["tokens_generated"] != len(prompt_lens) * NEW_TOKENS:
        raise AssertionError(f"generated {rep['tokens_generated']} tokens")
    if not all(0 <= t < cfg.vocab_size for t in rep["sample_output"]):
        raise AssertionError(f"token ids out of range: {rep['sample_output']}")
    _check_path_launches(arch, launches)
    n_mamba = sum(k == "mamba" for k in cfg.layer_kinds())
    if launches["ssd_scan"] != len(prompt_lens) * n_mamba:
        raise AssertionError(f"ssd_scan launched {launches['ssd_scan']} "
                             f"times, not once per prefill and Mamba layer")
    # The telemetry is modelled per tick from counts (no EOS, one decode a
    # tick, utilisation from slot counts): the same counts on the CPU at
    # smoke size through the plain versions must give the same numbers.
    cpu = serve(smoke_config(cfg), [CPU_PROMPT_LEN] * len(prompt_lens),
                max_new_tokens=NEW_TOKENS, slots=SLOTS, device="cpu")
    for key in ("served", "ticks", "tokens_generated", "telemetry"):
        if cpu[key] != rep[key]:
            raise AssertionError(f"{arch}: {key} on the card {rep[key]} "
                                 f"!= CPU run {cpu[key]}")
    emit({"phase": "serve", "arch": arch, "dtype": cfg.dtype,
          "prompt_lens": list(prompt_lens), "new_tokens": NEW_TOKENS,
          "slots": SLOTS, "served": rep["served"], "ticks": rep["ticks"],
          "tokens_generated": rep["tokens_generated"],
          "tokens_per_s": rep["tokens_per_s"], "wall_s": rep["wall_s"],
          "throughput": THROUGHPUT,
          "telemetry": rep["telemetry"], "energy_model": ENERGY_MODEL,
          "telemetry_equals_cpu_run": True,
          "cpu_run": {"prompt_lens": [CPU_PROMPT_LEN] * len(prompt_lens),
                      "config": "smoke", "wall_s": cpu["wall_s"]},
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "kernel_launches": launches, "nvidia_smi": smi})
    return launches


def _free_card() -> None:
    """Collect what the last model left (engine, weights, caches) and give
    its memory back, so the next model loads into an empty card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _check_path_launches(arch: str, launches: dict) -> None:
    own = PATH_KERNELS[arch]
    missing = [k for k in own if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{arch}: kernels never launched on the path: "
                             f"{missing}")
    stray = [k for k, n in launches.items() if k not in own and n]
    if stray:
        raise AssertionError(f"{arch}: kernels of another path launched: "
                             f"{stray}")


def _device_busy_us(events):
    """Union of the CUDA kernel intervals of a profile, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def phase_profile(arch: str, prompt_lens, prefill_len: int,
                  ticks: int = 8) -> None:
    """Where the time of a serving path goes: one prefill of
    ``prefill_len`` tokens and ``ticks`` decode ticks of a full batch,
    timed without the profiler (host clock around work that ends in a
    synchronize), then again under torch.profiler for the kernels' device
    time and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(arch)
    max_len = max(prompt_lens) + NEW_TOKENS + 8
    eng = ServingEngine(cfg, ServeConfig(max_seq_len=max_len))
    eng.init_random(0)
    bat = ContinuousBatcher(eng, slots=SLOTS)
    rng = np.random.default_rng(0)
    for n in prompt_lens[:SLOTS]:
        bat.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=4 * ticks)
    bat.step()                      # admits SLOTS requests, first decode
    for _ in range(2):
        bat.step()
    torch.cuda.synchronize()
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, prefill_len)
                             [None], dtype=torch.long, device="cuda")

    def prefill():
        eng.prefill_fn(eng.params, {"tokens": prompt})

    def decode():
        for _ in range(ticks):
            bat.step()

    prefill()                       # warm this prompt length
    torch.cuda.synchronize()
    out = {"phase": "profile", "arch": arch, "dtype": cfg.dtype,
           "prefill_tokens": prefill_len, "slots": SLOTS, "ticks": ticks}
    for name, run, n in (("prefill", prefill, 1), ("decode", decode, ticks)):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / n
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
        busy_ms = _device_busy_us(kern) / 1e3 / n
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[name] = {
            "wall_ms": wall_ms, "traced_wall_ms": traced_ms,
            "device_busy_ms": busy_ms if kern else None,
            "device_idle_share": 1 - busy_ms / traced_ms if kern else None,
            "kernels_per_step": len(kern) / n,
            "top_device_us_per_step": [[k[:60], v / n] for k, v in top]}
    emit(out)
    del eng, bat


class RouterLog:
    """While active, records each MoE layer call's routing on the side
    ``side`` names: every token's top-k experts (as a sorted set) and the
    gap between the k-th and the next expert's probability."""

    def __init__(self):
        self.side = None
        self.calls = {side: [] for side in PARITY_SIDES}
        self.token_layers = 0
        self.min_gap = float("inf")
        self._orig = moe.moe_apply

    def __enter__(self):
        def recorded(params, cfg, x, **kw):
            k, e = cfg.moe.top_k, cfg.moe.num_experts
            xt = x.reshape(-1, x.shape[-1])
            probs = torch.softmax(xt.float() @ params["router"].float(), -1)
            top_p, top_i = torch.topk(probs, min(k + 1, e), dim=-1)
            gap = (top_p[:, k - 1] - top_p[:, k] if k < e
                   else torch.full_like(top_p[:, 0], float("inf")))
            self.calls[self.side].append(
                (top_i[:, :k].sort(-1).values.cpu(), gap.cpu(), x.shape[0]))
            return self._orig(params, cfg, x, **kw)
        moe.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        moe.moe_apply = self._orig

    def flips(self):
        """Since the last call: (batch row, CPU-side top-k gap) of each
        token-layer whose expert set differs between the sides."""
        card, cpu = self.calls["card"], self.calls["cpu"]
        if len(card) != len(cpu):
            raise AssertionError("the sides ran different MoE layers")
        out = []
        for (ci, _, b), (pi, gap, _) in zip(card, cpu):
            self.token_layers += len(gap)
            self.min_gap = min(self.min_gap, gap.min().item())
            for tok in (ci != pi).any(-1).nonzero()[:, 0].tolist():
                out.append((tok // (len(gap) // b), gap[tok].item()))
        for calls in self.calls.values():
            calls.clear()
        return out


def phase_parity(arch: str, prompt_lens) -> None:
    """fp32 logits on the card (kernels) vs the CPU (plain versions):
    prefill of two prompts at batch 1, their caches copied into a batch of
    two slots, then three per-slot decode steps, as the batcher runs them.
    Both sides are fed the CPU side's greedy tokens, and without MoE layers
    the card's greedy tokens must equal them. An arch with a frontend
    (internvl2-1b) prefills its ``frontend_tokens`` embeddings of
    ``frontend_dim``, drawn from a seeded generator, before each prompt.
    With MoE layers, a sequence whose routing differs between the sides in
    any layer is left out of the logit comparison from then on
    (``RouterLog``)."""
    cfg = get_config(arch).replace(dtype="float32",
                                   num_layers=PARITY_LAYERS)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in prompt_lens]
    ft = cfg.frontend_tokens
    # (b, frontend_tokens, frontend_dim), as the JAX launcher's specs lay
    # the patch embeddings out; one row a prompt.
    frontend = torch.randn((len(prompts), ft, cfg.frontend_dim or
                            cfg.d_model), generator=torch.Generator()
                           .manual_seed(2)) if ft else None
    max_len = max(128, ft + max(prompt_lens) + 8)
    engines, caches = {}, {}
    for side, dev in PARITY_SIDES.items():
        engines[side] = ServingEngine(cfg, ServeConfig(max_seq_len=max_len),
                                      device=dev)
        engines[side].load(tree_map(lambda t, d=dev: t.to(d), params))
        caches[side] = lm.init_caches(cfg, len(prompts), max_len,
                                      torch.device(dev))
    errs, nxt, flips, flipped = [], [], [], set()
    greedy = {side: [] for side in PARITY_SIDES}

    def agreeing(step_flips, rows):
        flips.extend(step_flips)
        flipped.update(rows[r] for r, _ in step_flips)
        return [r for r in range(len(rows)) if rows[r] not in flipped]

    ops.reset_launches()
    with RouterLog() as log:
        for slot, p in enumerate(prompts):
            lg = {}
            for side, eng in engines.items():
                log.side = side
                batch = {"tokens": torch.as_tensor(p[None],
                                                   device=eng.device)}
                if frontend is not None:
                    batch["vision_embeds"] = frontend[slot:slot + 1].to(
                        eng.device)
                lg[side], c1 = eng.prefill_fn(eng.params, batch)
                for big, small in zip(caches[side], c1):
                    for name, leaf in big.items():
                        leaf[slot].copy_(small[name][0])
            errs.append(_logit_err(lg, agreeing(log.flips(), [slot])))
            for side in PARITY_SIDES:
                greedy[side].append([int(torch.argmax(lg[side][0]))])
            nxt.append(greedy["cpu"][-1][0])
        pos = np.array([ft + len(p) for p in prompts])
        for _ in range(3):
            lg = {}
            for side, eng in engines.items():
                log.side = side
                lg[side], _ = eng.decode_fn(
                    eng.params,
                    torch.as_tensor(nxt, device=eng.device)[:, None],
                    caches[side], torch.as_tensor(pos, dtype=torch.int32,
                                                  device=eng.device))
            errs.append(_logit_err(lg, agreeing(log.flips(),
                                                list(range(len(prompts))))))
            for side in PARITY_SIDES:
                greedy[side].append(torch.argmax(lg[side], dim=-1).tolist())
            nxt = greedy["cpu"][-1]
            pos = pos + 1
    launches = ops.launch_counts()
    _check_path_launches(arch, launches)
    tokens_equal = greedy["card"] == greedy["cpu"]
    line = {"phase": "parity", "arch": arch, "dtype": "float32",
            "layers": PARITY_LAYERS, "prompt_lens": list(prompt_lens),
            "frontend_tokens": ft, "decode_steps": 3,
            "tolerance": PARITY_TOL, "max_abs_err_per_step": errs,
            "greedy_tokens_equal": tokens_equal,
            "greedy_tokens_cpu": greedy["cpu"], "kernel_launches": launches}
    if cfg.moe is not None:
        line["routing"] = {
            "token_layers": log.token_layers, "flips": len(flips),
            "flip_topk_gaps": [g for _, g in flips],
            "min_topk_gap": log.min_gap, "flip_gap_limit": FLIP_GAP,
            "sequences_left_out": sorted(flipped),
            "held": ("every row" if not flipped else
                     "rows of sequences whose routing agreed in every "
                     "layer; a null step held none")}
    emit(line)
    if cfg.moe is None and not tokens_equal:
        raise AssertionError(f"{arch}: greedy tokens differ card vs CPU: "
                             f"{greedy['card']} != {greedy['cpu']}")
    bad = [g for _, g in flips if g > FLIP_GAP]
    if bad:
        raise AssertionError(f"{arch}: routing differs card vs CPU at top-k "
                             f"gaps {bad} > {FLIP_GAP}")


def _logit_err(lg, rows=None):
    """Max abs error of the card's logits against the CPU's over ``rows``
    (all by default); raises past PARITY_TOL. None if no row is held."""
    gpu, cpu = lg["card"].float().cpu(), lg["cpu"].float()
    if gpu.shape != cpu.shape or not torch.isfinite(gpu).all():
        raise AssertionError("card logits not finite or misshapen")
    if rows is not None:
        if not rows:
            return None
        gpu, cpu = gpu[rows], cpu[rows]
    err = (gpu - cpu).abs()
    if bool((err > PARITY_TOL + PARITY_TOL * cpu.abs()).any()):
        raise AssertionError(f"card and CPU logits differ: max abs err "
                             f"{err.max().item()} (tol {PARITY_TOL})")
    return err.max().item()


def _check_train_launches(launches: dict, steps: int) -> dict:
    """Launches a step of the training path, each exactly as counted in
    TRAIN_LAUNCHES; no other kernel launched."""
    per_step = {k: n / steps for k, n in launches.items()}
    want = {k: TRAIN_LAUNCHES.get(k, 0) for k in launches}
    if per_step != want:
        raise AssertionError(f"train launches a step {per_step} != {want}")
    return per_step


def _train_run(trainer, loader, steps, **kw):
    hist = trainer.run(loader, steps=steps, log_every=10 ** 9, **kw)
    if not all(np.isfinite(hist["loss"])):
        raise AssertionError(f"non-finite training loss: {hist['loss']}")
    return hist


def _profile_train_step(trainer, params, opt_state, batch) -> dict:
    """Where a training step's time goes: one step timed on the host clock
    (ending in a synchronize), then one under torch.profiler for the
    kernels' device time and the device's idle share; then the AdamW
    update alone (the step's last part) under the profiler, on gradients
    of 1e-3, so its share of the step is measured, not inferred."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = trainer._place(batch)

    def step():
        nonlocal params, opt_state
        params, opt_state, m = trainer.step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        return m

    t0 = time.perf_counter()
    step()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = _device_busy_us(kern) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    flash_bwd_ms = sum(v for k, v in by_name.items()
                       if "flash_bwd" in k) / 1e3

    grads = [torch.full_like(p, 1e-3) for p in tree_leaves(params)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as uprof:
        t0 = time.perf_counter()
        adamw_update(grads, opt_state, params, trainer.tcfg)
        torch.cuda.synchronize()
        update_ms = (time.perf_counter() - t0) * 1e3
    ukern = [e for e in uprof.events() if e.device_type == DeviceType.CUDA]
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / traced_ms,
            "kernels_per_step": len(kern),
            "top_device_ms": [[k[:60], v / 1e3] for k, v in top],
            "flash_bwd_device_ms": flash_bwd_ms,
            "adamw_update": {"traced_wall_ms": update_ms,
                             "device_busy_ms": _device_busy_us(ukern) / 1e3,
                             "kernels": len(ukern)}}


def phase_train(smi: str) -> dict:
    """internlm2-1.8b at full width through the port's Trainer: 8 steps
    with fp32 moments (launches checked), the same 8 resumed from a
    checkpoint at step 4 (losses bit for bit), then 3 with int8 moments.
    Returns the 8-step run's launches."""
    import shutil
    cfg = get_config(ARCH)
    loader = lambda: PrefetchingLoader(data_config(cfg, TRAIN_SEQ,
                                                   TRAIN_BATCH))
    tcfg = train_config(cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    trainer = Trainer(cfg, tcfg)
    full = _train_run(trainer, loader(), TRAIN_STEPS)
    launches = ops.launch_counts()
    per_step = _check_train_launches(launches, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    prof = _profile_train_step(trainer, full.pop("params"),
                               full.pop("opt_state"),
                               loader().get(TRAIN_STEPS))
    del trainer
    torch.cuda.empty_cache()

    # Save at step 4, restore into a fresh Trainer, continue to step 8.
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    t_save = time.monotonic()
    first = _train_run(Trainer(cfg, tcfg, ckpt_dir=TRAIN_CKPT_DIR,
                               ckpt_every=TRAIN_SAVE_AT), loader(),
                       TRAIN_SAVE_AT)
    del first["params"], first["opt_state"]
    save_s = time.monotonic() - t_save - sum(first["step_time_s"])
    torch.cuda.empty_cache()
    if ckpt.latest_step(TRAIN_CKPT_DIR) != TRAIN_SAVE_AT:
        raise AssertionError("no checkpoint at the save step")
    t_res = time.monotonic()
    resumed = _train_run(Trainer(cfg, tcfg, ckpt_dir=TRAIN_CKPT_DIR,
                                 ckpt_every=10 ** 9), loader(), TRAIN_STEPS)
    restore_s = time.monotonic() - t_res - sum(resumed["step_time_s"])
    del resumed["params"], resumed["opt_state"]
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    if resumed["step"] != list(range(TRAIN_SAVE_AT, TRAIN_STEPS)) or \
            first["loss"] + resumed["loss"] != full["loss"]:
        raise AssertionError(f"resume is not bitwise: {first['loss']} + "
                             f"{resumed['loss']} != {full['loss']}")

    int8 = _train_run(Trainer(cfg, train_config(
        cfg, TRAIN_INT8_STEPS, opt_state_dtype="int8")), loader(),
        TRAIN_INT8_STEPS)
    del int8["params"], int8["opt_state"]
    torch.cuda.empty_cache()
    emit({"phase": "train", "arch": ARCH, "dtype": cfg.dtype,
          "params": cfg.num_params, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
          "train_config": {k: getattr(tcfg, k) for k in (
              "remat", "opt_state_dtype", "microbatches", "learning_rate",
              "warmup_steps", "total_steps", "loss_chunk")},
          "fp32_moments": {"loss": full["loss"],
                           "grad_norm": full["grad_norm"],
                           "step_ms": [1e3 * t for t in full["step_time_s"]]},
          "resume": {"saved_at": TRAIN_SAVE_AT, "bitwise": True,
                     "losses_after": resumed["loss"],
                     "save_s": save_s, "restore_s": restore_s},
          "int8_moments": {"loss": int8["loss"],
                           "grad_norm": int8["grad_norm"],
                           "step_ms": [1e3 * t for t in int8["step_time_s"]]},
          "max_memory_allocated": peak, "profile": prof,
          "kernel_launches": launches, "launches_per_step": per_step,
          "nvidia_smi": smi})
    return launches


def phase_train_parity() -> None:
    """One loss and its gradient, fp32 internlm2-1.8b at full width with
    PARITY_LAYERS layers, full remat: on the card (kernels and their
    backward kernels) against the CPU (plain versions)."""
    cfg = get_config(ARCH).replace(dtype="float32", num_layers=PARITY_LAYERS)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    batch = _gen_batch(data_config(cfg, TRAIN_PARITY_SEQ,
                                   TRAIN_PARITY_BATCH), 0)
    out = {}
    for side, dev in PARITY_SIDES.items():
        p = tree_map(lambda t, d=dev: t.to(d, copy=True).requires_grad_(True),
                     params)
        leaves = tree_leaves(p)
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        ops.reset_launches()
        loss, metrics = lm.loss_fn(p, cfg, b, remat="full")
        grads = torch.autograd.grad(loss, leaves)
        out[side] = (loss.item(), [g.cpu() for g in grads],
                     ops.launch_counts())
    (l_card, g_card, launches), (l_cpu, g_cpu, _) = out["card"], out["cpu"]
    n = PARITY_LAYERS
    want = {"rmsnorm": 4 * n + 1, "rmsnorm_bwd": 2 * n + 1,
            "flash_attention": 2 * n, "flash_attention_bwd": n}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"train parity launches {launches} != {want}")
    rel = [((a - c).abs().max() / c.abs().max().clamp_min(1e-30)).item()
           for a, c in zip(g_card, g_cpu)]
    finite = all(torch.isfinite(g).all() for g in g_card)
    emit({"phase": "train_parity", "arch": ARCH, "dtype": "float32",
          "layers": n, "batch": TRAIN_PARITY_BATCH, "seq": TRAIN_PARITY_SEQ,
          "remat": "full", "tolerance": PARITY_TOL, "loss_card": l_card,
          "loss_cpu": l_cpu, "loss_abs_err": abs(l_card - l_cpu),
          "grad_leaves": len(rel), "max_grad_err_over_maxabs": max(rel),
          "kernel_launches": launches})
    if not finite or abs(l_card - l_cpu) > PARITY_TOL * max(1, abs(l_cpu)) \
            or max(rel) > PARITY_TOL:
        raise AssertionError(f"train parity: loss {l_card} vs {l_cpu}, "
                             f"grad err {max(rel)} (tol {PARITY_TOL})")


# ---------------------------------------------------------------------------
# The fleet engine: Fleet(backend="torch") and sweep(), which run no
# kernel of their own (their path launches none of the counted wrappers).
# ---------------------------------------------------------------------------
# fig16's fleet constants (benchmarks/fig16_fleet.py:87-90)
SOC_UNIT_RATE, CPU_UNIT_RATE, FLEET_DT_S, RPS_PER_USER = 30.0, 9.0, 60.0, 0.02
# the JAX engine's tolerance contract, tests/test_jax_parity.py:42-51
FLEET_RTOL = {"served": 1e-12, "energy_j": 1e-12, "power_w": 1e-9,
              "queued": 1e-9, "p50_latency_s": 1e-9, "p95_latency_s": 1e-9,
              "p99_latency_s": 1e-9, "max_temp_c": 1e-9,
              "fan_power_w": 1e-9}
FLEET_ATOL = 1e-9
FLEET_EXACT = ("ticks", "drained", "active_units", "queued", "hedged",
               "scale_events", "throttled_units")
# fig16's batched sweep (benchmarks/fig16_fleet.py:96-97, :211-259): 64
# configs x 100 racks x 24 h at 300 s ticks, rows held to dedicated
# vector runs at its JAX_RTOL; 8 of them, every 9th, so all three routers
SWEEP_CONFIGS, SWEEP_RACKS, SWEEP_DT_S, SWEEP_RTOL = 64, 100, 300.0, 1e-9
SWEEP_CHECKED = tuple(range(0, SWEEP_CONFIGS, 9))


def _fleet_policy(**kw):
    return ScalePolicy(cooldown_s=300.0, min_units=1, **kw)


def _mixed_racks(n_soc: int, n_cpu: int, policy=None):
    """fig16's mixed fleet: SD865 SoC racks and Xeon racks."""
    policy = policy or _fleet_policy()
    return (homogeneous_fleet(soc_cluster(), n_soc, SOC_UNIT_RATE,
                              policy=policy)
            + homogeneous_fleet(edge_server_cpu(), n_cpu, CPU_UNIT_RATE,
                                policy=_fleet_policy()))


def _dvfs_racks(n: int, dvfs: bool = True):
    """fig16's SoC fleet, with schedutil over the SD865 table and the RC
    thermal network on every rack (``dvfs``), or binary gating alone."""
    policy = _fleet_policy(freq_governor=SchedutilGovernor() if dvfs
                           else None)
    return homogeneous_fleet(
        soc_cluster(), n, SOC_UNIT_RATE, policy=policy,
        opp_table=sd865_opp_table() if dvfs else None,
        thermal=ThermalParams() if dvfs else None)


def _capacity(racks) -> float:
    return float(sum(rc.spec.n_units * rc.unit_rate for rc in racks))


def _fleet_scenarios():
    """fig16's parity set (benchmarks/fig16_fleet.py:180-193, traces as
    its run() builds them): the mixed 8 + 2 fleet under each router on
    the short diurnal trace and under round-robin on the flash crowd,
    the 6-rack schedutil + thermal fleet, and an under-provisioned
    hedging fleet at 95 % of capacity."""
    users = 0.5 * _capacity(_mixed_racks(100, 20)) / RPS_PER_USER
    short = scale_to_users(
        diurnal_trace(peak_rps=1.0, hours=2, dt_s=FLEET_DT_S, seed=7),
        users=users / 10, rps_per_user=RPS_PER_USER)
    crowd = flash_crowd_trace(
        base_rps=0.08 * _capacity(_mixed_racks(10, 10)), spike_mult=8.0,
        hours=2.0, dt_s=FLEET_DT_S, seed=16)
    dvfs_short = 0.5 * _capacity(_dvfs_racks(100, dvfs=False)) \
        * diurnal_trace(peak_rps=1.0, hours=24, dt_s=FLEET_DT_S,
                        seed=16)[:120] / 10.0
    hedge = _fleet_policy(headroom=0.8, hedge_after_s=120.0)
    hedge_racks = lambda: homogeneous_fleet(  # noqa: E731
        soc_cluster(), 8, SOC_UNIT_RATE, policy=hedge)
    hedge_trace = 0.95 * _capacity(hedge_racks()) * diurnal_trace(
        peak_rps=1.0, hours=2, dt_s=FLEET_DT_S, seed=3)
    out = [(f"mixed_{name}", lambda: _mixed_racks(8, 2), cls, short)
           for name, cls in ROUTERS.items()]
    out.append(("flash_round-robin", lambda: _mixed_racks(8, 2),
                RoundRobinRouter, crowd))
    out.append(("dvfs_join-shortest-queue", lambda: _dvfs_racks(6),
                JoinShortestQueueRouter, dvfs_short))
    out.append(("hedging_power-aware", hedge_racks, PowerAwareRouter,
                hedge_trace))
    return out


def _fleet_series(tel) -> dict:
    out = {k: np.asarray(getattr(tel, k), float) for k in (
        "ticks", "drained", "active_units", "queued", "power_w", "served",
        "energy_j", "p50_latency_s", "p95_latency_s", "p99_latency_s")}
    out["hedged"] = np.array([r.hedged for r in tel.per_rack], float)
    out["scale_events"] = np.array([r.scale_events for r in tel.per_rack],
                                   float)
    for k in ("max_temp_c", "throttled_units", "fan_power_w"):
        out[k] = np.concatenate([np.asarray(getattr(r, k), float)
                                 for r in tel.per_rack])
    return out


def _maxrel(a, b) -> float:
    """fig16's relative error: max |a - b| / max(|a|, 1e-9)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-9)))


def _no_launches(what: str) -> dict:
    launches = ops.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"{what} launched hand-written kernels: "
                             f"{launches}")
    return launches


def phase_fleet_parity(smi: str) -> None:
    """Each fig16 scenario through ``Fleet(backend="torch")`` on the card
    and ``Fleet(backend="vector")`` on the host, series by series: integer
    series equal, the rest within the JAX engine's RTOL/ATOL."""
    t_phase = time.monotonic()
    ops.reset_launches()
    worst = {k: 0.0 for k in FLEET_RTOL}
    rows, bad = [], []
    for label, make, router, trace in _fleet_scenarios():
        tv = Fleet(make(), router=router(), dt_s=FLEET_DT_S,
                   backend="vector").play_trace(trace)
        tt = Fleet(make(), router=router(), dt_s=FLEET_DT_S,
                   backend="torch").play_trace(trace)
        sv, st = _fleet_series(tv), _fleet_series(tt)
        errs = {}
        for k in FLEET_EXACT:
            if not np.array_equal(sv[k], st[k]):
                bad.append(f"{label}/{k} differs")
        for k, rtol in FLEET_RTOL.items():
            if k in FLEET_EXACT:
                continue
            errs[k] = _maxrel(sv[k], st[k])
            worst[k] = max(worst[k], errs[k])
            if not (sv[k].shape == st[k].shape and np.allclose(
                    st[k], sv[k], rtol=rtol, atol=FLEET_ATOL)):
                bad.append(f"{label}/{k} max rel err {errs[k]:.3e}")
        rows.append({"scenario": label, "racks": len(tt.rack_names),
                     "ticks": tt.ticks, "drained": tt.drained,
                     "hedged": int(sv["hedged"].sum()),
                     "throttled_unit_ticks": int(
                         sv["throttled_units"].sum()),
                     "torch_wall_s": tt.wall_s, "vector_wall_s": tv.wall_s,
                     "max_rel_err": errs})
    launches = _no_launches("fleet_parity")
    emit({"phase": "fleet_parity", "backend": "torch", "device": "cuda",
          "oracle": "Fleet(backend='vector') on the host",
          "rtol": FLEET_RTOL, "atol": FLEET_ATOL,
          "exact": list(FLEET_EXACT), "max_rel_err": worst,
          "scenarios": rows, "kernel_launches": launches,
          "seconds": time.monotonic() - t_phase, "nvidia_smi": smi})
    if bad:
        raise AssertionError(f"fleet parity: {bad}")


def _sweep_inputs():
    racks = homogeneous_fleet(soc_cluster(), SWEEP_RACKS, SOC_UNIT_RATE,
                              policy=_fleet_policy())
    trace = 0.5 * _capacity(racks) * diurnal_trace(
        peak_rps=1.0, hours=24, dt_s=SWEEP_DT_S, seed=16)
    grid = itertools.product(tuple(ROUTERS), (0.85, 1.0, 1.15, 1.3),
                             (0.7, 0.85, 1.0, 1.15, 1.3, 1.45))
    cfgs = [SweepConfig(router=rt, headroom_scale=hr, trace_scale=ts,
                        name=f"c{i}")
            for i, (rt, hr, ts) in enumerate(
                itertools.islice(grid, SWEEP_CONFIGS))]
    return racks, trace, cfgs


def _traced(fn) -> dict:
    """Host wall and device busy (union of CUDA kernel intervals) of one
    call under torch.profiler, tracing the device alone (a sweep runs
    some 200k kernels; host op events would cost more to collect than
    the sweep)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _device_busy_us(kern) / 1e6 if kern else None
    return {"traced_wall_s": wall, "kernels": len(kern),
            "device_busy_s": busy,
            "device_busy_share": busy / wall if kern else None}


def phase_fleet_sweep(smi: str) -> None:
    """fig16's batched sweep on the card: 64 configs x 100 racks x 24 h
    as one batched step, replayed as a CUDA graph and run eagerly; 8 rows
    held to dedicated vector runs, a repeat held bit for bit, the times
    of both beside the vector loop's (measured over those 8 configs and
    extrapolated to 64, as fig16 does), peak memory, and a traced sweep's
    device-busy share."""
    t_phase = time.monotonic()
    racks, trace, cfgs = _sweep_inputs()
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run(graph=True):
        return sweep(racks, cfgs, trace, dt_s=SWEEP_DT_S, graph=graph)

    def timed(graph=True):
        t0 = time.perf_counter()
        rows = run(graph)
        return rows, time.perf_counter() - t0

    _, first_s = timed()                       # first run (cold)
    rows, graph_s = timed()
    again, _ = timed()
    mem = torch.cuda.max_memory_allocated()
    run(graph=False)                           # eager warm-up
    eager_rows, eager_s = timed(graph=False)
    launches = _no_launches("fleet_sweep")
    if rows != again or eager_rows != rows:
        raise AssertionError("a repeated sweep, or the eager one, differs "
                             "from the first graph-replayed sweep")
    t0 = time.perf_counter()
    traced = _traced(run)
    trace_s = time.perf_counter() - t0
    ticks_run = -(-(2 * len(trace) + 100) // tte._BLOCK) * tte._BLOCK
    t0 = time.perf_counter()
    checked, worst = [], 0.0
    for ci in SWEEP_CHECKED:
        cfg, row = cfgs[ci], rows[ci]
        fleet = Fleet(
            homogeneous_fleet(soc_cluster(), SWEEP_RACKS, SOC_UNIT_RATE,
                              policy=_fleet_policy(
                                  headroom=ScalePolicy().headroom
                                  * cfg.headroom_scale)),
            router=ROUTERS[cfg.router](), dt_s=SWEEP_DT_S, backend="vector")
        summ = fleet.play_trace(cfg.trace_scale * trace).summary()
        errs = {k: _maxrel(summ[k], row[k])
                for k in ("served", "energy_kwh", "p95_latency_s")}
        worst = max(worst, *errs.values())
        checked.append({"config": cfg.name, "router": cfg.router,
                        "drained": bool(summ["drained"]) and row["drained"],
                        "max_rel_err": errs})
    t_vec = (time.perf_counter() - t0) / len(SWEEP_CHECKED) * SWEEP_CONFIGS
    emit({"phase": "fleet_sweep", "configs": SWEEP_CONFIGS,
          "racks": SWEEP_RACKS, "socs": SWEEP_RACKS * soc_cluster().n_units,
          "trace_ticks": len(trace), "dt_s": SWEEP_DT_S,
          "ticks_stepped": ticks_run,
          "first_sweep_s": first_s, "graph_sweep_s": graph_s,
          "eager_sweep_s": eager_s,
          "graph_scenarios_per_s": SWEEP_CONFIGS / graph_s,
          "eager_scenarios_per_s": SWEEP_CONFIGS / eager_s,
          "vector_loop_scenarios_per_s": SWEEP_CONFIGS / t_vec,
          "vector_loop_est_s": t_vec,
          "speedup_graph_over_vector_loop": t_vec / graph_s,
          "repeat_bitwise_equal": True,
          "eager_bitwise_equal_graph": True,
          "max_memory_allocated": mem,
          "kernels_per_tick": traced["kernels"] / ticks_run,
          "traced_graph_sweep": traced, "trace_collect_s": trace_s,
          "checked_against_vector": checked, "rtol": SWEEP_RTOL,
          "max_rel_err": worst, "kernel_launches": launches,
          "seconds": time.monotonic() - t_phase, "nvidia_smi": smi})
    if worst > SWEEP_RTOL or not all(c["drained"] for c in checked):
        raise AssertionError(f"fleet sweep rows off the vector runs: "
                             f"{checked}")


def main() -> None:
    t0 = time.monotonic()
    dev = phase_device()
    phase_build()
    head = phase_kernels()
    served = {arch: phase_serve(dev["nvidia_smi"], arch, lens)
              for arch, lens in ((ARCH, PROMPT_LENS),
                                 (MAMBA_ARCH, MAMBA_PROMPT_LENS),
                                 (MOE_ARCH, PROMPT_LENS),
                                 *((a, PROMPT_LENS) for a in NEW_ARCHS))}
    _free_card()
    phase_profile(ARCH, PROMPT_LENS, PROMPT_LENS[SLOTS])
    phase_profile(MAMBA_ARCH, MAMBA_PROMPT_LENS, 512)
    phase_profile(MOE_ARCH, PROMPT_LENS, PROMPT_LENS[SLOTS])
    phase_parity(ARCH, (77, 45))
    phase_parity(MAMBA_ARCH, MAMBA_PARITY_PROMPTS)
    phase_parity(MOE_ARCH, (77, 45))
    for arch in NEW_PARITY_ARCHS:
        phase_parity(arch, (77, 45))
        _free_card()
    served[TRAIN_PATH] = phase_train(dev["nvidia_smi"])
    phase_train_parity()
    _free_card()
    phase_fleet_parity(dev["nvidia_smi"])
    phase_fleet_sweep(dev["nvidia_smi"])
    # One row per kernel and path: its launches from that path's own serve
    # run (reset to 0 just before it), next to its case at that path's shape.
    kernels = []
    for (name, path), c in head.items():
        source, replaces = SOURCES[name]
        if path == KERNELS_PHASE:
            launches = c["launches"]
            origin = "kernels phase (no model path)"
        else:
            launches, origin = served[path][name], f"serve {path}"
        per_step = {}
        if path == TRAIN_PATH:
            origin = f"train {ARCH}, {TRAIN_STEPS} steps"
            per_step = {"launches_per_step": launches / TRAIN_STEPS}
        kernels.append({
            "name": name, "path": path, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_from": origin, **per_step,
            **({"heads_of": c["heads_of"]} if "heads_of" in c else {}),
            "shape": c["shape"],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            **({"library_note": c["library_note"]}
               if "library_note" in c else {})})
    emit({"kernels": kernels, "seconds": time.monotonic() - t0})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})


if __name__ == "__main__":
    main()
