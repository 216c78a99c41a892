#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. ``device``   card name and power limit (nvidia-smi), torch and CUDA
                versions. No card: exit non-zero before any result.
2. ``build``    nvcc builds ``src/repro_torch/csrc/*.cu`` for sm_90a; build
                time and each kernel's registers/spills from ``-Xptxas -v``.
3. ``kernels``  each hand-written kernel against its plain PyTorch version
                on the card, at the serving path's full-width shapes, in
                bf16 and fp32: max error, kernel time, plain-version time,
                the time of the nearest PyTorch library call, and the bound
                (the least time the card could take for the same work).
4. ``serve``    full-width internlm2-1.8b in bf16 with random weights,
                8 requests through ``repro_torch.launch.serve.serve``; every
                kernel's launch count is reset just before and read just
                after, and must be above 0.
5. ``profile``  one prefill and a few decode ticks of the same model:
                host time per step, then under torch.profiler the kernels'
                device time per step and the device's idle share.
6. ``parity``   the same model in fp32 at cut depth, on the card (kernels)
                and on the CPU (plain versions): prefill and per-slot decode
                logits must agree.

Then the summary line of kernels, the nvidia-smi line, and the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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

from repro_torch.config import ServeConfig, get_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import rmsnorm as krms  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.serving.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ARCH = "internlm2-1.8b"
# Prompt lengths of the serve phase: 100..700 tokens, none a multiple of 64
# (the flash kernel's tile), so every prefill has a ragged edge.
PROMPT_LENS = [333, 129, 700, 517, 258, 450, 101, 611]
NEW_TOKENS = 32
SLOTS = 4
MAX_LEN = max(PROMPT_LENS) + NEW_TOKENS + 8
PARITY_LAYERS = 2
PARITY_SIDES = {"card": "cuda", "cpu": "cpu"}   # side -> device

# H100 SXM data sheet (dense): HBM rate and peak arithmetic rates by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12,   # tensor cores
            torch.float32: 67e12}     # fp32 outside the tensor cores

# Kernel vs plain version on the card. bf16: both compute in fp32 and round
# the output once, so they differ by about one bf16 ulp (2^-8 relative).
# fp32: the kernel sums in another order than the plain version's einsum
# (and on the CPU the tests hold the plain version to 2e-6).
KERNEL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Logits of the fp32 model, card (kernels, cuBLAS) vs CPU (plain versions):
# 2048- and 8192-long fp32 sums in other orders, through two layers.
PARITY_TOL = 1e-3

SOURCES = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:22"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:69"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
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


def max_err(out: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """Max abs error; raises past atol = rtol = KERNEL_TOL[dtype]."""
    out, want = out.float(), want.float()
    err = (out - want).abs()
    tol = KERNEL_TOL[dtype]
    if not torch.isfinite(out).all() or bool((err > tol + tol * want.abs())
                                             .any()):
        raise AssertionError(f"kernel disagrees with plain version: max abs "
                             f"err {err.max().item()} (tol {tol})")
    return err.max().item()


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
    info = {"phase": "device", "nvidia_smi": nvidia_smi(),
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
            kern = re.search(r"(rmsnorm_kernel|flash_fwd_kernel|"
                             r"decode_kernel)", name)
            dt = "bf16" if "bfloat16" in name else "f32"
            args = ",".join([dt, *re.findall(r"Li(\d+)E", name)])
            out.append(f"{kern.group(1) if kern else name}<{args}>: "
                       f"{used.group(1)} regs, {spill or '?'} B spill")
            name = None
    return out


def phase_build() -> None:
    info = _build.build()
    ptxas = _ptxas_summary(info.ptxas)
    spills = [p for p in ptxas if not p.endswith(", 0 B spill")]
    emit({"phase": "build", "seconds": info.seconds, "cached": info.cached,
          "library": os.path.relpath(info.path), "entries": len(ptxas),
          "spills": spills,
          "main_path": [p for p in ptxas if "bf16,128" in p
                        or ("rmsnorm" in p and "bf16" in p)]})


def _rmsnorm_case(rows, dtype, lowp, seed=0):
    d = 2048
    x, w = randn((rows, d), dtype, seed), randn((d,), torch.float32, seed + 1)
    out = krms.rmsnorm(x, w, 1e-5, lowp=lowp)
    torch.cuda.synchronize()
    err = max_err(out, krms.plain(x, w, 1e-5, lowp), dtype)
    wl = w.to(dtype)
    e = x.element_size()
    b_ms, by = bound(2 * rows * d * e + 4 * d, 4 * rows * d, torch.float32)
    return {"kernel": "rmsnorm", "shape": [rows, d], "dtype": str(dtype),
            "lowp": lowp, "max_abs_err": err,
            "ms": time_ms(lambda: krms.rmsnorm(x, w, 1e-5, lowp=lowp)),
            "eager_ms": eager_ms(lambda: krms.rmsnorm(x, w, 1e-5, lowp=lowp)),
            "plain_ms": time_ms(lambda: krms.plain(x, w, 1e-5, lowp)),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), wl, 1e-5)),
            "bound_ms": b_ms, "bound_by": by}


def _flash_case(sq, dtype, seed=0):
    b, hq, hkv, d = 1, 16, 8, 128
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
    return {"kernel": "flash_attention", "shape": [b, sq, hq, hkv, d],
            "dtype": str(dtype), "max_abs_err": err,
            "ms": time_ms(lambda: kflash.flash_attention(q, k, v)),
            "eager_ms": eager_ms(lambda: kflash.flash_attention(q, k, v)),
            "plain_ms": time_ms(lambda: kflash.plain(q, k, v), 5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": by}


def _decode_case(dtype, seed=0):
    b, hq, hkv, d, skv = SLOTS, 16, 8, 128, MAX_LEN
    q = randn((b, hq, d), dtype, seed)
    k = randn((b, skv, hkv, d), dtype, seed + 1)
    v = randn((b, skv, hkv, d), dtype, seed + 2)
    lengths = [129, 334, 517, 731]
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = kdec.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    err = max_err(out, kdec.plain(q, k, v, length), dtype)
    mask = (torch.arange(skv, device="cuda")[None, :] < length[:, None])
    mask = mask[:, None, None, :]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    e = q.element_size()
    b_ms, by = bound(e * (2 * b * hq * d + 2 * sum(lengths) * hkv * d)
                     + 4 * b, 4 * sum(lengths) * hq * d, dtype)
    return {"kernel": "decode_attention", "shape": [b, skv, hq, hkv, d],
            "lengths": lengths, "dtype": str(dtype), "max_abs_err": err,
            "ms": time_ms(lambda: kdec.decode_attention(q, k, v, length)),
            "eager_ms": eager_ms(
                lambda: kdec.decode_attention(q, k, v, length)),
            "plain_ms": time_ms(lambda: kdec.plain(q, k, v, length), 10),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": by}


def phase_kernels() -> dict:
    """Returns the bf16 case at the main path's shape for each kernel."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for lowp in (False, True):
            cases.append(_rmsnorm_case(PROMPT_LENS[0], dtype, lowp))
        cases.append(_rmsnorm_case(SLOTS, dtype, False))
        for sq in (PROMPT_LENS[0], 512):
            cases.append(_flash_case(sq, dtype))
        cases.append(_decode_case(dtype))
    emit({"phase": "kernels", "tolerance": {"bfloat16": KERNEL_TOL[
        torch.bfloat16], "float32": KERNEL_TOL[torch.float32]},
        "cases": cases})
    # bf16 is the serving dtype; the first case of each kernel in bf16 is
    # the shape the main path gives it (one prompt of PROMPT_LENS[0] tokens,
    # lowp off as in the config; decode at SLOTS slots and MAX_LEN).
    head = {}
    for c in cases:
        head.setdefault(c["kernel"], c)
    return head


def phase_serve(smi: str) -> dict:
    cfg = get_config(ARCH)
    # Warm-up (cuBLAS handles, allocator), then the measured run.
    serve(cfg, [PROMPT_LENS[0]], max_new_tokens=2, slots=SLOTS, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rep = serve(cfg, PROMPT_LENS, max_new_tokens=NEW_TOKENS, slots=SLOTS,
                seed=0)
    launches = ops.launch_counts()
    if rep["served"] != len(PROMPT_LENS):
        raise AssertionError(f"served {rep['served']} of {len(PROMPT_LENS)}")
    if rep["tokens_generated"] != len(PROMPT_LENS) * NEW_TOKENS:
        raise AssertionError(f"generated {rep['tokens_generated']} tokens")
    if not all(0 <= t < cfg.vocab_size for t in rep["sample_output"]):
        raise AssertionError(f"token ids out of range: {rep['sample_output']}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    emit({"phase": "serve", "arch": ARCH, "dtype": cfg.dtype,
          "prompt_lens": PROMPT_LENS, "new_tokens": NEW_TOKENS,
          "slots": SLOTS, "served": rep["served"], "ticks": rep["ticks"],
          "tokens_generated": rep["tokens_generated"],
          "tokens_per_s": rep["tokens_per_s"], "wall_s": rep["wall_s"],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "kernel_launches": launches, "nvidia_smi": smi})
    return launches


def _device_busy_us(events):
    """Union of the CUDA kernel intervals of a profile, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def phase_profile(ticks: int = 8) -> None:
    """Where the time of the serving path goes: one prefill and ``ticks``
    decode ticks of a full batch, timed without the profiler (host clock
    around work that ends in a synchronize), then again under
    torch.profiler for the kernels' device time and the device's idle
    share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(ARCH)
    eng = ServingEngine(cfg, ServeConfig(max_seq_len=MAX_LEN))
    eng.init_random(0)
    bat = ContinuousBatcher(eng, slots=SLOTS)
    rng = np.random.default_rng(0)
    for n in PROMPT_LENS[:SLOTS + 1]:
        bat.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=4 * ticks)
    bat.step()                      # admits SLOTS requests, first decode
    for _ in range(2):
        bat.step()
    torch.cuda.synchronize()
    prompt = torch.as_tensor(bat.queue[0].prompt[None], dtype=torch.long,
                             device="cuda")

    def prefill():
        eng.prefill_fn(eng.params, {"tokens": prompt})

    def decode():
        for _ in range(ticks):
            bat.step()

    out = {"phase": "profile", "arch": ARCH, "dtype": cfg.dtype,
           "prefill_tokens": int(prompt.shape[1]), "slots": SLOTS,
           "ticks": ticks}
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


def phase_parity() -> None:
    """fp32 logits on the card (kernels) vs the CPU (plain versions):
    prefill of two prompts at batch 1, their caches copied into a batch of
    two slots, then three per-slot decode steps, as the batcher runs them.
    Both sides are fed the CPU side's greedy tokens."""
    cfg = get_config(ARCH).replace(dtype="float32",
                                   num_layers=PARITY_LAYERS)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (77, 45)]
    max_len = 128
    engines, caches = {}, {}
    for side, dev in PARITY_SIDES.items():
        engines[side] = ServingEngine(cfg, ServeConfig(max_seq_len=max_len),
                                      device=dev)
        engines[side].load(tree_map(lambda t, d=dev: t.to(d), params))
        caches[side] = lm.init_caches(cfg, len(prompts), max_len,
                                      torch.device(dev))
    errs, nxt = [], []
    ops.reset_launches()
    for slot, p in enumerate(prompts):
        lg = {}
        for side, eng in engines.items():
            toks = torch.as_tensor(p[None], device=eng.device)
            lg[side], c1 = eng.prefill_fn(eng.params, {"tokens": toks})
            for big, small in zip(caches[side], c1):
                big["k"][slot].copy_(small["k"][0])
                big["v"][slot].copy_(small["v"][0])
        errs.append(_logit_err(lg))
        nxt.append(int(torch.argmax(lg["cpu"][0])))
    pos = np.array([len(p) for p in prompts])
    for _ in range(3):
        lg = {}
        for side, eng in engines.items():
            lg[side], _ = eng.decode_fn(
                eng.params, torch.as_tensor(nxt, device=eng.device)[:, None],
                caches[side], torch.as_tensor(pos, dtype=torch.int32,
                                              device=eng.device))
        errs.append(_logit_err(lg))
        nxt = torch.argmax(lg["cpu"], dim=-1).tolist()
        pos = pos + 1
    launches = ops.launch_counts()
    if min(launches.values()) <= 0:
        raise AssertionError(f"parity run missed a kernel: {launches}")
    emit({"phase": "parity", "arch": ARCH, "dtype": "float32",
          "layers": PARITY_LAYERS, "prompt_lens": [len(p) for p in prompts],
          "decode_steps": 3, "tolerance": PARITY_TOL,
          "max_abs_err_per_step": errs, "kernel_launches": launches})


def _logit_err(lg) -> float:
    gpu, cpu = lg["card"].float().cpu(), lg["cpu"].float()
    if gpu.shape != cpu.shape or not torch.isfinite(gpu).all():
        raise AssertionError("card logits not finite or misshapen")
    err = (gpu - cpu).abs()
    if bool((err > PARITY_TOL + PARITY_TOL * cpu.abs()).any()):
        raise AssertionError(f"card and CPU logits differ: max abs err "
                             f"{err.max().item()} (tol {PARITY_TOL})")
    return err.max().item()


def main() -> None:
    t0 = time.monotonic()
    dev = phase_device()
    phase_build()
    head = phase_kernels()
    launches = phase_serve(dev["nvidia_smi"])
    phase_profile()
    phase_parity()
    kernels = []
    for name, c in head.items():
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    emit({"kernels": kernels, "seconds": time.monotonic() - t0})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})


if __name__ == "__main__":
    main()
