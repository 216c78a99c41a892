#!/usr/bin/env python3
"""Compare the training step of two checkouts of the port on one CUDA card.

    python3 tools/train_step_ab.py PARENT_DIR CHANGE_DIR

Runs a worker in each checkout in turns (parent, change, change, parent),
each a fresh process that imports that checkout's ``repro_torch`` and
``chip_smoke.py``: 3 steps of full-width internlm2-1.8b through its
``Trainer`` (``launch/train.py``'s config: bf16, remat "full", seq 256 x
batch 8), 3 more steps timed on the host clock, one step under
torch.profiler (device busy, the device time of the flash backward's
kernels, kernels a step), then ``chip_smoke._flash_bwd_case`` (the flash
backward at b 8, s 256, 16/8 heads, d 128, bf16, beside SDPA's backward).
Prints one JSON line a run and the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEQ, BATCH = 256, 8


def worker() -> None:
    sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.config import get_config
    from repro_torch.launch.train import data_config, train_config
    from repro_torch.training.data import PrefetchingLoader
    from repro_torch.training.train_loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(cs.ARCH)
    trainer = Trainer(cfg, train_config(cfg, 8))
    hist = trainer.run(PrefetchingLoader(data_config(cfg, SEQ, BATCH)),
                       steps=3, log_every=10 ** 9)
    state = [hist.pop("params"), hist.pop("opt_state")]
    batch = trainer._place(
        PrefetchingLoader(data_config(cfg, SEQ, BATCH)).get(3))

    def step():
        state[0], state[1], _ = trainer.step_fn(state[0], state[1], batch)
        torch.cuda.synchronize()

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    flash_bwd = sum(e.time_range.elapsed_us() for e in kern
                    if "flash_bwd" in e.name) / 1e3
    busy = cs._device_busy_us(kern) / 1e3
    del state, trainer
    torch.cuda.empty_cache()
    case = cs._flash_bwd_case(cs.ARCH, BATCH, SEQ, torch.bfloat16)
    print(json.dumps({
        "tree": os.getcwd(), "loss": hist["loss"], "step_wall_ms": walls,
        "device_busy_ms": busy, "flash_bwd_device_ms": flash_bwd,
        "kernels": len(kern), "flash_bwd_ms": case["ms"],
        "library_ms": case["library_ms"],
        "max_abs_err": case["max_abs_err"],
        "kernel_us": case["kernel_us"]}), flush=True)


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
