"""Serving launcher: continuous-batched generation on one device.

Submits ``--requests`` prompts drawn from ``np.random.default_rng(0)`` to a
:class:`~repro_torch.serving.batcher.ContinuousBatcher` and steps it to
completion, then prints a JSON report: the JAX launcher's keys except
``telemetry`` (that comes with the port of ``ClusterRuntime``), plus
``kernel_launches``, the launches of each of the five kernels during the
run (``int8_matmul`` has no call site on this path and stays 0).

    python -m repro_torch.launch.serve --arch internlm2-1.8b
    python -m repro_torch.launch.serve --arch mamba2-130m
    python -m repro_torch.launch.serve --arch mamba2-130m --smoke --device cpu

Mamba prompts keep the SSD contract: ``--prompt-len`` at most the config's
chunk (256; 32 at smoke size) or a multiple of it.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch.config.base import (ModelConfig, ServeConfig, get_config,
                                     smoke_config)
from repro_torch.kernels import ops
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.engine import ServingEngine


def serve(cfg: ModelConfig, prompt_lens: Sequence[int], *,
          max_new_tokens: int = 16, slots: int = 4,
          int8_weights: bool = False, device: str = "cuda",
          seed: int = 0) -> Dict[str, Any]:
    """Serve one request per entry of ``prompt_lens`` with random weights
    from ``seed``; returns the report."""
    scfg = ServeConfig(max_seq_len=max(prompt_lens) + max_new_tokens + 8,
                       quantize_weights=int8_weights)
    engine = ServingEngine(cfg, scfg, device=device)
    engine.init_random(seed)
    batcher = ContinuousBatcher(engine, slots=slots)

    rng = np.random.default_rng(0)
    before = ops.launch_counts()
    t0 = time.monotonic()
    for n in prompt_lens:
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        batcher.submit(prompt, max_new_tokens=max_new_tokens)
    ticks = 0
    while batcher.queue or any(a is not None for a in batcher.active):
        batcher.step()
        ticks += 1
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.monotonic() - t0
    after = ops.launch_counts()
    done = sorted(batcher.finished, key=lambda r: r.rid)
    tokens = sum(len(r.generated) for r in done)
    return {
        "arch": cfg.name,
        "device": str(engine.device),
        "requests": len(prompt_lens),
        "served": len(done),
        "ticks": ticks,
        "wall_s": dt,
        "tokens_generated": tokens,
        "tokens_per_s": tokens / dt,
        "sample_output": [int(t) for t in done[0].generated[:8]]
        if done else [],
        "kernel_launches": {k: after[k] - before[k] for k in after},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--int8-weights", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    report = serve(cfg, [args.prompt_len] * args.requests,
                   max_new_tokens=args.max_new_tokens, slots=args.slots,
                   int8_weights=args.int8_weights, device=args.device)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
