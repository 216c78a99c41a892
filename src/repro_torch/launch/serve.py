"""Serving launcher: continuous-batched generation on one device, run
through the port's :class:`~repro_torch.runtime.ClusterRuntime`
request-lifecycle API (activation gating + modelled energy, paper §5.2),
as the JAX launcher runs the JAX engine.

Submits ``--requests`` prompts drawn from ``np.random.default_rng(0)`` to
the runtime over :func:`~repro_torch.core.cluster.h100_sxm` (one H100 as 8
shares, each active share admitting one decode slot) and runs it to
completion, then prints a JSON report: the JAX launcher's keys,
``telemetry`` included, plus ``device`` and ``kernel_launches``, the
launches of each of the five kernels during the run (``int8_matmul`` has
no call site on this path and stays 0).

The telemetry is modelled, not measured. Each tick counts as one modelled
second (the runtime's ``dt_s=1.0``), so ``energy_j_modeled`` is the
spec's assumed power integrated over ``ticks`` modelled seconds, and
``p99_latency_ticks`` is in ticks; neither is the card's energy or time
over ``wall_s``. ``tokens_per_s`` is gated throughput: ``unit_rate=0.25``
req/s a share decides how many slots the runtime wakes, so it is not what
the card could sustain.

    python -m repro_torch.launch.serve --arch internlm2-1.8b
    python -m repro_torch.launch.serve --arch stablelm-12b
    python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --smoke --device cpu

``--arch`` takes any arch of ``repro_torch.configs.PORTED_ARCHS``, all
eleven of the JAX package's configs: the dense internlm2-1.8b,
phi3-medium-14b, stablelm-12b, bert-base and qwen2-72b, the audio
musicgen-large and the VLM internvl2-1b (backbones; the launcher sends
tokens only, as the JAX launcher does), the SSM mamba2-130m, the MoE
granite-moe-1b-a400m and llama4-maverick-400b-a17b, and the hybrid
jamba-1.5-large-398b (Mamba, attention and MoE layers). bert-base runs
as the JAX package runs it, the same causal dense stack. On one card at
full width: internlm2-1.8b, phi3-medium-14b, stablelm-12b,
musicgen-large, internvl2-1b, bert-base, mamba2-130m and
granite-moe-1b-a400m; the others at ``--smoke``. Mamba prompts keep the
SSD contract: ``--prompt-len`` at most the config's chunk (256; 32 at
smoke size) or a multiple of it.
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
from repro_torch.core.cluster import h100_sxm
from repro_torch.kernels import ops
from repro_torch.runtime import ClusterRuntime, LMServingWorkload, ScalePolicy
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
    workload = LMServingWorkload(engine, slots=slots,
                                 max_new_tokens=max_new_tokens)
    # the JAX launcher's runtime arguments: a unit sustains ~0.25 req/s, so
    # a burst of submissions scales slots up and the window decay scales
    # them back down
    runtime = ClusterRuntime(h100_sxm(), workload,
                             policy=ScalePolicy(min_units=1),
                             unit_rate=0.25)

    rng = np.random.default_rng(0)
    before = ops.launch_counts()
    t0 = time.monotonic()
    for n in prompt_lens:
        runtime.submit(rng.integers(0, cfg.vocab_size,
                                    size=n).astype(np.int32))
    tel = runtime.run(max_ticks=10000)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.monotonic() - t0
    after = ops.launch_counts()
    tokens = sum(len(r.output) for r in tel.responses)
    return {
        "arch": cfg.name,
        "device": str(engine.device),
        "requests": len(prompt_lens),
        "served": tel.served,
        "ticks": tel.ticks,
        "wall_s": dt,
        "tokens_generated": tokens,
        "tokens_per_s": tokens / dt,
        "telemetry": {
            "mean_active_units": tel.mean_active,
            "energy_j_modeled": tel.energy_j,
            "tpe": tel.tpe,
            "scale_events": tel.scale_events,
            "p99_latency_ticks": tel.p99_latency_s,
        },
        "sample_output": [int(t) for t in tel.responses[0].output[:8]]
        if tel.responses else [],
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
