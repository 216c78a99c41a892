"""Serve a small model on the PyTorch port with continuously batched
requests through :class:`repro_torch.runtime.ClusterRuntime`, with int8
weight-only quantization optionally enabled (the paper's DSP-style
serving mode). The twin of ``examples/serve_lm.py``, on the card unless
``--device cpu`` asks for the plain PyTorch versions of the kernels.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch granite-moe-1b-a400m
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

What differs from the reference: it runs over ``h100_sxm()``, one H100
as 8 shares, where the reference takes ``tpu_v5e_pod(args.slots)``, a pod
of one chip a slot. As in ``repro_torch.launch.serve``, each active share
admits one decode slot, so ``--slots`` caps concurrency and at most that
many of the 8 shares are ever useful; the modelled energy is the card's
shares' (an assumed idle floor, no host), not the pod's chips and hosts.
"""
import argparse
import time

import numpy as np

from repro_torch.config import ServeConfig, get_config, smoke_config
from repro_torch.core.cluster import h100_sxm
from repro_torch.runtime import ClusterRuntime, LMServingWorkload, ScalePolicy
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(get_config(args.arch))
    engine = ServingEngine(
        cfg, ServeConfig(max_seq_len=64, quantize_weights=args.int8),
        device=args.device)
    engine.init_random(0)
    workload = LMServingWorkload(engine, slots=args.slots,
                                 max_new_tokens=args.max_new_tokens)
    # one engine tick ≙ one decode step; a "unit" sustains ~0.25 req/s at
    # smoke scale, so a burst of submissions activates all slots
    runtime = ClusterRuntime(h100_sxm(), workload,
                             policy=ScalePolicy(min_units=1),
                             unit_rate=0.25)

    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
        runtime.submit(prompt)

    t0 = time.monotonic()
    tel = runtime.run(max_ticks=10000)
    dt = time.monotonic() - t0
    total_tokens = sum(len(r.output) for r in tel.responses)
    print(f"{args.requests} requests x {args.max_new_tokens} tokens on "
          f"{args.slots} slots ({'int8' if args.int8 else 'bf16'} weights)")
    print(f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s, {tel.ticks} engine ticks, "
          f"mean active units {tel.mean_active:.1f})")
    for r in tel.responses[:3]:
        print(f"  req {r.rid}: {r.output}")
    return tel


if __name__ == "__main__":
    main()
