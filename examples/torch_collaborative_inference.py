"""Reproduce the paper's §5.3 / Fig 13 collaborative-inference experiment
and its ring-overlap upgrade on the PyTorch port. The twin of
``examples/collaborative_inference.py``.

Prints the three-way latency table (baseline TP, paper-pipelined TP, TPU
ring-overlap TP) for 1..5 units, then with ``--exec`` runs the TP block
(``repro_torch.core.collaborative.make_tp_block``) both ways over the
ranks it was launched with: NCCL on the cards (``--device cuda``, the
default, one rank a card), gloo with ``--device cpu``.

    PYTHONPATH=src python examples/torch_collaborative_inference.py
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 examples/torch_collaborative_inference.py \\
        --exec --device cpu

Launched without ``torch.distributed.run``, ``--exec`` runs a world of
one. Only rank 0 prints.
"""
import argparse
import datetime
import os
import tempfile
import time

import numpy as np

from repro_torch.core.collaborative import (PAPER_FIG13, RESNET50_PROFILE,
                                            SOC_TCP, TPU_ICI,
                                            latency_breakdown)


def table_lines():
    lines = [f"{'N':>2} {'base ms':>9} {'share':>6} {'pipe ms':>9} "
             f"{'share':>6} {'ring ms':>9} {'share':>7}"]
    for n in range(1, 6):
        b = latency_breakdown(RESNET50_PROFILE, n, SOC_TCP)
        p = latency_breakdown(RESNET50_PROFILE, n, SOC_TCP, pipelined=True)
        r = latency_breakdown(RESNET50_PROFILE, n, TPU_ICI,
                              ring_overlap=True)
        lines.append(f"{n:>2} {b['total_ms']:>9.1f} {b['comm_share']:>6.1%} "
                     f"{p['total_ms']:>9.1f} {p['comm_share']:>6.1%} "
                     f"{r['total_ms']:>9.2f} {r['comm_share']:>7.2%}")
    lines.append(
        f"paper @N=5: comm share {PAPER_FIG13['comm_share_at_5']:.1%} -> "
        f"{PAPER_FIG13['comm_share_at_5_pipelined']:.1%} pipelined; "
        f"speedup {PAPER_FIG13['total_speedup_at_5']}x")
    return lines


def _init_group(device: str):
    """The default process group: from ``torch.distributed.run``'s
    environment, or a world of one over a file store."""
    import torch
    import torch.distributed as dist

    from repro_torch.config.torch_env import resolve_device

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    timeout = datetime.timedelta(seconds=120)
    if "RANK" in os.environ:
        dist.init_process_group(backend, timeout=timeout)
        return None
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp.name, "store"), 1),
        rank=0, world_size=1, timeout=timeout)
    return tmp


def run_exec(device: str, iters: int = 20):
    """The TP block both ways on every rank; returns, for each way,
    (us a call, max abs error of y against one rank's x @ W1 @ W2)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.collaborative import make_tp_block
    from repro_torch.launch.mesh import make_mesh

    tmp = _init_group(device)
    try:
        n = dist.get_world_size()
        mesh = make_mesh((n,), ("model",), device=device)
        dev = mesh.device_type
        rng = np.random.default_rng(0)
        m, d, f = 64, 512, 2048
        x = torch.as_tensor(rng.standard_normal((m, d)),
                            dtype=torch.float32).to(dev)
        w1 = torch.as_tensor(rng.standard_normal((d, f)),
                             dtype=torch.float32).to(dev) * 0.05
        w2 = torch.as_tensor(rng.standard_normal((f, d)),
                             dtype=torch.float32).to(dev) * 0.05
        ref = torch.relu(x @ w1) @ w2
        out = {}
        for overlap in (False, True):
            fn = make_tp_block(mesh, d, f, overlap=overlap)
            y = fn(x, w1, w2)
            err = (y.full_tensor() - ref).abs().max().item()
            if dev == "cuda":
                torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                y = fn(x, w1, w2)
            if dev == "cuda":
                torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / iters
            out[overlap] = (dt * 1e6, err)
            if dist.get_rank() == 0:
                print(f"exec n={n} overlap={overlap}: {dt*1e6:.0f} us/call, "
                      f"max abs err {err:.3g}", flush=True)
        return out
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            tmp.cleanup()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exec", action="store_true",
                    help="also run the TP block over the launched ranks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if int(os.environ.get("RANK", "0")) == 0:
        for line in table_lines():
            print(line, flush=True)
    if args.exec:
        return run_exec(args.device)
    return None


if __name__ == "__main__":
    main()
