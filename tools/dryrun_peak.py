#!/usr/bin/env python3
"""What is live at a dry-run cell's traced memory peak.

    PYTHONPATH=src python3 tools/dryrun_peak.py ARCH SHAPE [--multi-pod]
        [--device cuda|cpu] [--top N]

Traces one cell as ``python -m repro_torch.launch.dryrun`` does (full
width and depth, a fake world of 256 or 512 ranks, nothing allocated),
then prints the peak of live storage (the recorder's
``temp_size_in_bytes`` before outputs are set aside) and the ``N``
largest storages live at that moment, by the op that allocated each and
its shape (``roofline.counter.Recorder.peak_storages``).
"""
from __future__ import annotations

import argparse

from repro_torch.config import SHAPES, get_config, resolve_device
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    with fake_world(512 if args.multi_pod else 256):
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device=dev.type)
        traced, _, _ = dryrun._lower_cell(get_config(args.arch),
                                          SHAPES[args.shape], mesh, opts={},
                                          scan=True)
    peak, live = traced.recorder.peak_storages()
    print(f"{args.arch} {args.shape} {mesh.size()} ranks on {dev.type}: "
          f"peak of live storage {peak / 2 ** 30:.2f} GiB")
    for n, op, shape, dtype in live[:args.top]:
        print(f"  {n / 2 ** 30:8.2f} GiB  {op}  {shape}  {dtype}")


if __name__ == "__main__":
    main()
