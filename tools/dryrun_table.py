#!/usr/bin/env python3
"""Tabulate the port's dry-run results as markdown.

    python3 tools/dryrun_table.py [RESULTS_DIR] [--tag TAG]

Reads every ``<arch>__<shape>__<mesh>[__<tag>].json`` that
``python -m repro_torch.launch.dryrun`` wrote (``results/dryrun_torch/``
by default) and prints one row an (arch, shape): the three roofline terms
in ms, the bound, GiB a device (``total_nonalias_bytes``, marked
``>card`` above one H100's 85017493504 bytes), the collectives' wire
bytes by kind in GB, the kernel calls and the trace's seconds. A value
that differs between the meshes reads ``pod16x16 / pod2x16x16``; a cell
traced on one mesh only names it beside its shape.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

CARD_BYTES = 85017493504        # torch.cuda total_memory of one H100 SXM
KINDS = (("all-reduce", "AR"), ("all-gather", "AG"),
         ("reduce-scatter", "RS"), ("all-to-all", "A2A"))
MESHES = ("pod16x16", "pod2x16x16")
HEAD = ("arch", "shape", "compute ms", "memory ms", "collective ms",
        "bound", "GiB/device", "wire GB", "kernel calls", "trace s")


def results(results_dir: str, tag: str) -> dict:
    """(arch, shape) -> {mesh: result}."""
    suffix = f"__{tag}.json" if tag else ".json"
    out: dict = {}
    for path in glob.glob(os.path.join(results_dir, "*.json")):
        name = os.path.basename(path)
        if not name.endswith(suffix) or (not tag and name.count("__") != 2):
            continue
        with open(path) as f:
            r = json.load(f)
        out.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    return out


def num(v: float) -> str:
    """Four significant digits, whole numbers from 1000 up."""
    return f"{v:.0f}" if abs(v) >= 1000 else f"{v:.4g}"


def fields(r: dict) -> list:
    """The three terms, bound, GiB, wire GB, kernel calls and trace s."""
    t, mem = r["roofline"], r["memory_analysis"]
    nbytes = mem["total_nonalias_bytes"]
    gib = f"{nbytes / 2 ** 30:.2f}" + (" >card" if nbytes > CARD_BYTES
                                       else "")
    wire = r["collectives"]["wire_bytes"]
    w = " ".join(f"{short} {num(wire[k] / 1e9)}" for k, short in KINDS
                 if wire.get(k))
    calls = " ".join(f"{k} {v}" for k, v in
                     r["cost_analysis"]["kernel_calls"].items())
    return [*(num(t[k] * 1e3) for k in ("compute_s", "memory_s",
                                        "collective_s")),
            t["bound"], gib, w or "-", calls or "-", f"{r['lower_s']:.1f}"]


def row(arch: str, shape: str, by_mesh: dict) -> str:
    meshes = [m for m in MESHES if m in by_mesh]
    if len(meshes) == 1:
        shape = f"{shape} ({meshes[0]})"
    cols = zip(*(fields(by_mesh[m]) for m in meshes))
    cells = [c[0] if len(set(c)) == 1 else " / ".join(c) for c in cols]
    return "| " + " | ".join([arch, shape, *cells]) + " |"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("results_dir", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "results",
        "dryrun_torch"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    print("| " + " | ".join(HEAD) + " |")
    print("|---" * len(HEAD) + "|")
    for (arch, shape), by_mesh in sorted(results(args.results_dir,
                                                 args.tag).items()):
        print(row(arch, shape, by_mesh))


if __name__ == "__main__":
    main()
