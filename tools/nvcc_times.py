#!/usr/bin/env python3
"""Wall time of each kernel source's compile, all started together.

    python3 tools/nvcc_times.py [DIR ...]

Compiles every ``*.cu`` of each DIR (default ``src/repro_torch/csrc``)
with the flags ``repro_torch.kernels._build`` uses, one ``nvcc`` a
source, all of a DIR's started at once as the build starts them, and
prints each source's seconds from the start as it ends: the last is the
build's critical path. DIRs are compiled one after the other, so a
second tree (another commit's ``csrc``, unpacked with ``git archive``)
is timed on the same machine in the same call. Needs ``nvcc``.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels._build import NVCC_FLAGS, find_nvcc  # noqa: E402


def time_dir(nvcc: str, src_dir: Path, out_dir: Path) -> None:
    t0 = time.monotonic()
    procs = {s.name: subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(src_dir), "-c", str(s), "-o",
         str(out_dir / (s.stem + ".o"))],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for s in sorted(src_dir.glob("*.cu"))}
    while procs:
        for name, proc in list(procs.items()):
            if proc.poll() is not None:
                print(f"{src_dir} {name} rc {proc.returncode} "
                      f"{time.monotonic() - t0:.1f} s", flush=True)
                del procs[name]
        time.sleep(0.1)


def main() -> None:
    dirs = [Path(d) for d in sys.argv[1:]] or [
        Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"]
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory() as out:
        for d in dirs:
            time_dir(nvcc, d, Path(out))


if __name__ == "__main__":
    main()
