"""Run code on N gloo ranks of the PyTorch port, one process a rank.

``run_ranks(code, world, tmp_path, inputs)`` writes ``inputs`` (numpy
arrays) to ``inputs.npz`` and starts ``world`` processes. Each sets one
thread, opens the default group over gloo with a file store in
``tmp_path`` (so that parallel test workers never race for a port) and a
timeout, then runs ``code`` with ``rank``, ``world``, ``inputs`` and an
empty dict ``out`` in scope; what the code puts in ``out`` (numpy arrays
or numbers) comes back, one dict a rank. A rank that fails or outlives
``timeout`` fails the test with every rank's output.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 60

RANK_MAIN = """
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, _dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", init_method=f"file://{_dir}/store", rank=rank, world_size=world,
    timeout=datetime.timedelta(seconds=%d))
inputs = dict(np.load(f"{_dir}/inputs.npz"))
out = {}
exec(compile(open(f"{_dir}/job.py").read(), "job.py", "exec"))
dist.destroy_process_group()
np.savez(f"{_dir}/out{rank}.npz", **out)
""" % RANK_TIMEOUT_S


def run_ranks(code: str, world: int, tmp_path: pathlib.Path,
              inputs: dict | None = None, timeout: int = 150) -> list:
    d = pathlib.Path(tmp_path)
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "inputs.npz", **(inputs or {}))
    (d / "job.py").write_text(code)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_MAIN, str(r), str(world), str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a gloo rank outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        pytest.fail(f"gloo ranks {bad} failed:\n" + "\n".join(
            f"--- rank {r}\n{logs[r][-3000:]}" for r in bad))
    return [dict(np.load(d / f"out{r}.npz")) for r in range(world)]
