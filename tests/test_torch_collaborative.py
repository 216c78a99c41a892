"""The paper's §5.3 collaborative inference in the port against the JAX
package's: the analytic latency model equal for n = 1..5 in all three
variants, and the example twin, launched by ``torch.distributed.run`` on
4 gloo ranks with ``--exec``, printing the JAX example's table lines and
running the TP block both ways (its error against one rank's product
printed beside each time)."""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import pytest

from repro.core import collaborative as jcol
from repro_torch.core import collaborative as tcol

REPO = pathlib.Path(__file__).resolve().parents[1]
VARIANTS = ("baseline", "pipelined", "tpu_ring")


@pytest.mark.parametrize("n", range(1, 6))
def test_latency_breakdown_equals_jax(n):
    for net in ("SOC_TCP", "TPU_ICI"):
        for kw in ({}, {"pipelined": True}, {"ring_overlap": True}):
            got = tcol.latency_breakdown(tcol.RESNET50_PROFILE, n,
                                         getattr(tcol, net), **kw)
            want = jcol.latency_breakdown(jcol.RESNET50_PROFILE, n,
                                          getattr(jcol, net), **kw)
            assert got == want, (net, kw)


@pytest.mark.parametrize("variant", VARIANTS)
def test_fig13_table_equals_jax(variant):
    got, want = tcol.fig13_table(), jcol.fig13_table()
    assert len(got) == len(want) == 5
    assert [r[variant] for r in got] == [r[variant] for r in want]
    assert [r[variant]["n"] for r in got] == [1, 2, 3, 4, 5]


def test_profiles_and_networks_equal_jax():
    for name in ("SOC_TCP", "TPU_ICI", "RESNET50_PROFILE"):
        assert dataclasses.asdict(getattr(tcol, name)) == \
            dataclasses.asdict(getattr(jcol, name))
    assert tcol.PAPER_FIG13 == jcol.PAPER_FIG13


def _run(argv, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "src"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, *argv], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout.splitlines()


@pytest.fixture(scope="module")
def jax_lines():
    return _run(["examples/collaborative_inference.py"])


@pytest.fixture(scope="module")
def twin_lines():
    return _run(["-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "4",
                 "examples/torch_collaborative_inference.py", "--exec",
                 "--device", "cpu"])


def test_example_twin_prints_the_jax_table(jax_lines, twin_lines):
    assert len(jax_lines) == 7
    assert twin_lines[:7] == jax_lines


def test_example_twin_runs_the_tp_block_both_ways_on_four_ranks(twin_lines):
    execs = [ln for ln in twin_lines if ln.startswith("exec")]
    assert len(execs) == 2, twin_lines
    for line, overlap in zip(execs, (False, True)):
        m = re.fullmatch(rf"exec n=4 overlap={overlap}: (\d+) us/call, "
                         r"max abs err (\S+)", line)
        assert m, line
        assert float(m.group(2)) < 1e-3


def test_example_twin_without_exec_prints_only_the_table(jax_lines):
    assert _run(["examples/torch_collaborative_inference.py"]) == jax_lines
