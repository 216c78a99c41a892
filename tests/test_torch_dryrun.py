"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), on the CPU.

JAX runs in one subprocess on 8 fake XLA host devices: its own
``_lower_cell`` on a (2, 4) ``("data", "model")`` mesh, unrolled
(``scan=False``, so XLA's cost analysis counts every layer), compiled, read
through its ``_memory_analysis_dict`` and ``_cost_and_collectives``, at the
smoke configs of internlm2-1.8b and granite-moe-1b-a400m at train, prefill
and decode (seq 64, batch 8) and of mamba2-130m and jamba at train; and
its ``run_cell`` once more, on that mesh and a smoke decode shape, for the
result's keys. The port traces the same cells on a fake world of 8 ranks
over a CPU mesh (``device="cpu"``: the kernels run their plain versions,
as a CPU step runs them). Held equal: the step kind, tokens, model FLOPs,
``sanctioned``, ``skip_note``, ``argument_size_in_bytes`` (bit for bit)
and the result's keys, but ``probe.scan_reported_flops``, which an eager
trace has no counterpart of. Per-chip FLOPs agree within ``FLOP_BAND``.
"""
import json
import subprocess
import sys

import pytest

from conftest import run_in_subprocess
from repro_torch.config import ShapeSpec, get_config, smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh

MESH = (2, 4)
SEQ, BATCH = 64, 8
CELLS = [("internlm2-1.8b", k) for k in ("train", "prefill", "decode")] + \
    [("granite-moe-1b-a400m", k) for k in ("train", "prefill", "decode")] + \
    [("mamba2-130m", "train"), ("jamba-1.5-large-398b", "train")]
SHAPE_NAMES = {"train": "train_4k", "prefill": "prefill_32k",
               "decode": "decode_32k"}
# Per-chip FLOPs, the port's over XLA's, measured at these cells: 0.388
# (granite-moe train) to 0.873 (internlm2 prefill). XLA's cost analysis
# also counts a FLOP for each element of every elementwise op (softmax,
# the norms, RoPE, the Adam update, Mamba's conv and gates, the MoE's
# routing), which FlopCounterMode's formulas leave at 0, and at smoke
# width (d_model 64) those are 13-61 % of its count; the matmuls are the
# rest. The band's floor is under the lowest ratio, its top under 1,
# which a doubled product (a layer traced twice) would cross.
FLOP_BAND = (0.35, 0.9)
JAX_ONLY_KEYS = {("probe", "scan_reported_flops")}


def _shape(kind: str) -> ShapeSpec:
    return ShapeSpec(SHAPE_NAMES[kind], SEQ, BATCH, kind)


REF_CODE = """
import json, sys
import jax
assert jax.device_count() >= 8, jax.device_count()
from repro.launch import dryrun as D
from repro.config import ShapeSpec, get_config, smoke_config
from repro.launch.mesh import make_mesh
from repro.roofline.analysis import model_flops
from repro.config import shape_applicable
cells, names, seq, batch = json.loads(sys.argv[1])
mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for arch, kind in cells:
    cfg = smoke_config(get_config(arch))
    shape = ShapeSpec(names[kind], seq, batch, kind)
    lowered, step_kind, tokens = D._lower_cell(cfg, shape, mesh, opts={},
                                               scan=False)
    compiled = lowered.compile()
    mem = D._memory_analysis_dict(compiled)
    cost, coll = D._cost_and_collectives(compiled)
    ok, note = shape_applicable(cfg, shape)
    out[arch + "/" + kind] = {
        "step_kind": step_kind, "tokens": tokens,
        "model_flops_total": model_flops(cfg.num_active_params, tokens,
                                         step_kind),
        "sanctioned": ok, "skip_note": note, "flops": cost["flops"],
        "memory": mem}
D.get_config = lambda a: smoke_config(get_config(a))
D.make_production_mesh = lambda multi_pod=False: mesh
D.SHAPES = {"decode_32k": ShapeSpec("decode_32k", seq, batch, "decode")}
res = D.run_cell("internlm2-1.8b", "decode_32k", verbose=False)
out["keys"] = {k: sorted(v) if isinstance(v, dict) else None
               for k, v in res.items()}
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(require_fake_devices):
    r = run_in_subprocess(
        REF_CODE.replace("sys.argv[1]", repr(json.dumps(
            [CELLS, SHAPE_NAMES, SEQ, BATCH]))), devices=8, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


@pytest.fixture(scope="module")
def port():
    out = {}
    with fake_world(8):
        mesh = make_mesh(MESH, ("data", "model"), device="cpu")
        for arch, kind in CELLS:
            cfg = smoke_config(get_config(arch))
            traced, step_kind, tokens = dryrun._lower_cell(
                cfg, _shape(kind), mesh, opts={}, scan=False)
            cost, _ = dryrun._cost_and_collectives(traced)
            out[f"{arch}/{kind}"] = {
                "traced": traced, "step_kind": step_kind, "tokens": tokens,
                "flops": cost["flops"],
                "memory": dryrun._memory_analysis_dict(traced)}
        out["result"] = dryrun._cell(
            "internlm2-1.8b", smoke_config(get_config("internlm2-1.8b")),
            _shape("decode"), mesh, "pod2x4", opts={}, probes=True,
            verbose=False)
    return out


@pytest.mark.parametrize("cell", [f"{a}/{k}" for a, k in CELLS])
def test_cell_matches_reference(cell, reference, port):
    """Step kind, tokens, model FLOPs, the spec's applicability and the
    argument bytes equal the JAX package's; per-chip FLOPs in the band."""
    ref, ours = reference[cell], port[cell]
    arch = cell.split("/")[0]
    cfg = smoke_config(get_config(arch))
    assert ours["step_kind"] == ref["step_kind"]
    assert ours["tokens"] == ref["tokens"]
    assert dryrun.model_flops(cfg.num_active_params, ours["tokens"],
                              ours["step_kind"]) == ref["model_flops_total"]
    assert list(dryrun.shape_applicable(cfg, _shape(ours["step_kind"]))) == \
        [ref["sanctioned"], ref["skip_note"]]
    assert ours["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]
    assert set(ours["memory"]) == set(ref["memory"])
    ratio = ours["flops"] / ref["flops"]
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], (cell, ratio)


def test_result_keys_match_reference(reference, port):
    """The result's keys, and those of each dict in it, are the JAX
    package's, less ``probe.scan_reported_flops``; ``cost_analysis``
    holds XLA's own keys there and the port's split of aten ops and
    kernels here, so only its ``flops`` and ``bytes accessed`` are held."""
    res = port["result"]
    assert set(res) == set(reference["keys"])
    for key, sub in reference["keys"].items():
        if sub is None or key == "cost_analysis":
            continue
        want = {s for s in sub if (key, s) not in JAX_ONLY_KEYS}
        assert set(res[key]) == want, key
    assert {"flops", "bytes accessed"} <= set(res["cost_analysis"])
    assert res["probe"]["period"] == 1 and res["probe"]["blocks"] == 4
    assert res["lower_s"] > 0 and res["compile_s"] == 0.0


def test_cli_defaults_to_the_card_and_raises_without_one():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False; "
         "sys.argv = ['dryrun', '--arch', 'internlm2-1.8b', '--shape', "
         "'decode_32k']; from repro_torch.launch import dryrun; "
         "dryrun.main()"], capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
