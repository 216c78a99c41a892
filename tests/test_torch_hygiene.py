"""The port stands alone: no JAX and nothing of ``repro`` in
``src/repro_torch/``, ``chip_smoke.py``, the port's measurement tools
``tools/train_step_ab.py`` and ``tools/attention_ab.py`` or its examples
``examples/torch_*.py``; its copied configs equal the JAX package's, and
so does every definition of its copies of the numpy layer; its entry
points refuse a missing card instead of running on the CPU."""
import ast
import dataclasses
import pathlib
import re

import pytest
import torch

import repro.config as jconfig
from repro_torch.config import get_config, smoke_config
from repro_torch.configs import PORTED_ARCHS
from repro_torch.launch.serve import serve
from repro_torch.serving.engine import ServingEngine

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "train_step_ab.py",
    REPO / "tools" / "attention_ab.py"] + sorted(
    (REPO / "examples").glob("torch_*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or name.startswith("jax")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_no_jax_and_nothing_of_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_port_has_the_three_kernel_sources():
    """One CUDA source for each of the JAX package's five Pallas kernels,
    and the SSD scan's backward in one of its own (the name dates from the
    first slice, which had three)."""
    csrc = REPO / "src" / "repro_torch" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "rmsnorm.cu", "flash_attention.cu", "decode_attention.cu",
        "ssd_scan.cu", "ssd_scan_bwd.cu", "int8_matmul.cu"}
    pallas = {p.stem for p in (REPO / "src" / "repro" / "kernels").glob(
        "*.py") if "pl.pallas_call" in p.read_text()}
    assert {p.stem.removesuffix("_bwd") for p in csrc.glob("*.cu")} == pallas


def test_port_has_every_arch_of_the_reference():
    """All eleven of the JAX package's configs, bert-base included."""
    assert sorted(PORTED_ARCHS) == sorted(jconfig.list_configs())
    assert len(PORTED_ARCHS) == 11


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_copied_configs_equal_reference(arch):
    ours, ref = get_config(arch), jconfig.get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(smoke_config(ours)) == \
        dataclasses.asdict(jconfig.smoke_config(ref))


def test_serve_config_equals_reference():
    from repro_torch.config import ServeConfig
    assert dataclasses.asdict(ServeConfig()) == \
        dataclasses.asdict(jconfig.ServeConfig())


@pytest.mark.parametrize("name", ["TrainConfig", "ShapeSpec"])
def test_train_config_and_shape_spec_equal_reference(name):
    """Field by field: names, annotations and defaults, in order."""
    import repro_torch.config as tconfig
    ours, ref = getattr(tconfig, name), getattr(jconfig, name)
    fields = lambda c: [(f.name, str(f.type), f.default)
                        for f in dataclasses.fields(c)]
    assert fields(ours) == fields(ref)
    assert ours.__dataclass_params__.frozen == ref.__dataclass_params__.frozen
    if name == "TrainConfig":
        assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())
    else:
        args = ("train_4k", 4096, 256, "train")
        assert dataclasses.asdict(ours(*args)) == \
            dataclasses.asdict(ref(*args))
        assert ours(*args).is_decode == ref(*args).is_decode


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config(get_config("internlm2-1.8b"))
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve(cfg, [4], max_new_tokens=2)
    # and so do the sharded entry points, before they look at the mesh
    from repro_torch.config import TrainConfig
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.training.train_loop import Trainer
    mesh = AbstractMesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, mesh=mesh)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, TrainConfig(), mesh=mesh)


# Inside a model step nothing is gathered: the models, the kernel ops, the
# optimizer and the sharding layer call no ``full_tensor()`` (the JAX
# package's ``shard()`` replicates nothing there that the rules do not).
# Only what reads a step's result from outside gathers: checkpoints, the
# trainer's metrics, the engine's logits (``whole``).
STEP_FILES = sorted((REPO / "src" / "repro_torch" / "models").glob("*.py")) \
    + sorted((REPO / "src" / "repro_torch" / "kernels").glob("*.py")) + [
        REPO / "src" / "repro_torch" / "training" / "optimizer.py",
        REPO / "src" / "repro_torch" / "distributed" / "sharding.py"]


@pytest.mark.parametrize("path", STEP_FILES,
                         ids=[str(p.relative_to(REPO)) for p in STEP_FILES])
def test_model_steps_gather_no_tensor(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    calls = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Attribute)
             and n.attr == "full_tensor"]
    assert not calls, f"{path}: full_tensor() at lines {calls}"


# The numpy layer the port copies (paths under src/repro and
# src/repro_torch): each copy is the original with ``repro.`` rewritten to
# ``repro_torch.``.
COPIED = ["core/cluster.py", "core/scheduler.py", "power/__init__.py",
          "power/opp.py", "power/thermal.py", "power/governor.py",
          "runtime/__init__.py", "runtime/result.py", "runtime/sanitize.py",
          "runtime/pool.py", "runtime/policy.py", "runtime/workload.py",
          "runtime/multi_tenant.py", "runtime/cluster_runtime.py",
          "workloads/dlserving.py", "training/data.py",
          # the fleet layer and what it imports
          "core/energy.py", "core/tco.py", "distributed/fault.py",
          "fleet/traces.py", "fleet/router.py", "fleet/engine_state.py",
          "fleet/telemetry.py", "fleet/chaos.py", "fleet/degrade.py",
          "fleet/fleet.py", "fleet/__init__.py", "obs/__init__.py",
          "obs/attribution.py", "obs/probe.py", "obs/slo.py", "obs/trace.py",
          "obs/export.py", "obs/report.py",
          # the analytic half of the paper's §5.3 collaborative inference
          "core/collaborative.py",
          # the dry run's chip specs
          "roofline/hw.py"]
# Statements a copy may add or change, by (module, key). A class named in
# SPLIT is keyed method by method ("Class.method"), so an exemption names
# one method and not the whole class.
EXEMPT = {
    # The port's H100 spec and its share count, which the original lacks.
    ("core/cluster.py", "H100_SHARES"),
    ("core/cluster.py", "h100_sxm"),
    # The data pipeline places batches as tensors: torch in place of jax;
    # place_on_mesh makes DTensors (distribute_tensor) where the original
    # makes sharded jax arrays (device_put), and place_on_device, which
    # the original lacks, moves a batch to one device.
    ("training/data.py", "import jax"),
    ("training/data.py", "import torch"),
    ("training/data.py", "place_on_mesh"),
    ("training/data.py", "place_on_device"),
    # remesh_arrays re-shards a tree of DTensors through their full values
    # (distribute_tensor onto the new mesh) where the original device_puts
    # a jax pytree. The rest of fault.py (HealthTracker, RetryPolicy, which
    # the chaos and degrade layers use) is numpy.
    ("distributed/fault.py", "remesh_arrays"),
    # The executable TP block runs over a DeviceMesh under local_map with
    # the port's collectives, where the original runs shard_map under jit;
    # these are its imports.
    ("core/collaborative.py", "make_tp_block"),
    ("core/collaborative.py", "import jax"),
    ("core/collaborative.py", "import jax.numpy"),
    ("core/collaborative.py", "import jax.sharding"),
    ("core/collaborative.py", "import repro_torch.distributed.compat"),
    ("core/collaborative.py", "import repro_torch.distributed.collectives"),
    ("core/collaborative.py", "import torch"),
    ("core/collaborative.py", "import torch.distributed"),
    ("core/collaborative.py", "import torch.distributed.device_mesh"),
    ("core/collaborative.py", "import torch.distributed.tensor.experimental"),
    ("core/collaborative.py", "import repro_torch.distributed.sharding"),
    # The third fleet engine is the torch one: Fleet.__init__ builds
    # _TorchFleetEngine on backend="torch" (with a device keyword) where
    # the original builds the jax engine, the lazy sweep surface imports
    # torch_engine, and the obs report CLI offers --backend torch and
    # --device in place of --backend jax.
    ("fleet/fleet.py", "Fleet.__init__"),
    ("fleet/__init__.py", "__getattr__"),
    ("obs/report.py", "main"),
    ("obs/report.py", "_build_fleet"),
    # The original's module docstring cites the change that added the
    # chaos layer by its number in the JAX package's history; the copy
    # names the module instead. The rest of the docstring is the same.
    ("fleet/degrade.py", "__doc__"),
    # The port's card, which the original's specs lack.
    ("roofline/hw.py", "H100_SXM"),
}
SPLIT = {("fleet/fleet.py", "Fleet")}


def _key(node: ast.AST) -> str:
    """The key of one statement: its name, target, module or test."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return node.name
    if isinstance(node, (ast.Assign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        return ",".join(ast.unparse(t) for t in targets)
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return "import " + (getattr(node, "module", None) or ",".join(
            a.name for a in node.names))
    if isinstance(node, ast.If):
        return "if " + ast.unparse(node.test)
    if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
        return "__doc__"
    return ast.unparse(node)


def _statements(path: pathlib.Path, rewrite: bool, rel: str = ""):
    """(key, ast.dump) of each top-level statement of a module; a class
    in SPLIT gives one entry for its header and one for each statement
    of its body, keyed "Class.member"."""
    text = path.read_text()
    if rewrite:
        text = re.sub(r"\brepro\.", "repro_torch.", text)
    out = []
    for node in ast.parse(text).body:
        key = _key(node)
        if isinstance(node, ast.ClassDef) and (rel, key) in SPLIT:
            body, node.body = node.body, []
            out.append((key, ast.dump(node)))
            out += [(f"{key}.{_key(n)}", ast.dump(n)) for n in body]
        else:
            out.append((key, ast.dump(node)))
    return out


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_reference(rel):
    """Every function, class, import, assignment and docstring of the
    original has its twin in the port's copy, identical once ``repro.``
    reads ``repro_torch.``; only the exemptions above differ."""
    keep = lambda stmts: [(k, d) for k, d in stmts
                          if (rel, k) not in EXEMPT]
    ref = keep(_statements(REPO / "src" / "repro" / rel, rewrite=True,
                           rel=rel))
    port = keep(_statements(REPO / "src" / "repro_torch" / rel,
                            rewrite=False, rel=rel))
    assert [k for k, _ in port] == [k for k, _ in ref]
    for (key, want), (_, got) in zip(ref, port):
        assert got == want, f"{rel}: {key} differs from the original"


def test_h100_spec_says_what_is_assumed():
    from repro_torch.core.cluster import h100_sxm
    doc = " ".join(h100_sxm.__doc__.split())
    assert "``p_idle`` and ``gamma`` are assumed, not measured" in doc


# The torch fleet engine's host side: numpy helpers and definitions copied
# from the JAX engine by name (only _host_rows, which reads a device, is
# the port's own).
ENGINE_COPIES = ["ROUTER_KINDS", "_EPS", "_REL", "_cum_tol", "_BLOCK",
                 "_Dims", "_full_load_j_per_req", "_base_params",
                 "_make_dims", "_fresh_carry", "_expand_submissions",
                 "_completions", "_queued_for_rack", "_responses_for_rack",
                 "_ThermalState", "SweepConfig", "_format_row"]


@pytest.mark.parametrize("name", ENGINE_COPIES)
def test_torch_engine_host_helpers_equal_jax_engine(name):
    def defs(path, rewrite):
        return dict(_statements(path, rewrite))
    ref = defs(REPO / "src" / "repro" / "fleet" / "jax_engine.py", True)
    port = defs(REPO / "src" / "repro_torch" / "fleet" / "torch_engine.py",
                False)
    assert port[name] == ref[name], f"{name} differs from jax_engine.py"


def test_split_class_keeps_every_member():
    """The method-level keys cover Fleet whole: its header and every
    member but the exempt __init__ are compared."""
    keys = [k for k, _ in _statements(
        REPO / "src" / "repro" / "fleet" / "fleet.py", True,
        rel="fleet/fleet.py")]
    assert "Fleet" in keys and "Fleet.play_trace" in keys
    assert "Fleet._obs_expand_jax" in keys and "Fleet.__init__" in keys


def test_degrade_docstring_differs_only_in_its_citation():
    ref = re.sub(r"\brepro\.", "repro_torch.", (
        REPO / "src" / "repro" / "fleet" / "degrade.py").read_text())
    port = (REPO / "src" / "repro_torch" / "fleet" / "degrade.py").read_text()
    doc = lambda text: ast.get_docstring(ast.parse(text))
    assert doc(port) == re.sub(r"\(PR \d+\)", "(``chaos.py``)", doc(ref))


# The dry run's shapes and archs, its roofline and the wire-byte rule,
# held to the JAX package's (``config/base.py``, ``configs/__init__.py``,
# ``roofline/analysis.py``).
@pytest.mark.parametrize("name", ["TRAIN_4K", "PREFILL_32K", "DECODE_32K",
                                  "LONG_500K"])
def test_copied_shapes_equal_reference(name):
    import repro_torch.config as tconfig
    assert dataclasses.asdict(getattr(tconfig, name)) == \
        dataclasses.asdict(getattr(jconfig, name))


def test_shape_tables_and_applicability_equal_reference():
    import repro.configs as jconfigs
    import repro_torch.config as tconfig
    import repro_torch.configs as tconfigs
    assert [dataclasses.asdict(x) for x in tconfig.ALL_SHAPES] == \
        [dataclasses.asdict(x) for x in jconfig.ALL_SHAPES]
    assert list(tconfig.SHAPES) == list(jconfig.SHAPES)
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    for arch in PORTED_ARCHS:
        for shape in tconfig.ALL_SHAPES:
            assert tconfig.shape_applicable(get_config(arch), shape) == \
                jconfig.shape_applicable(jconfig.get_config(arch),
                                         jconfig.SHAPES[shape.name])


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_bytes_rule_equals_parse_collectives(kind):
    """The rule the port keeps, against the original's parse of an HLO
    line of each kind over a group of 4 (a permute has no groups: 2)."""
    from repro.roofline.analysis import parse_collectives
    from repro_torch.roofline.analysis import wire_bytes
    groups = "" if kind == "collective-permute" else \
        ", replica_groups={{0,1,2,3}}"
    line = f"  %x = bf16[8,128] {kind}(bf16[8,128] %y){groups}"
    stats = parse_collectives(line)
    group = 2 if kind == "collective-permute" else 4
    assert stats.wire_bytes == {kind: wire_bytes(kind, 8 * 128 * 2, group)}


def test_roofline_with_tpu_v5e_equals_reference():
    """The same counts through both packages' ``roofline_from_artifacts``
    with the TPU spec give the same terms, field for field; ``model_flops``
    too."""
    from repro.roofline import analysis as ja
    from repro.roofline.hw import TPU_V5E as JTPU
    from repro_torch.roofline import analysis as ta
    from repro_torch.roofline.hw import H100_SXM, TPU_V5E
    wire = {"all-gather": 3.0e8, "all-reduce": 1.5e9}
    mem = {"argument_size_in_bytes": 5.0e9, "temp_size_in_bytes": 2.0e9}
    kw = dict(arch="qwen2-72b", shape="train_4k", mesh_name="pod16x16",
              step_kind="train", chips=256,
              cost={"flops": 4.2e14, "bytes accessed": 7.5e12},
              model_flops_total=6 * 72e9 * 4096 * 256, memory_analysis=mem,
              note="n")
    want = ja.roofline_from_artifacts(
        collectives=ja.CollectiveStats(wire_bytes=dict(wire)), chip=JTPU,
        **kw)
    got = ta.roofline_from_artifacts(
        collectives=ta.CollectiveStats(wire_bytes=dict(wire)), chip=TPU_V5E,
        **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ta.model_flops(1.8e9, 2048, "train") == \
        ja.model_flops(1.8e9, 2048, "train")
    assert ta.model_flops(1.8e9, 128, "decode") == \
        ja.model_flops(1.8e9, 128, "decode")
    h100 = ta.roofline_from_artifacts(
        collectives=ta.CollectiveStats(wire_bytes=dict(wire)), chip=H100_SXM,
        **kw)
    assert h100.compute_s == 4.2e14 / 989.4e12
    assert h100.collective_s == 1.8e9 / 450e9
