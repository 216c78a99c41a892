"""The port stands alone: no JAX and nothing of ``repro`` in
``src/repro_torch/``, ``chip_smoke.py`` or the port's measurement tools
``tools/train_step_ab.py`` and ``tools/attention_ab.py``; its copied
configs equal the JAX package's, and so does every definition of its
copies of the numpy layer; its entry points refuse a missing card instead
of running on the CPU."""
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
    REPO / "tools" / "attention_ab.py"]


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
    """One CUDA source for each of the JAX package's five Pallas kernels
    (the name dates from the first slice, which had three)."""
    csrc = REPO / "src" / "repro_torch" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "rmsnorm.cu", "flash_attention.cu", "decode_attention.cu",
        "ssd_scan.cu", "int8_matmul.cu"}
    pallas = {p.stem for p in (REPO / "src" / "repro" / "kernels").glob(
        "*.py") if "pl.pallas_call" in p.read_text()}
    assert {p.stem for p in csrc.glob("*.cu")} == pallas


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


# The numpy layer the port copies (paths under src/repro and
# src/repro_torch): each copy is the original with ``repro.`` rewritten to
# ``repro_torch.``.
COPIED = ["core/cluster.py", "core/scheduler.py", "power/__init__.py",
          "power/opp.py", "power/thermal.py", "power/governor.py",
          "runtime/__init__.py", "runtime/result.py", "runtime/sanitize.py",
          "runtime/pool.py", "runtime/policy.py", "runtime/workload.py",
          "runtime/multi_tenant.py", "runtime/cluster_runtime.py",
          "workloads/dlserving.py", "training/data.py"]
# Top-level statements a copy may add or change, by (module, key).
EXEMPT = {
    # pool.py types its obs ledger under TYPE_CHECKING with an import from
    # repro.obs, which the port does not have; the annotation stays a
    # string and the block and its typing name go.
    ("runtime/pool.py", "if TYPE_CHECKING"),
    ("runtime/pool.py", "import typing"),
    # The port's H100 spec and its share count, which the original lacks.
    ("core/cluster.py", "H100_SHARES"),
    ("core/cluster.py", "h100_sxm"),
    # The data pipeline places batches on one device as tensors: torch in
    # place of jax, and place_on_device in place of place_on_mesh (the
    # mesh waits for the distributed slice).
    ("training/data.py", "import jax"),
    ("training/data.py", "import torch"),
    ("training/data.py", "place_on_mesh"),
    ("training/data.py", "place_on_device"),
}


def _statements(path: pathlib.Path, rewrite: bool):
    """(key, ast.dump) of each top-level statement of a module."""
    text = path.read_text()
    if rewrite:
        text = re.sub(r"\brepro\.", "repro_torch.", text)
    out = []
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            key = node.name
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            key = ",".join(ast.unparse(t) for t in targets)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            key = "import " + (getattr(node, "module", None) or ",".join(
                a.name for a in node.names))
        elif isinstance(node, ast.If):
            key = "if " + ast.unparse(node.test)
        elif isinstance(node, ast.Expr) and isinstance(node.value,
                                                       ast.Constant):
            key = "__doc__"
        else:
            key = ast.unparse(node)
        out.append((key, ast.dump(node)))
    return out


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_reference(rel):
    """Every function, class, import, assignment and docstring of the
    original has its twin in the port's copy, identical once ``repro.``
    reads ``repro_torch.``; only the exemptions above differ."""
    keep = lambda stmts: [(k, d) for k, d in stmts
                          if (rel, k) not in EXEMPT]
    ref = keep(_statements(REPO / "src" / "repro" / rel, rewrite=True))
    port = keep(_statements(REPO / "src" / "repro_torch" / rel,
                            rewrite=False))
    assert [k for k, _ in port] == [k for k, _ in ref]
    for (key, want), (_, got) in zip(ref, port):
        assert got == want, f"{rel}: {key} differs from the original"


def test_h100_spec_says_what_is_assumed():
    from repro_torch.core.cluster import h100_sxm
    doc = " ".join(h100_sxm.__doc__.split())
    assert "``p_idle`` and ``gamma`` are assumed, not measured" in doc
