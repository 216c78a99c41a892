"""The port stands alone: no JAX and nothing of ``repro`` in
``src/repro_torch/`` or ``chip_smoke.py``; its copied configs equal the
JAX package's; its entry points refuse a missing card instead of running
on the CPU."""
import ast
import dataclasses
import pathlib

import pytest
import torch

import repro.config as jconfig
from repro_torch.config import get_config, smoke_config
from repro_torch.launch.serve import serve
from repro_torch.serving.engine import ServingEngine

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


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


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-130m",
                                  "qwen2-72b"])
def test_copied_configs_equal_reference(arch):
    ours, ref = get_config(arch), jconfig.get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(smoke_config(ours)) == \
        dataclasses.asdict(jconfig.smoke_config(ref))


def test_serve_config_equals_reference():
    from repro_torch.config import ServeConfig
    assert dataclasses.asdict(ServeConfig()) == \
        dataclasses.asdict(jconfig.ServeConfig())


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config(get_config("internlm2-1.8b"))
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve(cfg, [4], max_new_tokens=2)
