"""The port's example twins (``examples/torch_{quickstart,serve_lm,
train_lm}.py``) run end to end on the CPU (``--device cpu``) at their
smallest arguments and print the reference examples' lines."""
import importlib.util
import json
import pathlib
import re

import pytest
import torch

from repro_torch.config import get_config, smoke_config

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_quickstart_trains_then_serves(in_tmp, capsys):
    out = _example("quickstart").main(["--device", "cpu", "--steps", "3"])
    lines = _lines(capsys)
    full = get_config("internlm2-1.8b")
    cfg = smoke_config(full)
    assert lines[0] == (f"arch=internlm2-1.8b family={cfg.family} "
                        f"full-size={full.num_params/1e9:.2f}B "
                        f"(smoke: {cfg.num_params/1e6:.1f}M)")
    assert len(out["loss"]) == 3
    assert lines[1] == (f"loss: {out['loss'][0]:.3f} -> "
                        f"{out['loss'][-1]:.3f} over 3 steps")
    assert lines[2] == f"generated token ids: {out['tokens']}"
    assert len(out["tokens"]) == 8
    assert all(0 <= t < cfg.vocab_size for t in out["tokens"])


def test_serve_lm_serves_every_request(in_tmp, capsys):
    tel = _example("serve_lm").main(["--device", "cpu", "--requests", "2"])
    lines = _lines(capsys)
    assert lines[0] == "2 requests x 12 tokens on 3 slots (bf16 weights)"
    m = re.fullmatch(r"24 tokens in [0-9.]+s \([0-9.]+ tok/s, (\d+) engine "
                     r"ticks, mean active units ([0-9.]+)\)", lines[1])
    assert m and int(m.group(1)) == tel.ticks
    assert tel.served == 2
    assert [ln.split(":")[0] for ln in lines[2:]] == ["  req 0", "  req 1"]
    assert all(len(r.output) == 12 for r in tel.responses)


def test_train_lm_writes_its_history_and_checkpoint(in_tmp, capsys):
    ckpt_dir = in_tmp / "ckpt"
    out = _example("train_lm").main(
        ["--device", "cpu", "--steps", "3", "--seq-len", "32", "--batch",
         "2", "--ckpt-dir", str(ckpt_dir)])
    lines = _lines(capsys)
    assert lines[0] == f"model: {out['params_m']:.1f}M params (reduced width)"
    assert lines[-1] == (f"loss {out['loss'][0]:.3f} -> "
                         f"{out['loss'][-1]:.3f}; history -> "
                         "results/train_lm_history_torch.json")
    hist = json.loads((in_tmp / "results" /
                       "train_lm_history_torch.json").read_text())
    assert hist == out
    assert hist["arch"] == "mamba2-130m(reduced)"
    assert hist["steps"] == [0, 1, 2]
    assert (ckpt_dir / "step_00000003").is_dir()


@pytest.mark.parametrize("name, argv", [
    ("quickstart", ["--steps", "1"]),
    ("serve_lm", []),
    ("train_lm", ["--steps", "1", "--ckpt-dir", "ckpt"])])
def test_example_refuses_a_missing_card(name, argv, in_tmp, monkeypatch):
    """``--device`` defaults to ``cuda``, which raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        _example(name).main(argv)
