"""The port's training path against the JAX package's, on the CPU at
smoke size in fp32: ``loss_fn`` and every gradient leaf (remat none, full
and dots; full logits and chunked cross-entropy; a MoE model, whose aux
loss is nonzero), the ``Trainer``'s per-step losses (1 and 2
microbatches), the launcher, ``default_train_config`` and the parameter
conversion both ways.

Both packages start from the JAX package's ``init_params``, converted by
``repro_torch.convert``. Loss terms are held at 1e-5, each gradient leaf
at 1e-4 of its max-abs, the Trainer's losses at 1e-4.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_config as jget_config
from repro.config import smoke_config as jsmoke_config
from repro.launch.specs import default_train_config as jdefault_train_config
from repro.models import model as jlm
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import PrefetchingLoader as JLoader
from repro.training.train_loop import Trainer as JTrainer
from repro_torch.config import TrainConfig, get_config, smoke_config
from repro_torch.configs import PORTED_ARCHS
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.launch.specs import default_train_config
from repro_torch.models import model as lm
from repro_torch.training.data import DataConfig, PrefetchingLoader
from repro_torch.training.train_loop import Trainer, make_train_step
from repro_torch.training.optimizer import init_opt_state
from repro_torch.tree import tree_leaves, tree_unflatten

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
TRAINER_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(arch):
    jcfg = jsmoke_config(jget_config(arch)).replace(dtype="float32")
    cfg = smoke_config(get_config(arch)).replace(dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _pair(arch):
    jcfg, cfg = _cfgs(arch)
    jparams = jlm.init_params(jcfg, jax.random.key(1))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def dense_pair():
    return _pair("internlm2-1.8b")


@pytest.fixture(scope="module")
def moe_pair():
    return _pair("granite-moe-1b-a400m")


@pytest.fixture(scope="module")
def mamba_pair():
    return _pair("mamba2-130m")


@pytest.fixture(scope="module", params=["internlm2-1.8b",
                                        "granite-moe-1b-a400m",
                                        "mamba2-130m"])
def model_pair(request, dense_pair, moe_pair, mamba_pair):
    return {"internlm2-1.8b": dense_pair, "granite-moe-1b-a400m": moe_pair,
            "mamba2-130m": mamba_pair}[request.param]


def _batch(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.85).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _port_loss_and_grads(params, cfg, batch, **kw):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    loss, metrics = lm.loss_fn(p, cfg, {k: torch.from_numpy(v)
                                        for k, v in batch.items()}, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, tree_unflatten(params, list(grads))


def _check_loss_and_grads(pair, remat, loss_chunk):
    jcfg, cfg, jparams, params = pair
    batch = _batch(cfg)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, batch, remat=remat,
                              loss_chunk=loss_chunk), has_aux=True)(jparams)
    loss, m, grads = _port_loss_and_grads(params, cfg, batch, remat=remat,
                                          loss_chunk=loss_chunk)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for key in ("ce", "aux", "z_loss", "tokens"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), to_jax_params(grads, cfg)))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (path, err)
    return m


@pytest.mark.parametrize("remat,loss_chunk", [
    ("none", 0), ("full", 0), ("dots", 0), ("none", 10), ("full", 10),
    ("dots", 7)])
def test_loss_and_grads_match_jax(dense_pair, remat, loss_chunk):
    _check_loss_and_grads(dense_pair, remat, loss_chunk)


@pytest.mark.parametrize("remat,loss_chunk", [("none", 0), ("full", 10)])
def test_moe_loss_and_grads_match_jax(moe_pair, remat, loss_chunk):
    """granite-moe at smoke size: the aux loss is nonzero and its gradient
    reaches the router."""
    m = _check_loss_and_grads(moe_pair, remat, loss_chunk)
    assert m["aux"].item() > 0


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_mamba2_loss_and_grads_match_jax(mamba_pair, remat):
    """mamba2 at smoke size: every SSD layer's gradient through
    ``SSDScanFunction`` (on the CPU its closed-form backward) reaches x, dt,
    B, C and through them the projections, A_log through -exp, dt_bias
    through softplus, and D."""
    _check_loss_and_grads(mamba_pair, remat, 0)
    _, cfg, _, params = mamba_pair
    _, _, grads = _port_loss_and_grads(params, cfg, _batch(cfg), remat=remat)
    for layer in grads["layers"]:
        for name in ("A_log", "dt_bias", "D"):
            assert layer["mixer"][name].abs().max() > 0, name


def test_remat_modes_give_the_same_gradients(model_pair):
    _, cfg, _, params = model_pair
    batch = _batch(cfg, seed=3)
    runs = [_port_loss_and_grads(params, cfg, batch, remat=r)
            for r in ("none", "full", "dots")]
    for loss, _, grads in runs[1:]:
        assert loss.item() == runs[0][0].item()
        for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][2])):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_param_conversion_round_trips(model_pair):
    jcfg, cfg, jparams, params = model_pair
    back = to_jax_params(params, cfg)
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), back))
    for a, b in zip(got, jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("mb", [1, 2])
def test_trainer_losses_match_jax(mb):
    jcfg, cfg = _cfgs("internlm2-1.8b")
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=5,
              remat="none", microbatches=mb)
    dkw = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    jhist = JTrainer(jcfg, JTrainConfig(**kw)).run(JLoader(JDataConfig(**dkw)),
                                                   steps=5, log_every=100)
    # The JAX Trainer draws its params from key(0): start from the same.
    p0 = from_jax_params(jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.key(0))), cfg, "cpu")
    hist = Trainer(cfg, TrainConfig(**kw), device="cpu").run(
        PrefetchingLoader(DataConfig(**dkw)), steps=5, log_every=100,
        params=p0)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=TRAINER_TOL,
                               atol=TRAINER_TOL)
    np.testing.assert_allclose(hist["ce"], jhist["ce"], rtol=TRAINER_TOL,
                               atol=TRAINER_TOL)
    assert hist["step"] == jhist["step"] == list(range(5))


def test_mamba2_trainer_losses_match_jax():
    jcfg, cfg = _cfgs("mamba2-130m")
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=4,
              remat="full", microbatches=1)
    dkw = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    jhist = JTrainer(jcfg, JTrainConfig(**kw)).run(JLoader(JDataConfig(**dkw)),
                                                   steps=4, log_every=100)
    p0 = from_jax_params(jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.key(0))), cfg, "cpu")
    hist = Trainer(cfg, TrainConfig(**kw), device="cpu").run(
        PrefetchingLoader(DataConfig(**dkw)), steps=4, log_every=100,
        params=p0)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=TRAINER_TOL,
                               atol=TRAINER_TOL)
    np.testing.assert_allclose(hist["ce"], jhist["ce"], rtol=TRAINER_TOL,
                               atol=TRAINER_TOL)
    assert hist["loss"][-1] < hist["loss"][0]


def test_microbatch_step_sums_grads_in_fp32():
    """Two microbatches of the same rows give one batch's update: the
    accumulated gradient is the fp32 mean of the two."""
    _, cfg = _cfgs("internlm2-1.8b")
    tcfg = TrainConfig(remat="none", learning_rate=1e-3, warmup_steps=1)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    b = _batch(cfg, b=2, s=16)
    half = {k: v[:1] for k, v in b.items()}
    twice = {k: torch.from_numpy(np.concatenate([v, v]))
             for k, v in half.items()}
    outs = []
    for mb, batch in ((1, {k: torch.from_numpy(v) for k, v in half.items()}),
                      (2, twice)):
        p = tree_unflatten(params, [t.clone() for t in tree_leaves(params)])
        step = make_train_step(cfg, dataclasses.replace(tcfg, microbatches=mb))
        outs.append(step(p, init_opt_state(p, tcfg), batch))
    for a, c in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(outs[0][2]["loss"], outs[1][2]["loss"])


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_default_train_config_matches_jax(arch):
    for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                      (smoke_config(get_config(arch)),
                       jsmoke_config(jget_config(arch)))):
        assert dataclasses.asdict(default_train_config(cfg)) == \
            dataclasses.asdict(jdefault_train_config(jcfg))


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, TrainConfig())


def test_launcher_prints_the_jax_launchers_keys():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "internlm2-1.8b", "--smoke", "--device", "cpu", "--steps", "3",
         "--seq-len", "32", "--batch", "4"],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stderr
    rep = json.loads(r.stdout)
    jax_keys = {"arch", "steps", "first_loss", "last_loss", "mean_step_s",
                "hedged_batches"}
    assert set(rep) == jax_keys | {"device", "kernel_launches"}
    assert rep["steps"] == 3 and rep["device"] == "cpu"
    assert np.isfinite([rep["first_loss"], rep["last_loss"]]).all()
    assert set(rep["kernel_launches"].values()) == {0}


def test_launcher_trains_mamba2():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-130m", "--smoke", "--device", "cpu", "--steps", "3",
         "--seq-len", "32", "--batch", "4"],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stderr
    rep = json.loads(r.stdout)
    assert rep["arch"] == "mamba2-130m" and rep["steps"] == 3
    assert rep["device"] == "cpu"
    assert np.isfinite([rep["first_loss"], rep["last_loss"]]).all()
    assert set(rep["kernel_launches"].values()) == {0}
    assert "ssd_scan_bwd" in rep["kernel_launches"]
