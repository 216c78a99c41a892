"""The port's checkpoints: the JAX package's checkpoint tests
(``tests/test_checkpoint.py``) on the port, the same keypaths as the JAX
package's for params and optimizer state, checkpoints that cross packages
both ways (bf16 params, fp32 and int8 moments), and a bitwise resume of
the port's Trainer."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_config as jget_config
from repro.config import smoke_config as jsmoke_config
from repro.models import model as jlm
from repro.training import checkpoint as jck
from repro.training import optimizer as jopt
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import PrefetchingLoader as JLoader
from repro.training.train_loop import Trainer as JTrainer
from repro_torch.config import TrainConfig, get_config, smoke_config
from repro_torch.convert import (from_jax_params, to_jax_opt_state,
                                 to_jax_params)
from repro_torch.training import checkpoint as ck
from repro_torch.training.data import DataConfig, PrefetchingLoader
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_loop import Trainer
from repro_torch.tree import tree_leaves

ARCH = "internlm2-1.8b"


def _tree(rng):
    return {
        "a": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
        "nested": {"b": torch.from_numpy(rng.integers(0, 10, 5)
                                         .astype(np.int32)),
                   "c": [torch.from_numpy(rng.standard_normal(3)
                                          .astype(np.float32))
                         .to(torch.bfloat16)]},
    }


def _leaves_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# The JAX package's tests/test_checkpoint.py, on the port.
def test_save_restore_roundtrip(tmp_path, rng):
    tree = _tree(rng)
    ck.save(str(tmp_path), 3, tree)
    _leaves_equal(ck.restore(str(tmp_path), tree), tree)


def test_latest_pointer_and_retention(tmp_path, rng):
    tree = _tree(rng)
    for step in [1, 2, 3, 4, 5]:
        ck.save(str(tmp_path), step, tree, keep=2)
    assert ck.latest_step(str(tmp_path)) == 5
    assert ck.list_steps(str(tmp_path)) == [4, 5]


def test_atomic_save_leaves_no_partial_state(tmp_path, rng):
    tree = _tree(rng)
    ck.save(str(tmp_path), 1, tree)
    # simulate a crashed writer: stale tmp dir must not confuse restore
    os.makedirs(tmp_path / ".tmp-step_00000002")
    with open(tmp_path / ".tmp-step_00000002" / "garbage", "w") as f:
        f.write("junk")
    assert ck.latest_step(str(tmp_path)) == 1
    out = ck.restore(str(tmp_path), tree)
    assert torch.equal(out["a"], tree["a"])


def test_async_save(tmp_path, rng):
    """Snapshot at the call: a leaf changed in place afterwards (as the
    trainer's update does) is saved as it was."""
    tree = _tree(rng)
    before = tree["a"].clone()
    h = ck.save_async(str(tmp_path), 7, tree)
    tree["a"].add_(1.0)
    h.wait()
    assert ck.latest_step(str(tmp_path)) == 7
    assert torch.equal(ck.restore(str(tmp_path), tree)["a"], before)


def test_missing_leaf_raises(tmp_path, rng):
    tree = _tree(rng)
    ck.save(str(tmp_path), 1, tree)
    bigger = dict(tree)
    bigger["extra"] = torch.zeros((2,))
    with pytest.raises(KeyError):
        ck.restore(str(tmp_path), bigger)


def test_restore_onto_a_device_from_a_shape_template(tmp_path, rng):
    tree = _tree(rng)
    ck.save(str(tmp_path), 1, tree)
    meta = {"a": tree["a"].to("meta"),
            "nested": {"b": tree["nested"]["b"].to("meta"),
                       "c": [tree["nested"]["c"][0].to("meta")]}}
    _leaves_equal(ck.restore(str(tmp_path), meta, device="cpu"), tree)


# ---------------------------------------------------------------------------
# Across packages.
# ---------------------------------------------------------------------------
def _cfgs():
    return jsmoke_config(jget_config(ARCH)), smoke_config(get_config(ARCH))


def _train_kw(opt_state_dtype):
    return dict(learning_rate=1e-3, warmup_steps=1, total_steps=4,
                remat="none", opt_state_dtype=opt_state_dtype)


DATA = dict(vocab_size=512, seq_len=16, global_batch=2)


@pytest.mark.parametrize("opt_state_dtype", ["fp32", "int8"])
def test_keypaths_equal_jax(opt_state_dtype, tmp_path):
    jcfg, cfg = _cfgs()
    jp = jlm.init_params(jcfg, jax.random.key(0))
    jo = jopt.init_opt_state(jp, JTrainConfig(**_train_kw(opt_state_dtype)))
    p = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    o = init_opt_state(p, TrainConfig(**_train_kw(opt_state_dtype)))
    ours = ck._flatten({"params": to_jax_params(p, cfg),
                        "opt": to_jax_opt_state(o, cfg)})
    theirs = jck._flatten({"params": jp, "opt": jo})
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)


def _jax_state_equal(params, opt_state, cfg, jparams, jopt_state):
    """The port's state, in the JAX layout, equals the JAX package's bit
    for bit."""
    ours = ck._flatten({"params": to_jax_params(params, cfg),
                        "opt": to_jax_opt_state(opt_state, cfg)})
    theirs = jck._flatten({"params": jparams, "opt": jopt_state})
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    for (key, a), (_, b) in zip(ours, theirs):
        arr, _ = ck._host(a)
        want = np.asarray(b)
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        np.testing.assert_array_equal(arr, want, err_msg=key)


@pytest.mark.parametrize("opt_state_dtype", ["fp32", "int8"])
def test_jax_checkpoint_restores_into_the_port(opt_state_dtype, tmp_path):
    """A JAX Trainer's checkpoint (bf16 params) resumes the port's
    Trainer with the same params and optimizer state, bit for bit."""
    jcfg, cfg = _cfgs()
    d = str(tmp_path / "ck")
    jh = JTrainer(jcfg, JTrainConfig(**_train_kw(opt_state_dtype)),
                  ckpt_dir=d, ckpt_every=2).run(
        JLoader(JDataConfig(**DATA)), steps=2, log_every=100)
    params, opt_state, start = Trainer(
        cfg, TrainConfig(**_train_kw(opt_state_dtype)), ckpt_dir=d,
        device="cpu").init_state()
    assert start == 2 and int(opt_state.step) == 2
    assert tree_leaves(params)[0].dtype == torch.bfloat16
    _jax_state_equal(params, opt_state, cfg, jh["params"], jh["opt_state"])


@pytest.mark.parametrize("opt_state_dtype", ["fp32", "int8"])
def test_port_checkpoint_restores_into_jax(opt_state_dtype, tmp_path):
    """The port's Trainer's checkpoint resumes the JAX package's Trainer
    with the same params and optimizer state, bit for bit."""
    jcfg, cfg = _cfgs()
    d = str(tmp_path / "ck")
    h = Trainer(cfg, TrainConfig(**_train_kw(opt_state_dtype)), ckpt_dir=d,
                ckpt_every=2, device="cpu").run(
        PrefetchingLoader(DataConfig(**DATA)), steps=2, log_every=100)
    jparams, jopt_state, start = JTrainer(
        jcfg, JTrainConfig(**_train_kw(opt_state_dtype)),
        ckpt_dir=d).init_state()
    assert start == 2 and int(jopt_state.step) == 2
    assert jax.tree.leaves(jparams)[0].dtype == jnp.bfloat16
    _jax_state_equal(h["params"], h["opt_state"], cfg, jparams, jopt_state)


@pytest.mark.parametrize("opt_state_dtype", ["fp32", "int8"])
def test_trainer_resume_bitwise(opt_state_dtype, tmp_path):
    """6 steps with a checkpoint at 3; a resumed run from 3 gives the
    unbroken run's losses and params bit for bit."""
    _, cfg = _cfgs()
    tcfg = TrainConfig(**{**_train_kw(opt_state_dtype), "total_steps": 6})
    data = DataConfig(**{**DATA, "seq_len": 32, "global_batch": 4})
    full = Trainer(cfg, tcfg, device="cpu").run(PrefetchingLoader(data),
                                                steps=6, log_every=100)
    d = str(tmp_path / "ck")
    first = Trainer(cfg, tcfg, ckpt_dir=d, ckpt_every=3, device="cpu").run(
        PrefetchingLoader(data), steps=3, log_every=100)
    resumed = Trainer(cfg, tcfg, ckpt_dir=d, ckpt_every=100,
                      device="cpu").run(PrefetchingLoader(data), steps=6,
                                        log_every=100)
    assert resumed["step"] == [3, 4, 5]
    assert first["loss"] + resumed["loss"] == full["loss"]
    _leaves_equal(resumed["params"], full["params"])
