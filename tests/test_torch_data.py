"""The port's copy of the data pipeline (``repro_torch/training/data.py``)
against the JAX package's: ``_gen_batch`` bit for bit, and the JAX
package's own determinism, label-shift and straggler-hedge tests
(``tests/test_data_fault.py``) on the port."""
import numpy as np
import pytest
import torch

from repro.config import SHAPES as JSHAPES
from repro.config import get_config as jget_config
from repro.training import data as jdata
from repro_torch.config import ShapeSpec, get_config
from repro_torch.configs import PORTED_ARCHS
from repro_torch.training.data import (DataConfig, PrefetchingLoader,
                                       _gen_batch, data_config_for,
                                       place_on_device)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("frontend", [0, 8])
def test_gen_batch_equals_jax_bit_for_bit(seed, frontend):
    kw = dict(vocab_size=92544, seq_len=40, global_batch=3, seed=seed,
              frontend_tokens=frontend, frontend_dim=16 if frontend else 0)
    for step in (0, 1, 5, 1000):
        ours = _gen_batch(DataConfig(**kw), step)
        theirs = jdata._gen_batch(jdata.DataConfig(**kw), step)
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_data_config_for_equals_jax(arch):
    js = JSHAPES["train_4k"]
    shape = ShapeSpec(js.name, js.seq_len, js.global_batch, js.kind)
    ours = data_config_for(get_config(arch), shape, seed=3)
    theirs = jdata.data_config_for(jget_config(arch), js, seed=3)
    assert vars(ours) == vars(theirs)


def test_place_on_device_gives_tensors():
    b = _gen_batch(DataConfig(vocab_size=100, seq_len=8, global_batch=2), 0)
    placed = place_on_device("cpu")(b)
    for k, v in placed.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), b[k])


# The JAX package's tests/test_data_fault.py (data part), on the port.
def test_batches_deterministic():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=3)
    b1 = _gen_batch(cfg, 7)
    b2 = _gen_batch(cfg, 7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = _gen_batch(cfg, 8)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_labels_are_shifted_tokens():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=2)
    b = _gen_batch(cfg, 0)
    assert b["tokens"].shape == (2, 16)
    assert b["labels"].shape == (2, 16)
    # label[t] is the next token in the underlying sequence; the first 15
    # labels equal tokens shifted by one
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_straggler_hedge_is_bit_identical():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=1)
    slow = PrefetchingLoader(
        cfg, fetch_deadline_s=0.05,
        delay_injector=lambda step: 0.5 if step == 2 else 0.0)
    fast = PrefetchingLoader(cfg)
    for step in range(4):
        b_slow = slow.get(step)
        b_fast = fast.get(step)
        np.testing.assert_array_equal(b_slow["tokens"], b_fast["tokens"])
    assert slow.hedge_count >= 1
