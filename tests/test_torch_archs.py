"""The five archs the port added last (phi3-medium-14b, stablelm-12b,
internvl2-1b, musicgen-large, bert-base) at their real head layouts,
against the JAX package.

``tests/test_torch_model.py`` holds their smoke configs to
``repro.models.model``, but a smoke config shrinks every arch to 4/2 heads
of head_dim 16, which reaches none of the head layouts that are new to the
port's kernels. Each case here keeps the arch's ``num_heads``,
``num_kv_heads``, ``head_dim``, ``qkv_bias`` and ``frontend_tokens`` and
cuts ``num_layers`` to 2 and ``d_model``, ``d_ff`` and ``vocab_size`` to
small values (``d_model`` need not equal ``num_heads * head_dim``). These
are the first cases of the port to reach a group of 7 q heads a kv head
(internvl2-1b, 14/2 heads) and head_dim 160 (stablelm-12b, 32/8 heads).

Both packages run the same weights, the JAX package's ``init_params`` moved
over by ``repro_torch.convert``; logits are held at 1e-4 (fp32), as in
``tests/test_models_smoke.py``, and greedy batcher tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JServeConfig
from repro.config import get_config as jget_config
from repro.models import model as jlm
from repro.serving.batcher import ContinuousBatcher as JBatcher
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.config import ServeConfig, get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import model as lm
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.engine import ServingEngine
from repro_torch.tree import tree_leaves

TOL = 1e-4
CPU = torch.device("cpu")
ARCHS = ["phi3-medium-14b", "stablelm-12b", "internvl2-1b", "musicgen-large",
         "bert-base"]
# What each real-heads case cuts; the head layout stays the arch's own.
CUT = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=512,
           dtype="float32")


def real_heads(arch):
    """(JAX config, port config) of ``arch`` with its heads, cut to size;
    a frontend keeps its token count at the cut width."""
    jfull = jget_config(arch)
    cut = dict(CUT, frontend_dim=CUT["d_model"] if jfull.frontend_dim
               else 0)
    jcfg = jfull.replace(**cut)
    cfg = get_config(arch).replace(**cut)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def real(request):
    jcfg, cfg = real_heads(request.param)
    jparams = jlm.init_params(jcfg, jax.random.key(1))
    if cfg.qkv_bias:
        # init_params zero-initializes the qkv biases; give them values.
        rng = np.random.default_rng(7)
        for blk in jparams["blocks"]:
            for name in ("bq", "bk", "bv"):
                blk["mixer"][name] = jnp.asarray(
                    0.1 * rng.standard_normal(blk["mixer"][name].shape),
                    jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, cfg, jparams, params


def _tokens(cfg, b, s, seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _frontend(cfg, b, seed=3):
    """The prepended patch embeddings, (b, frontend_tokens, frontend_dim),
    as the JAX launcher's specs lay them out; None without a frontend."""
    if not cfg.frontend_tokens:
        return None
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)


def _batches(cfg, toks, ve):
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    if ve is not None:
        jb["vision_embeds"] = jnp.asarray(ve)
        tb["vision_embeds"] = torch.as_tensor(ve)
    return jb, tb


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=TOL, atol=TOL)


def test_real_heads_keep_the_arch_layout(real):
    _, cfg, _, params = real
    full = get_config(cfg.name)
    for f in ("num_heads", "num_kv_heads", "head_dim", "qkv_bias",
              "frontend_tokens", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(full, f)
    wq = params["layers"][0]["mixer"]["wq"]
    assert wq.shape == (cfg.d_model, full.num_heads, full.resolved_head_dim)
    if cfg.name == "internvl2-1b":
        assert cfg.num_heads // cfg.num_kv_heads == 7
    if cfg.name == "stablelm-12b":
        assert cfg.resolved_head_dim == 160


def test_real_heads_converted_params_carry_every_leaf(real):
    """Leaf by leaf: the qkv biases of internvl2-1b, the untied embedding
    and unembedding, every layer's weights."""
    jcfg, cfg, jparams, params = real
    jblock = jparams["blocks"][0]
    for i, layer in enumerate(params["layers"]):
        for part, leaves in layer.items():
            assert set(leaves) == set(jblock[part])
            for name, leaf in leaves.items():
                np.testing.assert_array_equal(
                    leaf.numpy(), np.asarray(jblock[part][name])[i])
    for name, leaf in params["embed"].items():
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(jparams["embed"][name]))
    assert ("unembed" in params["embed"]) == (not cfg.tie_embeddings)
    assert ("bq" in params["layers"][0]["mixer"]) == cfg.qkv_bias
    # One dict a layer in the port, one stacked block in the JAX tree.
    assert len(tree_leaves(params)) == len(jax.tree.leaves(jparams)) + \
        (cfg.num_layers - 1) * len(jax.tree.leaves(jblock))


def test_real_heads_forward_matches_jax(real):
    jcfg, cfg, jparams, params = real
    toks = _tokens(cfg, 2, 12)
    jb, tb = _batches(cfg, toks, _frontend(cfg, 2))
    want, _, _ = jlm.forward(jparams, jcfg, jb)
    got, _, _ = lm.forward(params, cfg, tb)
    assert got.shape == (2, 12 + cfg.frontend_tokens, cfg.vocab_size)
    _close(got.numpy(), want)


def test_real_heads_prefill_and_per_slot_decode_match_jax(real):
    """Prefill (with internvl2-1b's 256 frontend positions first), its
    caches, then per-slot decode ticks at (b,) positions, as the batcher
    runs them."""
    jcfg, cfg, jparams, params = real
    b, s = 3, 9
    ft = cfg.frontend_tokens
    max_len = ft + s + 8
    toks = _tokens(cfg, b, s + 2)
    jb, tb = _batches(cfg, toks[:, :s], _frontend(cfg, b))
    jlg, jcaches = jlm.prefill(jparams, jcfg, jb, max_len=max_len)
    lg, caches = lm.prefill(params, cfg, tb, max_len=max_len)
    _close(lg.numpy(), jlg)
    assert caches[0]["k"].shape == (b, max_len, cfg.num_kv_heads,
                                    cfg.resolved_head_dim)
    pos = np.array([ft + s, ft + s - 3, 4], np.int32)
    for t in range(2):
        new = toks[:, s + t:s + t + 1]
        jlg, jcaches = jlm.decode_step(jparams, jcfg, jnp.asarray(new),
                                       jcaches, pos=jnp.asarray(pos + t))
        lg, caches = lm.decode_step(params, cfg, torch.as_tensor(new),
                                    caches, pos=torch.as_tensor(pos + t))
        _close(lg.numpy(), jlg)


def test_real_heads_batcher_tokens_equal_jax(real):
    """Both continuous batchers, 2 slots refilled mid-run, the same
    weights: greedy tokens equal, token for token."""
    jcfg, cfg, _, _ = real
    jeng = JEngine(jcfg, JServeConfig(max_seq_len=48))
    jeng.init_random(0)
    eng = ServingEngine(cfg, ServeConfig(max_seq_len=48), device="cpu")
    eng.load(from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                             CPU))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 4)]
    bat, jbat = ContinuousBatcher(eng, slots=2), JBatcher(jeng, slots=2)
    for p in prompts:
        bat.submit(p, max_new_tokens=4)
        jbat.submit(p, max_new_tokens=4)
    tracked, jtracked = list(bat.queue), list(jbat.queue)
    bat.run_to_completion(100)
    jbat.run_to_completion(100)
    for req, jreq in zip(tracked, jtracked):
        assert req.done and len(req.generated) == 4
        assert req.generated == jreq.generated
