"""The port's dense, SSM and hybrid models, engine and batcher against the
JAX package's.

Both packages run the same weights: the JAX package's ``init_params``
pytree, moved over as numpy arrays by ``repro_torch.convert``. Logits are
held at the tolerance of ``tests/test_models_smoke.py`` (1e-4, fp32);
greedy tokens must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JServeConfig
from repro.config import get_config as jget_config
from repro.config import smoke_config as jsmoke_config
from repro.models import model as jlm
from repro.serving.batcher import ContinuousBatcher as JBatcher
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.config import (MambaConfig, ModelConfig, MoEConfig,
                                ServeConfig, get_config, smoke_config)
from repro_torch.convert import from_jax_params
from repro_torch.models import model as lm
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.engine import (ServingEngine, dequantize_params,
                                        quantize_params_int8)
from repro_torch.tree import tree_map

TOL = 1e-4   # tests/test_models_smoke.py::test_decode_matches_forward_fp32
CPU = torch.device("cpu")
ARCHS = ["internlm2-1.8b", "qwen2-72b", "phi3-medium-14b", "stablelm-12b",
         "internvl2-1b", "musicgen-large", "bert-base"]


def _cfgs(arch):
    jcfg = jsmoke_config(jget_config(arch)).replace(dtype="float32")
    cfg = smoke_config(get_config(arch)).replace(dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _params(jcfg, cfg, seed=1, bias_seed=None):
    jparams = jlm.init_params(jcfg, jax.random.key(seed))
    if bias_seed is not None:
        # init_params zero-initializes the qkv biases; give them values so
        # that the bias path is exercised.
        rng = np.random.default_rng(bias_seed)
        for blk in jparams["blocks"]:
            for name in ("bq", "bk", "bv"):
                blk["mixer"][name] = jnp.asarray(
                    0.1 * rng.standard_normal(blk["mixer"][name].shape),
                    jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, from_jax_params(tree, cfg, CPU)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg, cfg = _cfgs(request.param)
    bias = 7 if cfg.qkv_bias else None
    jparams, params = _params(jcfg, cfg, bias_seed=bias)
    return jcfg, cfg, jparams, params


def _tokens(cfg, b, s, seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=TOL, atol=TOL)


def test_converted_params_match_jax_leaves(pair):
    jcfg, cfg, jparams, params = pair
    assert len(params["layers"]) == cfg.num_layers
    wq = np.asarray(jparams["blocks"][0]["mixer"]["wq"])
    for i, layer in enumerate(params["layers"]):
        np.testing.assert_array_equal(layer["mixer"]["wq"].numpy(), wq[i])
    if cfg.qkv_bias:
        assert "bq" in params["layers"][0]["mixer"]


def test_forward_matches_jax(pair):
    jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg, 2, 12)
    want, _, _ = jlm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, caches, _ = lm.forward(params, cfg,
                                {"tokens": torch.as_tensor(toks)})
    assert caches is None
    _close(got.numpy(), want)


def test_vision_embeds_prepend_matches_jax(pair):
    jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg, 2, 6)
    ve = np.random.default_rng(3).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)
    want, _, _ = jlm.forward(jparams, jcfg, {
        "tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(ve)})
    got, _, _ = lm.forward(params, cfg, {
        "tokens": torch.as_tensor(toks), "vision_embeds": torch.as_tensor(ve)})
    assert got.shape == (2, 9, cfg.vocab_size)
    _close(got.numpy(), want)


def test_prefill_and_scalar_pos_decode_match_jax(pair):
    jcfg, cfg, jparams, params = pair
    b, s, max_len = 2, 10, 24
    toks = _tokens(cfg, b, s + 3)
    jlg, jcaches = jlm.prefill(jparams, jcfg,
                               {"tokens": jnp.asarray(toks[:, :s])},
                               max_len=max_len)
    lg, caches = lm.prefill(params, cfg,
                            {"tokens": torch.as_tensor(toks[:, :s])},
                            max_len=max_len)
    _close(lg.numpy(), jlg)
    assert caches[0]["k"].shape == (b, max_len, cfg.num_kv_heads,
                                    cfg.resolved_head_dim)
    for t in range(3):
        jlg, jcaches = jlm.decode_step(
            jparams, jcfg, jnp.asarray(toks[:, s + t:s + t + 1]), jcaches,
            pos=s + t)
        lg, caches = lm.decode_step(
            params, cfg, torch.as_tensor(toks[:, s + t:s + t + 1]), caches,
            pos=s + t)
        _close(lg.numpy(), jlg)


def test_per_slot_decode_matches_jax(pair):
    """(b,) positions: per-slot RoPE and cache scatter, as the batcher."""
    jcfg, cfg, jparams, params = pair
    b, s, max_len = 3, 9, 20
    toks = _tokens(cfg, b, s + 2)
    _, jcaches = jlm.prefill(jparams, jcfg,
                             {"tokens": jnp.asarray(toks[:, :s])},
                             max_len=max_len)
    _, caches = lm.prefill(params, cfg,
                           {"tokens": torch.as_tensor(toks[:, :s])},
                           max_len=max_len)
    pos = np.array([s, s - 3, 4], np.int32)
    for t in range(2):
        new = toks[:, s + t:s + t + 1]
        jlg, jcaches = jlm.decode_step(jparams, jcfg, jnp.asarray(new),
                                       jcaches, pos=jnp.asarray(pos + t))
        lg, caches = lm.decode_step(params, cfg, torch.as_tensor(new),
                                    caches, pos=torch.as_tensor(pos + t))
        _close(lg.numpy(), jlg)


def test_decode_matches_forward():
    """prefill(s) + decode(1) equals the full forward at position s."""
    _, cfg = _cfgs("internlm2-1.8b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.as_tensor(_tokens(cfg, 2, 17))
    full, _, _ = lm.forward(params, cfg, {"tokens": toks})
    lg_pre, caches = lm.prefill(params, cfg, {"tokens": toks[:, :16]},
                                max_len=24)
    lg_dec, _ = lm.decode_step(params, cfg, toks[:, 16:], caches, pos=16)
    _close(lg_pre.numpy(), full[:, 15].numpy())
    _close(lg_dec.numpy(), full[:, 16].numpy())


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    jcfg, cfg = _cfgs("internlm2-1.8b")
    jeng = JEngine(jcfg, JServeConfig(max_seq_len=64))
    jeng.init_random(0)
    eng = ServingEngine(cfg, ServeConfig(max_seq_len=64), device="cpu")
    eng.load(from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                             CPU))
    return jeng, eng


def test_generate_tokens_equal_jax(engines):
    jeng, eng = engines
    toks = _tokens(eng.cfg, 2, 8, seed=5)
    want = np.asarray(jeng.generate(jnp.asarray(toks), 6))
    got = eng.generate(torch.as_tensor(toks), 6)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_needs_generator(engines):
    _, eng = engines
    toks = torch.as_tensor(_tokens(eng.cfg, 1, 4))
    with pytest.raises(ValueError):
        eng.generate(toks, 2, greedy=False)
    a = eng.generate(toks, 4, greedy=False,
                     generator=torch.Generator().manual_seed(3))
    b = eng.generate(toks, 4, greedy=False,
                     generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_batcher_tokens_equal_generate_and_jax(engines):
    jeng, eng = engines
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 4, 7, 5)]
    bat = ContinuousBatcher(eng, slots=2)
    jbat = JBatcher(jeng, slots=2)
    for p in prompts:
        bat.submit(p, max_new_tokens=5)
        jbat.submit(p, max_new_tokens=5)
    tracked, jtracked = list(bat.queue), list(jbat.queue)
    bat.run_to_completion(100)
    jbat.run_to_completion(100)
    for req, jreq, p in zip(tracked, jtracked, prompts):
        ref = eng.generate(torch.as_tensor(p[None]), 5)[0].tolist()
        assert req.done and req.generated == ref
        assert req.generated == jreq.generated


def test_batcher_respects_max_slots(engines):
    _, eng = engines
    bat = ContinuousBatcher(eng, slots=3)
    for n in (4, 5, 6):
        bat.submit(np.arange(n, dtype=np.int32), max_new_tokens=3)
    assert bat.step(max_slots=1) == 1
    assert bat.step(max_slots=2) == 2


def test_int8_weight_serving_close_to_fp(engines):
    _, eng = engines
    cfg = eng.cfg
    qp = quantize_params_int8(eng.params)
    assert "__int8__" in qp["layers"][0]["mixer"]["wq"]
    dq = dequantize_params(qp)
    assert dq["layers"][0]["mixer"]["wq"].dtype == torch.bfloat16
    dq32 = tree_map(lambda t: t.float(), dq)
    toks = {"tokens": torch.ones((1, 8), dtype=torch.long)}
    lg_fp, _, _ = lm.forward(eng.params, cfg, toks)
    lg_q, _, _ = lm.forward(dq32, cfg, toks)
    corr = np.corrcoef(lg_fp.numpy().ravel(), lg_q.numpy().ravel())[0, 1]
    assert corr > 0.99


def test_int8_engine_serves(engines):
    _, eng = engines
    qeng = ServingEngine(eng.cfg, ServeConfig(max_seq_len=32,
                                              quantize_weights=True),
                         device="cpu")
    qeng.load(eng.params)
    out = qeng.generate(torch.ones((1, 5), dtype=torch.long), 3)
    assert out.shape == (1, 3)


def test_launcher_serves_every_request():
    from repro_torch.launch.serve import serve
    _, cfg = _cfgs("internlm2-1.8b")
    rep = serve(cfg, [5, 11, 7], max_new_tokens=4, slots=2, device="cpu")
    assert rep["served"] == 3 and rep["tokens_generated"] == 12
    assert rep["kernel_launches"] == {"rmsnorm": 0, "rmsnorm_bwd": 0,
                                      "flash_attention": 0,
                                      "flash_attention_bwd": 0,
                                      "decode_attention": 0, "ssd_scan": 0,
                                      "ssd_scan_bwd": 0, "int8_matmul": 0}


def _port_cfg(jcfg):
    """The port's ModelConfig with every field of a JAX package config."""
    d = dataclasses.asdict(jcfg)
    d["moe"] = MoEConfig(**d["moe"]) if d["moe"] else None
    d["mamba"] = MambaConfig(**d["mamba"]) if d["mamba"] else None
    return ModelConfig(**d)


# ---------------------------------------------------------------------------
# SSM (mamba2-130m) and hybrid stacks
# ---------------------------------------------------------------------------
def _hybrid_cfgs():
    """jamba's smoke config without MoE: layers (mamba, mamba, mamba,
    attn), each with a dense FFN."""
    jcfg = jsmoke_config(jget_config("jamba-1.5-large-398b")).replace(
        moe=None, dtype="float32")
    return jcfg, _port_cfg(jcfg)


@pytest.fixture(scope="module", params=["mamba2-130m", "hybrid"])
def ssm_pair(request):
    if request.param == "hybrid":
        jcfg, cfg = _hybrid_cfgs()
    else:
        jcfg, cfg = _cfgs(request.param)
    jparams, params = _params(jcfg, cfg, seed=3)
    return jcfg, cfg, jparams, params


def test_ssm_converted_params_carry_every_leaf(ssm_pair):
    jcfg, cfg, jparams, params = ssm_pair
    kinds = cfg.layer_kinds()
    assert "mamba" in kinds
    period = len(jparams["blocks"])     # 1 for mamba2, 4 for the hybrid
    for i, layer in enumerate(params["layers"]):
        block = jparams["blocks"][i % period]
        for name, leaf in layer["mixer"].items():
            want = np.asarray(block["mixer"][name])[i // period]
            assert str(leaf.dtype) == f"torch.{want.dtype}"
            np.testing.assert_array_equal(leaf.numpy(), want)
        if kinds[i] == "mamba":
            assert set(layer["mixer"]) == {"w_in", "conv_w", "conv_b",
                                           "A_log", "dt_bias", "D",
                                           "norm_scale", "w_out"}
        assert ("ffn" in layer) == bool(cfg.d_ff)


def test_ssm_forward_matches_jax(ssm_pair):
    jcfg, cfg, jparams, params = ssm_pair
    toks = _tokens(cfg, 2, 64)          # two chunks of 32: state carried
    want, _, _ = jlm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, _, _ = lm.forward(params, cfg, {"tokens": torch.as_tensor(toks)})
    _close(got.numpy(), want)


@pytest.mark.parametrize("s", [2, 11, 32])
def test_ssm_prefill_and_per_slot_decode_match_jax(ssm_pair, s):
    """Prefill (s = 2 is shorter than d_conv - 1, so the conv cache is
    left-padded), its caches, then per-slot decode ticks."""
    jcfg, cfg, jparams, params = ssm_pair
    b, max_len = 2, 40
    toks = _tokens(cfg, b, s + 3, seed=4)
    jlg, jcaches = jlm.prefill(jparams, jcfg,
                               {"tokens": jnp.asarray(toks[:, :s])},
                               max_len=max_len)
    lg, caches = lm.prefill(params, cfg,
                            {"tokens": torch.as_tensor(toks[:, :s])},
                            max_len=max_len)
    _close(lg.numpy(), jlg)
    period = len(jparams["blocks"])
    for i, c in enumerate(caches):
        for name, leaf in c.items():
            _close(leaf.numpy(),
                   np.asarray(jcaches[i % period][name])[i // period])
    pos = np.array([s, s], np.int32)
    for t in range(3):
        new = toks[:, s + t:s + t + 1]
        jlg, jcaches = jlm.decode_step(jparams, jcfg, jnp.asarray(new),
                                       jcaches, pos=jnp.asarray(pos + t))
        lg, caches = lm.decode_step(params, cfg, torch.as_tensor(new),
                                    caches, pos=torch.as_tensor(pos + t))
        _close(lg.numpy(), jlg)


def test_mamba_decode_matches_forward():
    """prefill(s) + decode ticks equal the full forward at those steps."""
    _, cfg = _cfgs("mamba2-130m")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.as_tensor(_tokens(cfg, 2, 35))
    full, _, _ = lm.forward(params, cfg, {"tokens": toks[:, :32]})
    lg_pre, caches = lm.prefill(params, cfg, {"tokens": toks[:, :30]})
    _close(lg_pre.numpy(), full[:, 29].numpy())
    for t in (30, 31):
        lg, caches = lm.decode_step(params, cfg, toks[:, t:t + 1], caches,
                                    pos=t)
        _close(lg.numpy(), full[:, t].numpy())


@pytest.fixture(scope="module")
def mamba_engines():
    jcfg, cfg = _cfgs("mamba2-130m")
    jeng = JEngine(jcfg, JServeConfig(max_seq_len=80))
    jeng.init_random(0)
    eng = ServingEngine(cfg, ServeConfig(max_seq_len=80), device="cpu")
    eng.load(from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                             CPU))
    return jeng, eng


def test_mamba_batcher_tokens_equal_jax(mamba_engines):
    """Prompts of 5, 11, 32 and 64 tokens (<= chunk 32 or a multiple of
    it) through both batchers at 2 slots: slots are refilled mid-run, so
    the conv/ssd leaves of each slot must be copied in and carried."""
    jeng, eng = mamba_engines
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32)
               for n in (5, 11, 32, 64)]
    bat = ContinuousBatcher(eng, slots=2)
    jbat = JBatcher(jeng, slots=2)
    for p in prompts:
        bat.submit(p, max_new_tokens=3)
        jbat.submit(p, max_new_tokens=3)
    tracked, jtracked = list(bat.queue), list(jbat.queue)
    bat.run_to_completion(100)
    jbat.run_to_completion(100)
    for req, jreq in zip(tracked, jtracked):
        assert req.done and len(req.generated) == 3
        assert req.generated == jreq.generated


def test_mamba_batcher_equals_generate(mamba_engines):
    _, eng = mamba_engines
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32)
               for n in (7, 3, 32)]
    bat = ContinuousBatcher(eng, slots=2)
    for p in prompts:
        bat.submit(p, max_new_tokens=4)
    tracked = list(bat.queue)
    bat.run_to_completion(100)
    for req, p in zip(tracked, prompts):
        ref = eng.generate(torch.as_tensor(p[None]), 4)[0].tolist()
        assert req.generated == ref


def test_mamba_int8_weight_serving_close_to_fp(mamba_engines):
    _, eng = mamba_engines
    cfg = eng.cfg
    qp = quantize_params_int8(eng.params)
    mixer = qp["layers"][0]["mixer"]
    for name in ("w_in", "conv_w", "w_out"):
        assert "__int8__" in mixer[name]
    for name in ("conv_b", "A_log", "dt_bias", "D", "norm_scale"):
        assert isinstance(mixer[name], torch.Tensor)
    dq32 = tree_map(lambda t: t.float(), dequantize_params(qp))
    toks = {"tokens": torch.as_tensor(_tokens(cfg, 1, 16))}
    lg_fp, _, _ = lm.forward(eng.params, cfg, toks)
    lg_q, _, _ = lm.forward(dq32, cfg, toks)
    corr = np.corrcoef(lg_fp.numpy().ravel(), lg_q.numpy().ravel())[0, 1]
    assert corr > 0.99
    qeng = ServingEngine(cfg, ServeConfig(max_seq_len=32,
                                          quantize_weights=True),
                         device="cpu")
    qeng.load(eng.params)
    assert qeng.generate(toks["tokens"], 3).shape == (1, 3)


@pytest.mark.parametrize("per_layer", [False, True],
                         ids=["served-init", "per-layer-1d-leaves"])
def test_mamba_int8_logits_against_jax_int8(mamba_engines, per_layer):
    """Weight-only int8 prefill logits (bf16), port against the JAX engine.

    The JAX engine quantizes its layer-stacked tree, so the per-layer 1-D
    leaves (``A_log``, ``dt_bias``, ``D``, ``conv_b``, ``norm_scale``) are
    quantized across the layer axis and come back in bf16; the port keeps
    them exact. With the engines' own init those leaves are equal in every
    layer, so the JAX quantization is exact too: observed gap 0. With
    leaves that differ by layer (seeded noise) the observed gap is 0.0063
    at a logit scale of 0.6, greedy tokens equal. Bound: 2^-6, four bf16
    ulps at that scale, a third of int8's own effect on these logits
    (0.018 against fp)."""
    jeng, _ = mamba_engines
    jcfg, cfg = jeng.cfg, mamba_engines[1].cfg
    raw = jax.tree.map(np.asarray, jeng.params)
    if per_layer:
        rng = np.random.default_rng(5)
        mixer = raw["blocks"][0]["mixer"]
        for name in ("A_log", "dt_bias", "D", "conv_b", "norm_scale"):
            leaf = mixer[name]
            mixer[name] = (leaf + 0.3 * rng.standard_normal(leaf.shape)
                           ).astype(leaf.dtype)
    jq = JEngine(jcfg, JServeConfig(max_seq_len=80, quantize_weights=True))
    jq.load(jax.tree.map(jnp.asarray, raw))
    q = ServingEngine(cfg, ServeConfig(max_seq_len=80,
                                       quantize_weights=True), device="cpu")
    q.load(from_jax_params(raw, cfg, CPU))
    toks = _tokens(cfg, 2, 32)
    jlg, _ = jq.prefill_fn(jq.params, {"tokens": jnp.asarray(toks)})
    lg, _ = q.prefill_fn(q.params, {"tokens": torch.as_tensor(toks)})
    jlg, lg = np.asarray(jlg, np.float32), lg.float().numpy()
    assert np.abs(lg - jlg).max() <= 2.0 ** -6
    np.testing.assert_array_equal(lg.argmax(-1), jlg.argmax(-1))


def test_launcher_serves_mamba():
    from repro_torch.launch.serve import serve
    _, cfg = _cfgs("mamba2-130m")
    rep = serve(cfg, [5, 32, 2], max_new_tokens=3, slots=2, device="cpu")
    assert rep["served"] == 3 and rep["tokens_generated"] == 9
    assert set(rep["kernel_launches"].values()) == {0}
    with pytest.raises(ValueError):       # 40 steps at chunk 32
        serve(cfg, [40], max_new_tokens=1, device="cpu")
