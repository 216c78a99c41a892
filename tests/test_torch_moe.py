"""The port's MoE layer and the MoE family of archs against the JAX
package.

``repro_torch.models.moe.moe_apply`` runs the JAX package's ``moe_init``
weights, moved over as numpy arrays, on the same numpy inputs as
``repro.models.moe.moe_apply``: outputs at 1e-5 and the aux loss at 1e-6
in fp32, with and without dropped tokens, in both dispatch variants, and
at 2^-6 in bf16. The smoke configs of granite-moe-1b-a400m,
llama4-maverick-400b-a17b (top-1) and jamba-1.5-large-398b (Mamba and
attention, MoE every second layer) are held to ``repro.models.model`` at
1e-4 (``tests/test_models_smoke.py``'s fp32 tolerance), and the serving
engine's and the batcher's greedy tokens to the JAX engine's exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.config import ModelConfig as JModelConfig
from repro.config import MoEConfig as JMoEConfig
from repro.config import ServeConfig as JServeConfig
from repro.config import get_config as jget_config
from repro.config import smoke_config as jsmoke_config
from repro.models import model as jlm
from repro.models import moe as jmoe
from repro.models import transformer as jstack
from repro.serving.batcher import ContinuousBatcher as JBatcher
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.config import (ModelConfig, MoEConfig, ServeConfig,
                                get_config, smoke_config)
from repro_torch.convert import _tensor, from_jax_params
from repro_torch.models import model as lm
from repro_torch.models import moe
from repro_torch.models import transformer as stack
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.engine import ServingEngine

CPU = torch.device("cpu")
MOE_TOL = 1e-5          # moe_apply outputs, fp32
AUX_TOL = 1e-6          # the aux loss, fp32
BF16_TOL = 2.0 ** -6    # moe_apply outputs, bf16: a few bf16 ulps at |y| ~ 1
TOL = 1e-4              # tests/test_models_smoke.py, fp32 logits
ARCHS = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b",
         "jamba-1.5-large-398b"]
EK = [(4, 1), (4, 2), (8, 4)]


# ---------------------------------------------------------------------------
# The layer alone.
# ---------------------------------------------------------------------------
def _layer_cfgs(e, k, *, dispatch="v1", cf=1.25, dtype="float32"):
    kw = dict(name="t", family="moe", num_layers=1, d_model=32,
              num_heads=2, num_kv_heads=2, d_ff=0, vocab_size=64,
              dtype=dtype)
    mk = dict(num_experts=e, top_k=k, d_ff_expert=16, capacity_factor=cf,
              dispatch=dispatch)
    jcfg = JModelConfig(**kw, moe=JMoEConfig(**mk))
    cfg = ModelConfig(**kw, moe=MoEConfig(**mk))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _layer(e, k, *, seed=0, shape=(2, 24), **kw):
    """JAX and port configs, the same weights in both and one input, all
    drawn with numpy at unit-variance scales (router logits ~ N(0, 1),
    outputs of order 1) so that 1e-5 is a tight bound; ``moe_init``'s 0.02
    scale would give outputs of order 1e-3."""
    jcfg, cfg = _layer_cfgs(e, k, **kw)
    d, f = jcfg.d_model, jcfg.moe.d_ff_expert
    rng = np.random.default_rng(seed)
    std = lambda shape, fan_in: (rng.standard_normal(shape)
                                 / np.sqrt(fan_in)).astype(np.float32)
    raw = {"router": std((d, e), d), "w_gate": std((e, d, f), d),
           "w_up": std((e, d, f), d), "w_down": std((e, f, d), f)}
    x = rng.standard_normal((*shape, d)).astype(np.float32)
    dt = jnp.dtype(jcfg.dtype)
    jparams = {n: jnp.asarray(a, jnp.float32 if n == "router" else dt)
               for n, a in raw.items()}
    params = {n: _tensor(np.asarray(a), CPU) for n, a in jparams.items()}
    jx = jnp.asarray(x, dt)
    return jcfg, cfg, jparams, params, jx, _tensor(np.asarray(jx), CPU)


def _run_both(jcfg, cfg, jparams, params, jx, tx):
    want, jaux = jmoe.moe_apply(jparams, jcfg, jx)
    got, aux = moe.moe_apply(params, cfg, tx, aux_loss=True)
    return (np.asarray(want, np.float32), float(jaux),
            got.float().numpy(), float(aux))


@pytest.mark.parametrize("dispatch", ["v1", "v2"])
@pytest.mark.parametrize("e,k", EK)
def test_moe_apply_matches_jax(e, k, dispatch):
    want, jaux, got, aux = _run_both(*_layer(e, k, dispatch=dispatch))
    np.testing.assert_allclose(got, want, rtol=MOE_TOL, atol=MOE_TOL)
    assert abs(aux - jaux) <= AUX_TOL
    assert np.abs(got).max() > 0.5


def _jax_loop_positions(top_i: np.ndarray, e: int) -> np.ndarray:
    """A transcription of ``repro.models.moe.moe_apply``'s loop over the k
    choices (one group): the within-round exclusive cumsum plus the counts
    of the earlier rounds, read at each token's expert. -> (k, t)."""
    t, k = top_i.shape
    counts = np.zeros(e, np.int64)
    out = np.zeros((k, t), np.int64)
    for kk in range(k):
        idx = top_i[:, kk]
        onehot = np.eye(e, dtype=np.int64)[idx]
        within = np.cumsum(onehot, axis=0) - onehot
        out[kk] = (within + counts[None, :])[np.arange(t), idx]
        counts = counts + onehot.sum(axis=0)
    return out


@pytest.mark.parametrize("dispatch", ["v1", "v2"])
@pytest.mark.parametrize("e,k", [(4, 1), (4, 2)])
def test_moe_drops_match_jax(e, k, dispatch):
    """capacity_factor 0.1: the capacity is its floor of 8 rows an expert,
    so most of the 48 tokens' assignments drop. The outputs, and which
    tokens lost every choice (their rows exactly zero), equal JAX's."""
    jcfg, cfg, jparams, params, jx, tx = _layer(e, k, cf=0.1,
                                                dispatch=dispatch)
    want, jaux, got, aux = _run_both(jcfg, cfg, jparams, params, jx, tx)
    np.testing.assert_allclose(got, want, rtol=MOE_TOL, atol=MOE_TOL)
    assert abs(aux - jaux) <= AUX_TOL
    # Which assignments drop, from JAX's routing and its loop's positions.
    probs = jax.nn.softmax(jnp.asarray(tx.reshape(-1, cfg.d_model).numpy())
                           @ jparams["router"], axis=-1)
    top_i = np.asarray(jax.lax.top_k(probs, k)[1])
    cap = moe.expert_capacity(top_i.shape[0], cfg.moe)
    assert cap == 8
    keep = _jax_loop_positions(top_i, e) < cap
    assert (~keep).sum() > 0, "no assignment dropped"
    lost = ~keep.any(axis=0)
    assert lost.sum() > 0, "no token lost every choice"
    zero_w = np.all(want.reshape(-1, cfg.d_model) == 0, axis=-1)
    zero_g = np.all(got.reshape(-1, cfg.d_model) == 0, axis=-1)
    np.testing.assert_array_equal(zero_w, lost)
    np.testing.assert_array_equal(zero_g, lost)


@settings(max_examples=60, deadline=None)
@given(e=st.sampled_from([2, 4, 8]), k=st.integers(1, 3),
       t=st.integers(1, 32), seed=st.integers(0, 2 ** 31 - 1))
def test_dispatch_positions_equal_the_jax_loop(e, k, t, seed):
    """One exclusive cumsum over the k-major one-hot rows gives the same
    integers as JAX's loop over the k choices."""
    k = min(k, e)
    rng = np.random.default_rng(seed)
    top_i = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    got = moe.dispatch_positions(torch.as_tensor(top_i), e)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_loop_positions(top_i, e))


@pytest.mark.parametrize("e,k", [(4, 2), (8, 4)])
def test_moe_apply_bf16_matches_jax_bf16(e, k):
    """bf16 weights and activations, fp32 router: the combine's k products
    and adds round in bf16 as JAX's do. Observed: no element differs from
    JAX's. One fp32 sum over k, rounded once, would stay within 2^-6 too
    (one ulp at |y| ~ 2.5) but change 45 % (e 4, k 2) and 56 % (e 8, k 4)
    of the elements, so the share of differing elements is bounded too."""
    jcfg, cfg, jparams, params, jx, tx = _layer(e, k, dtype="bfloat16")
    assert params["w_gate"].dtype == torch.bfloat16
    assert params["router"].dtype == torch.float32
    want, jaux, got, aux = _run_both(jcfg, cfg, jparams, params, jx, tx)
    assert np.abs(got - want).max() <= BF16_TOL
    assert np.mean(got != want) <= 0.01
    assert abs(aux - jaux) <= AUX_TOL


def test_router_jitter_runs_only_with_a_generator():
    _, cfg, _, params, _, tx = _layer(4, 2)
    cfg_j = cfg.replace(moe=dataclasses.replace(cfg.moe, router_jitter=0.5))
    plain, _ = moe.moe_apply(params, cfg, tx)
    no_gen, aux = moe.moe_apply(params, cfg_j, tx)
    assert aux is None
    assert torch.equal(plain, no_gen)
    a, _ = moe.moe_apply(params, cfg_j, tx,
                         generator=torch.Generator().manual_seed(3))
    b, _ = moe.moe_apply(params, cfg_j, tx,
                         generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, plain)


# ---------------------------------------------------------------------------
# The three MoE archs at smoke size.
# ---------------------------------------------------------------------------
def _cfgs(arch):
    jcfg = jsmoke_config(jget_config(arch)).replace(dtype="float32")
    cfg = smoke_config(get_config(arch)).replace(dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_signatures_equal_jax(arch):
    """Every layer's (mixer, ffn) kind at full size and at smoke size."""
    for full in (True, False):
        cfg = get_config(arch) if full else smoke_config(get_config(arch))
        jcfg = jget_config(arch) if full else \
            jsmoke_config(jget_config(arch))
        sigs = [stack.layer_signature(cfg, i) for i in range(cfg.num_layers)]
        assert sigs == [jstack.layer_signature(jcfg, i)
                        for i in range(jcfg.num_layers)]
        assert any(f == "moe" for _, f in sigs)


@pytest.fixture(scope="module", params=ARCHS)
def moe_pair(request):
    jcfg, cfg = _cfgs(request.param)
    jparams = jlm.init_params(jcfg, jax.random.key(1))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, cfg, jparams, params


def _tokens(cfg, b, s, seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=TOL, atol=TOL)


def test_converted_moe_params_map_layers_to_block_positions(moe_pair):
    """Expert leaves arrive stacked over repeats, (L/period, e, d, f) and
    the router (L/period, d, e); layer i is repeat i // period of block
    position i % period. jamba's period is 4: (mamba, dense),
    (mamba, moe), (mamba, dense), (attn, moe)."""
    jcfg, cfg, jparams, params = moe_pair
    period = len(jparams["blocks"])
    assert period == jstack.block_period(jcfg)
    if cfg.name == "jamba-1.5-large-398b":
        assert [stack.layer_signature(cfg, i) for i in range(4)] == [
            ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
            ("attn", "moe")]
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    n_moe = 0
    for i, layer in enumerate(params["layers"]):
        block = jparams["blocks"][i % period]
        assert set(layer) == set(block)
        if stack.layer_signature(cfg, i)[1] != "moe":
            assert "router" not in layer.get("ffn", {})
            continue
        n_moe += 1
        ffn = layer["ffn"]
        assert tuple(ffn["w_gate"].shape) == (e, d, f)
        assert tuple(ffn["w_down"].shape) == (e, f, d)
        assert tuple(ffn["router"].shape) == (d, e)
        for name, leaf in ffn.items():
            want = np.asarray(block["ffn"][name])
            assert want.shape[0] == cfg.num_layers // period
            np.testing.assert_array_equal(leaf.numpy(), want[i // period])
    assert n_moe == sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))


def test_moe_forward_train_matches_jax(moe_pair):
    """Train-mode logits and the aux loss summed over the MoE layers."""
    jcfg, cfg, jparams, params = moe_pair
    toks = _tokens(cfg, 2, 64)        # two SSD chunks of 32 for jamba
    want, _, jaux = jlm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, caches, aux = lm.forward(params, cfg,
                                  {"tokens": torch.as_tensor(toks)})
    assert caches is None
    _close(got.numpy(), want)
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


@pytest.mark.parametrize("s", [11, 32])
def test_moe_prefill_and_per_slot_decode_match_jax(moe_pair, s):
    """Prefill at batch 2, then per-slot decode ticks (capacity counts
    every row of the batch, as in JAX)."""
    jcfg, cfg, jparams, params = moe_pair
    b, max_len = 2, 48
    toks = _tokens(cfg, b, s + 3, seed=4)
    jlg, jcaches = jlm.prefill(jparams, jcfg,
                               {"tokens": jnp.asarray(toks[:, :s])},
                               max_len=max_len)
    lg, caches = lm.prefill(params, cfg,
                            {"tokens": torch.as_tensor(toks[:, :s])},
                            max_len=max_len)
    _close(lg.numpy(), jlg)
    pos = np.array([s, s - 3], np.int32)
    for t in range(3):
        new = toks[:, s + t:s + t + 1]
        jlg, jcaches = jlm.decode_step(jparams, jcfg, jnp.asarray(new),
                                       jcaches, pos=jnp.asarray(pos + t))
        lg, caches = lm.decode_step(params, cfg, torch.as_tensor(new),
                                    caches, pos=torch.as_tensor(pos + t))
        _close(lg.numpy(), jlg)


def test_aux_is_computed_in_train_only():
    _, cfg = _cfgs("granite-moe-1b-a400m")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = {"tokens": torch.as_tensor(_tokens(cfg, 1, 8))}
    _, _, aux = lm.forward(params, cfg, toks)
    assert aux is not None and float(aux) > 0
    _, caches, aux = lm.forward(params, cfg, toks, mode="prefill")
    assert aux is None and len(caches) == cfg.num_layers
    dense = smoke_config(get_config("internlm2-1.8b"))
    dparams = lm.init_params(dense, torch.Generator().manual_seed(0), CPU)
    _, _, aux = lm.forward(dparams, dense, toks)
    assert float(aux) == 0.0


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def moe_engines(request):
    jcfg, cfg = _cfgs(request.param)
    jeng = JEngine(jcfg, JServeConfig(max_seq_len=64))
    jeng.init_random(0)
    eng = ServingEngine(cfg, ServeConfig(max_seq_len=64), device="cpu")
    eng.load(from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                             CPU))
    return jeng, eng


def test_moe_generate_tokens_equal_jax(moe_engines):
    jeng, eng = moe_engines
    toks = _tokens(eng.cfg, 2, 8, seed=5)
    want = np.asarray(jeng.generate(jnp.asarray(toks), 6))
    got = eng.generate(torch.as_tensor(toks), 6)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_batcher_tokens_equal_jax(moe_engines):
    """Prompts of 5..32 tokens (jamba's SSD contract: <= its chunk of 32)
    through both batchers at 2 slots, refilled mid-run; an empty slot's
    row still counts against each expert's capacity in both."""
    jeng, eng = moe_engines
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 32, 5, 7)]
    bat = ContinuousBatcher(eng, slots=2)
    jbat = JBatcher(jeng, slots=2)
    for p in prompts:
        bat.submit(p, max_new_tokens=4)
        jbat.submit(p, max_new_tokens=4)
    tracked, jtracked = list(bat.queue), list(jbat.queue)
    bat.run_to_completion(100)
    jbat.run_to_completion(100)
    for req, jreq in zip(tracked, jtracked):
        assert req.done and len(req.generated) == 4
        assert req.generated == jreq.generated


def test_moe_int8_logits_against_jax_int8():
    """Weight-only int8 granite at smoke size: the 3-D expert weights are
    quantized per (expert, column), as the JAX engine's stacked 4-D
    leaves are, and the fp32 router is dequantized to bf16 in both, then
    upcast. Prefill logits in bf16 within the 2^-6 of
    tests/test_torch_model.py::test_mamba_int8_logits_against_jax_int8,
    greedy tokens equal."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    jeng = JEngine(jcfg, JServeConfig(max_seq_len=64))
    jeng.init_random(0)
    raw = jax.tree.map(np.asarray, jeng.params)
    jq = JEngine(jcfg, JServeConfig(max_seq_len=64, quantize_weights=True))
    jq.load(jax.tree.map(jnp.asarray, raw))
    q = ServingEngine(cfg, ServeConfig(max_seq_len=64,
                                       quantize_weights=True), device="cpu")
    q.load(from_jax_params(raw, cfg, CPU))
    ffn = q.params["layers"][0]["ffn"]
    assert ffn["w_gate"]["__int8__"].shape == (4, 64, 32)
    assert ffn["w_gate"]["scale"].shape == (4, 32)
    assert ffn["router"]["scale"].shape == (4,)
    np.testing.assert_array_equal(
        ffn["w_gate"]["scale"].numpy(),
        np.asarray(jq.params["blocks"][0]["ffn"]["w_gate"]["scale"])[0])
    toks = _tokens(cfg, 2, 16)
    jlg, _ = jq.prefill_fn(jq.params, {"tokens": jnp.asarray(toks)})
    lg, _ = q.prefill_fn(q.params, {"tokens": torch.as_tensor(toks)})
    jlg, lg = np.asarray(jlg, np.float32), lg.float().numpy()
    assert np.abs(lg - jlg).max() <= 2.0 ** -6
    np.testing.assert_array_equal(lg.argmax(-1), jlg.argmax(-1))


def test_launcher_serves_granite():
    from repro_torch.launch.serve import serve
    _, cfg = _cfgs("granite-moe-1b-a400m")
    rep = serve(cfg, [5, 11, 7], max_new_tokens=4, slots=2, device="cpu")
    assert rep["served"] == 3 and rep["tokens_generated"] == 12
    assert set(rep["kernel_launches"].values()) == {0}
