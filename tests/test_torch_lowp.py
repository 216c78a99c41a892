"""``mlp_lowp`` training, the port against the JAX package, on the CPU.

``ModelConfig.mlp_lowp`` is a training policy: every norm runs
``rmsnorm_lowp`` (its multiply chain and its backward in bf16) and the
MLPs keep their products in bf16. Neither package tested it before. Here
internlm2-1.8b's smoke config and granite-moe's (whose MoE layer reads the
flag at its experts) run in bf16 with the flag on, weights drawn by the
JAX package's ``init_params`` and carried across by
``convert.from_jax_params``: the port's loss and every gradient leaf
against ``jax.value_and_grad`` of ``repro``'s ``loss_fn`` on the same
batch; and every norm of the port's step takes the flag into its
backward (the closed form ``ref.rmsnorm_lowp_bwd_ref`` on the CPU, the
kernel's plain version).

Tolerances: bf16 activations through the smoke stack, the two packages'
matmuls and sums in other orders and XLA's bf16 sums rounded after every
add (the port rounds once): the loss within ``LOSS_TOL`` (relative), each
gradient leaf within ``GRAD_TOL`` of its max-abs. In granite-moe the
router's bf16 scores tie or nearly tie for some tokens, and the two
packages' top-k then pick other experts: the leaves the routing reaches
(the MoE block's ``ffn`` and ``norm2``) differ by up to a quarter of their
max-abs with the flag off as well. Those leaves are held to the same
comparison with the flag off, plus ``GRAD_TOL``; every other leaf to
``GRAD_TOL``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.config import smoke_config as jsmoke_config
from repro.models import model as jlm
from repro_torch.config import get_config, smoke_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.kernels import rmsnorm as trmsnorm
from repro_torch.models import model as lm
from repro_torch.tree import tree_leaves, tree_unflatten

LOSS_TOL = 1e-2
GRAD_TOL = 6e-2
ARCHS = ["internlm2-1.8b", "granite-moe-1b-a400m"]


def _pair(arch, lowp=True):
    over = dict(dtype="bfloat16", mlp_lowp=lowp)
    jcfg = jsmoke_config(jget_config(arch)).replace(**over)
    cfg = smoke_config(get_config(arch)).replace(**over)
    jparams = jlm.init_params(jcfg, jax.random.key(3))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, jparams, params


def _batch(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.85).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _leaf_errs(cfg, jgrads, grads):
    """{leaf path: max abs error over the JAX leaf's max-abs}."""
    got = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda t: t.float().numpy(), to_jax_params(grads, cfg)))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    errs = {}
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape and np.isfinite(g).all(), path
        errs[jax.tree_util.keystr(path)] = \
            np.abs(g - w).max() / max(np.abs(w).max(), 1e-6)
    return errs


def _routed(path):
    """Whether a leaf lies where a MoE layer's routing reaches it."""
    return "['ffn']" in path or "['norm2']" in path


def _grads(pair, batch):
    jcfg, cfg, jparams, params = pair
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, batch), has_aux=True)(jparams)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    loss, _ = lm.loss_fn(p, cfg, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
    return float(jloss), loss.item(), jgrads, grads


@pytest.fixture(scope="module", params=ARCHS)
def lowp_case(request):
    pair = _pair(request.param)
    return request.param, pair, _grads(pair, _batch(pair[1]))


@pytest.fixture(scope="module")
def moe_flag_off_errs():
    """granite-moe's leaf errors against JAX in bf16 with the flag off."""
    pair = _pair("granite-moe-1b-a400m", lowp=False)
    _, _, jgrads, grads = _grads(pair, _batch(pair[1]))
    return _leaf_errs(pair[1], jgrads, grads)


def test_lowp_config_reaches_every_norm(lowp_case):
    arch, (jcfg, cfg, _, _), _ = lowp_case
    assert cfg.mlp_lowp and jcfg.mlp_lowp and cfg.dtype == "bfloat16"


def test_lowp_loss_matches_jax(lowp_case):
    _, _, (jloss, loss, _, _) = lowp_case
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= LOSS_TOL * abs(jloss), (loss, jloss)


def test_lowp_grads_match_jax(lowp_case, moe_flag_off_errs):
    arch, (_, cfg, _, _), (_, _, jgrads, grads) = lowp_case
    moe = cfg.moe is not None
    for path, err in _leaf_errs(cfg, jgrads, grads).items():
        limit = GRAD_TOL
        if moe and _routed(path):
            limit += moe_flag_off_errs[path]
        assert err <= limit, (arch, path, err, limit)


def test_lowp_norms_take_the_lowp_backward(monkeypatch):
    """Every norm of internlm2's step (two a layer, the final one) runs its
    backward with the flag, in bf16."""
    seen = []
    plain_bwd = trmsnorm.plain_bwd

    def spy(x, w, dy, eps=1e-5, lowp=False):
        seen.append((lowp, x.dtype))
        return plain_bwd(x, w, dy, eps, lowp)
    monkeypatch.setattr(trmsnorm, "plain_bwd", spy)
    _, cfg, _, params = _pair("internlm2-1.8b")
    batch = _batch(cfg)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(params)]
    loss, _ = lm.loss_fn(tree_unflatten(params, leaves), cfg,
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    torch.autograd.grad(loss, leaves)
    assert seen == [(True, torch.bfloat16)] * (2 * cfg.num_layers + 1)
