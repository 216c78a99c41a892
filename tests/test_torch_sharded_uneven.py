"""The port's sharded training step where the model axis divides neither
the heads nor the vocab, against the JAX package's, on the CPU.

As ``tests/test_torch_sharded_train.py`` does: the port on 4 gloo ranks
(``tests/torch_gloo.py``), JAX on 4 fake XLA host devices (one
subprocess an arch, beside the ranks), ``jit_train_step`` under
``train_rules`` on the ``("data", "model")`` mesh (2, 2), both from the
JAX package's ``init_params`` (key 1, converted by
``repro_torch.convert``) in fp32, 2 steps on the same seeded batch. The
smoke configs are cut so that the model axis of 2 splits no whole number
of heads and no vocab:

* internlm2-1.8b at d_model 48, 3 q heads of 16 and 1 kv head, vocab
  251: the attention output's (h * k) columns, flattened for ``wo``, get a
  gradient that DTensor splits over the model axis into 24-column pieces,
  which no split into (3, 16) keeps (``sharding.whole_heads_grad``);
* mamba2-130m at d_model 24 (d_inner 48, 3 Mamba heads of 16), tied,
  vocab 251: the SSD output, flattened for the gated norm, likewise;
* granite-moe-1b-a400m, tied, vocab 251: the unembedding of a table whose
  vocab stays whole, on each rank's own rows (``layers._unembed_rows``);
* granite-moe-1b-a400m on (4, 1) with a batch of 2: the data shards
  outnumber the rows, so the MoE layer's token groups (one a data shard)
  split each sequence in half, and its output goes back to the rows'
  split before the (b, s) view (as llama4-maverick and jamba at train_4k
  on pod2x16x16: 16 rows a microbatch over 32 data shards).

Both head cases fail on the tree before the repair with DTensor's
"Cannot unflatten unevenly sharded tensor" in the backward, and only on a
mesh with a data axis above 1 as well; the last case failed in the MoE
layer's view.

* the losses of both steps agree within ``TRAINER_TOL``, each param leaf
  after them within ``GRAD_TOL`` in L2 norm relative to the leaf;
* every gradient leaf equals the port's unsharded gradient (granite's MoE
  tokens in as many groups as the mesh has data shards) within
  ``SHARD_GRAD_TOL`` of its max-abs.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import SRC
from test_torch_sharded_train import _jax_keys, _paths
from torch_gloo import run_ranks

from repro.config import get_config as jget_config
from repro.config import smoke_config as jsmoke_config
from repro.models import model as jlm
from repro_torch.config import get_config, smoke_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.models import model as lm
from repro_torch.tree import tree_leaves, tree_unflatten

# case -> (arch, config overrides, mesh, batch)
CASES = {
    "internlm2-1.8b": ("internlm2-1.8b", dict(
        d_model=48, num_heads=3, num_kv_heads=1, vocab_size=251), (2, 2), 4),
    "mamba2-130m": ("mamba2-130m", dict(d_model=24, vocab_size=251),
                    (2, 2), 4),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m",
                             dict(vocab_size=251), (2, 2), 4),
    "granite-moe-rows": ("granite-moe-1b-a400m", {}, (4, 1), 2),
}
NAMES = tuple(CASES)
STEPS = 2
TRAINER_TOL = 1e-4       # tests/test_torch_training.py
GRAD_TOL = 1e-4          # tests/test_torch_training.py
SHARD_GRAD_TOL = 1e-5    # tests/test_torch_sharded_train.py
TCFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=4)
SEQ = 32


def _cfgs(name):
    arch, over, _, _ = CASES[name]
    over = dict(dtype="float32", **over)
    return (jsmoke_config(jget_config(arch)).replace(**over),
            smoke_config(get_config(arch)).replace(**over))


def test_the_cases_split_what_they_say():
    """Heads and vocab the model axis does not divide; rows fewer than
    the data shards."""
    for name in NAMES[:3]:
        _, cfg = _cfgs(name)
        model = CASES[name][2][1]
        heads = cfg.mamba.n_heads(cfg.d_model) if cfg.mamba else \
            cfg.num_heads
        assert cfg.vocab_size % model
        assert heads % model or name == "granite-moe-1b-a400m"
    assert get_config("granite-moe-1b-a400m").tie_embeddings
    assert get_config("mamba2-130m").tie_embeddings
    _, _, (data, _), batch = CASES["granite-moe-rows"]
    assert batch < data and batch * SEQ % data == 0


@pytest.fixture(scope="module")
def inputs():
    out = {}
    rng = np.random.default_rng(0)
    for name in NAMES:
        jcfg, cfg = _cfgs(name)
        batch = CASES[name][3]
        params = from_jax_params(jax.tree.map(np.asarray, jlm.init_params(
            jcfg, jax.random.key(1))), cfg, "cpu")
        for path, t in zip(_paths(params), tree_leaves(params)):
            out[f"{name}/p/{path}"] = t.numpy()
        toks = rng.integers(0, cfg.vocab_size, (batch, SEQ + 1))
        out[f"{name}/tokens"] = toks[:, :-1].astype(np.int32)
        out[f"{name}/labels"] = toks[:, 1:].astype(np.int32)
        out[f"{name}/mask"] = (rng.random((batch, SEQ)) < 0.85).astype(
            np.float32)
    return out


JAX_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.config import TrainConfig, get_config, smoke_config
from repro.distributed.sharding import train_rules
from repro.launch.specs import opt_shardings, params_shardings
from repro.models import model as lm
from repro.training import checkpoint as ck
from repro.training.optimizer import init_opt_state
from repro.training.train_loop import jit_train_step
i = dict(np.load(sys.argv[1]))
name, arch, over, shape, steps, tkw = eval(sys.argv[3])
out = {}
cfg = smoke_config(get_config(arch)).replace(dtype="float32", **over)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
rules = train_rules()
tcfg = TrainConfig(remat="none", **tkw)
ps = params_shardings(cfg, mesh, rules)
os_, _ = opt_shardings(cfg, tcfg, mesh, rules)
step = jit_train_step(cfg, tcfg, mesh, rules, donate=False,
                      in_shardings=(ps, os_, None),
                      out_shardings=(ps, os_, None))
params = lm.init_params(cfg, jax.random.key(1))
batch = {k: jnp.asarray(i[f"{name}/{k}"]) for k in ("tokens", "labels", "mask")}
p, o = params, init_opt_state(params, tcfg)
for s in range(steps):
    p, o, m = step(p, o, batch)
    out[f"{name}/loss{s}"] = np.asarray(m["loss"])
for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
    out[f"{name}/p/{ck._keypath_str(path)}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
print("OK")
"""

RANKS_CODE = """
from repro_torch.config import TrainConfig, get_config, smoke_config
from repro_torch.distributed.sharding import (distribute_tree, map_shardings,
                                              place, train_rules, use_sharding)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import opt_shardings, params_shardings
from repro_torch.models import model as lm
from repro_torch.models import moe
from repro_torch.training.data import place_on_mesh
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_loop import jit_train_step, scalar
from repro_torch.tree import tree_leaves, tree_unflatten
cases, steps, tkw = CONFIG
rules = train_rules()

def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}/{i}" if prefix else str(i))]
    return [prefix]

def params_of(name, cfg):
    like = lm.init_params(cfg, torch.Generator(), torch.device("meta"))
    return tree_unflatten(like, [torch.as_tensor(inputs[f"{name}/p/{k}"]).clone()
                                 for k in paths(like)])

def batch_of(name):
    return {k: inputs[f"{name}/{k}"] for k in ("tokens", "labels", "mask")}

def grads(params, cfg, batch, mesh, on_mesh):
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    orig = moe._num_groups
    if not on_mesh:     # as many MoE token groups as the mesh's data shards
        moe._num_groups = lambda: mesh.shape[0]
    try:
        with use_sharding(mesh if on_mesh else None,
                          rules if on_mesh else None):
            loss, _ = lm.loss_fn(params, cfg, batch)
    finally:
        moe._num_groups = orig
    g = torch.autograd.grad(loss, leaves)
    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    return scalar(loss), [whole(x).detach().numpy() for x in g]

for name, (arch, over, shape) in cases.items():
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    cfg = smoke_config(get_config(arch)).replace(dtype="float32", **over)
    tcfg = TrainConfig(remat="none", **tkw)
    params = distribute_tree(params_of(name, cfg),
                             params_shardings(cfg, mesh, rules))
    opt = map_shardings(place, init_opt_state(params, tcfg),
                        opt_shardings(cfg, tcfg, mesh, rules)[0])
    step = jit_train_step(cfg, tcfg, mesh)
    for s in range(steps):
        params, opt, m = step(params, opt, place_on_mesh(mesh, rules)(batch_of(name)))
        out[f"{name}/loss{s}"] = np.array(scalar(m["loss"]))
    for j, t in enumerate(tree_leaves(params)):
        whole = t.detach().full_tensor().numpy()
        if rank == 0:
            out[f"{name}/p/{j}"] = whole
    one = {k: torch.as_tensor(v) for k, v in batch_of(name).items()}
    ref_loss, ref = grads(params_of(name, cfg), cfg, one, mesh, False)
    loss, got = grads(distribute_tree(params_of(name, cfg),
                                      params_shardings(cfg, mesh, rules)),
                      cfg, place_on_mesh(mesh, rules)(batch_of(name)), mesh,
                      True)
    out[f"grad/{name}/loss"] = np.array([ref_loss, loss])
    if rank == 0:
        for j, (a, b) in enumerate(zip(ref, got)):
            out[f"grad/{name}/ref/{j}"] = a
            out[f"grad/{name}/got/{j}"] = b
"""


def _jax_proc(name, d):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    arch, over, shape, _ = CASES[name]
    config = (name, arch, over, shape, STEPS, TCFG)
    return subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(d / "in.npz"),
         str(d / f"jax_{name}.npz"), repr(config)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory, require_fake_devices):
    d = tmp_path_factory.mktemp("sharded_uneven")
    np.savez(d / "in.npz", **inputs)
    procs = [_jax_proc(name, d) for name in NAMES]
    try:
        config = ({n: c[:3] for n, c in CASES.items()}, STEPS, TCFG)
        ranks = run_ranks(f"CONFIG = {config!r}\n" + RANKS_CODE, 4,
                          d / "ranks", inputs, timeout=300)
        for p in procs:
            stdout, stderr = p.communicate(timeout=300)
            assert "OK" in stdout, stderr[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    jax_out = {}
    for name in NAMES:
        jax_out.update(np.load(d / f"jax_{name}.npz"))
    return jax_out, ranks


@pytest.mark.parametrize("name", NAMES)
def test_uneven_losses_and_params_match_jax(runs, name):
    jax_out, ranks = runs
    for s in range(STEPS):
        want = float(jax_out[f"{name}/loss{s}"])
        for r in ranks:
            np.testing.assert_allclose(float(r[f"{name}/loss{s}"]), want,
                                       rtol=TRAINER_TOL, atol=TRAINER_TOL)
    _, cfg = _cfgs(name)
    like = lm.init_params(cfg, torch.Generator(), torch.device("meta"))
    n = len(tree_leaves(like))
    tree = tree_unflatten(like, [torch.as_tensor(ranks[0][f"{name}/p/{j}"])
                                 for j in range(n)])
    got = _jax_keys(to_jax_params(tree, cfg))
    assert len(got) == sum(k.startswith(f"{name}/p/") for k in jax_out)
    for key, a in got.items():
        want = jax_out[f"{name}/p/{key}"]
        err = np.linalg.norm(a - want) / np.linalg.norm(want)
        assert err <= GRAD_TOL, (key, err)


@pytest.mark.parametrize("name", NAMES)
def test_uneven_gradients_equal_the_unsharded_port(runs, name):
    """Every leaf, the attention and Mamba projections on both sides of
    the flattened heads, the (tied) table and the MoE leaves among them;
    the unsharded port's MoE tokens in as many groups as the mesh has data
    shards."""
    _, ranks = runs
    r0 = ranks[0]
    _, cfg = _cfgs(name)
    paths = _paths(lm.init_params(cfg, torch.Generator(),
                                  torch.device("meta")))
    assert sum(k.startswith(f"grad/{name}/ref/") for k in r0) == len(paths)
    for r in ranks:
        ref_loss, loss = r[f"grad/{name}/loss"]
        assert abs(ref_loss - loss) <= 1e-5 * abs(ref_loss)
    for j, leaf in enumerate(paths):
        a, b = r0[f"grad/{name}/ref/{j}"], r0[f"grad/{name}/got/{j}"]
        assert np.abs(a).max() > 0, leaf
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= SHARD_GRAD_TOL, (leaf, err)
