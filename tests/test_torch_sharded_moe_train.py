"""The port's sharded training step of the MoE and hybrid stacks against
the JAX package's, on the CPU.

As ``tests/test_torch_sharded_train.py`` does for the dense and Mamba-2
stacks: the port on 4 gloo ranks (``tests/torch_gloo.py``), JAX on 4 fake
XLA host devices (one subprocess an arch, beside the ranks),
``jit_train_step`` under ``train_rules``, both from the JAX package's
``init_params`` (key 1, converted by ``repro_torch.convert``) at the smoke
configs in fp32, 2 steps on the same seeded batch (4 x 32 tokens).
granite-moe-1b-a400m runs on the (2, 2), (1, 4) and (4, 1) ``("data",
"model")`` meshes with remat ``"none"`` and on (2, 2) with remat
``"full"`` (the recompute carries the sharding context into the MoE
layer); llama4-maverick-400b-a17b (top-1) and jamba-1.5-large-398b
(Mamba and attention layers, MoE every second one, ``capacity_factor``
0.5 on both sides so that experts overflow) on (2, 2) and (4, 1).

A MoE layer cuts its tokens into one group a data shard, each with its
own capacity, positions and share of the aux loss (``models/moe.py``):

* the losses of both steps agree within ``TRAINER_TOL``, the aux metric
  (the MoE layers' load-balancing loss) within ``AUX_TOL``, and each
  param leaf after them within ``GRAD_TOL`` in L2 norm relative to the
  leaf; every rank's local shard has the shape of JAX's shard at the same
  mesh coordinate (the expert weights: experts over ``model``, the fsdp
  dim over ``data``);
* every gradient leaf, ``router``, ``w_gate``, ``w_up`` and ``w_down``
  among them, equals the port's unsharded gradient with its MoE layers
  cut into as many groups (``moe._num_groups`` patched) within
  ``SHARD_GRAD_TOL`` of its max-abs: the routing, the scatter and the
  combine run on each rank's own groups, the experts on its groups and
  experts, and the inputs they read whole while the work is split (the
  router, the gathered expert weights) get ``Partial`` gradients;
* one group where the mesh has two or four data shards moves granite's
  loss past ``TRAINER_TOL`` from JAX's, so the groups are seen.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import SRC
from test_torch_sharded_train import (_jax_keys, _layer_leaf_indices,
                                      _paths, _top_leaf_index)
from torch_gloo import run_ranks

from repro.config import get_config as jget_config
from repro.config import smoke_config as jsmoke_config
from repro.models import model as jlm
from repro_torch.config import get_config, smoke_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.models import model as lm
from repro_torch.training import checkpoint as ckpt
from repro_torch.tree import tree_leaves, tree_unflatten

MESHES = {"granite-moe-1b-a400m": ((2, 2), (1, 4), (4, 1)),
          "llama4-maverick-400b-a17b": ((2, 2), (4, 1)),
          "jamba-1.5-large-398b": ((2, 2), (4, 1))}
ARCHS = tuple(MESHES)
CAPACITY = {"jamba-1.5-large-398b": 0.5}
# (mesh, remat) of each 2-step run of an arch
RUNS = {arch: tuple((s, "none") for s in shapes)
        + ((((2, 2), "full"),) if arch == ARCHS[0] else ())
        for arch, shapes in MESHES.items()}
CASES = [(a, r) for a, runs in RUNS.items() for r in runs]
GRAD_CASES = [(a, s) for a, shapes in MESHES.items() for s in shapes]
STEPS = 2
TRAINER_TOL = 1e-4       # tests/test_torch_training.py
GRAD_TOL = 1e-4          # tests/test_torch_training.py
SHARD_GRAD_TOL = 1e-5    # tests/test_torch_sharded_train.py
AUX_TOL = 1e-6           # tests/test_torch_moe.py
# Adam's eps at 1e-6 on both sides: the first update is lr * g / (|g| +
# eps), and jamba's dt_bias (zeros at init) has gradients down to 1.5e-9,
# so at the default 1e-8 a rounding of 2.3e-11 in g (the first step's
# gradients agree with JAX's within 1e-5 of each leaf's max-abs) moved
# that leaf by 2.5e-4 of its norm after 2 steps on (4, 1).
TCFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=4, eps=1e-6)
BATCH, SEQ = 4, 32
EXPERT_LEAVES = ("router", "w_gate", "w_up", "w_down")


def _cfgs(arch):
    jcfg = jsmoke_config(jget_config(arch)).replace(dtype="float32")
    cfg = smoke_config(get_config(arch)).replace(dtype="float32")
    if arch in CAPACITY:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=CAPACITY[arch]))
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=CAPACITY[arch]))
    return jcfg, cfg


def _tag(arch, shape, remat):
    return f"{arch}/{shape[0]}x{shape[1]}/{remat}"


@pytest.fixture(scope="module")
def inputs():
    out = {}
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        params = from_jax_params(jax.tree.map(np.asarray, jlm.init_params(
            jcfg, jax.random.key(1))), cfg, "cpu")
        for path, t in zip(_paths(params), tree_leaves(params)):
            out[f"{arch}/p/{path}"] = t.numpy()
        toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1))
        out[f"{arch}/tokens"] = toks[:, :-1].astype(np.int32)
        out[f"{arch}/labels"] = toks[:, 1:].astype(np.int32)
        out[f"{arch}/mask"] = (rng.random((BATCH, SEQ)) < 0.85).astype(
            np.float32)
    return out


JAX_CODE = """
import dataclasses, sys
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
arch, runs, cf, steps, tkw = eval(sys.argv[3])
out = {}
devs = np.array(jax.devices()[:4])
rules = train_rules()
cfg = smoke_config(get_config(arch)).replace(dtype="float32")
if cf:
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
params = lm.init_params(cfg, jax.random.key(1))
batch = {k: jnp.asarray(i[f"{arch}/{k}"]) for k in ("tokens", "labels", "mask")}
for shape, remat in runs:
    mesh = Mesh(devs.reshape(shape), ("data", "model"))
    tag = f"{arch}/{shape[0]}x{shape[1]}/{remat}"
    tcfg = TrainConfig(remat=remat, **tkw)
    ps = params_shardings(cfg, mesh, rules)
    os_, _ = opt_shardings(cfg, tcfg, mesh, rules)
    step = jit_train_step(cfg, tcfg, mesh, rules, donate=False,
                          in_shardings=(ps, os_, None),
                          out_shardings=(ps, os_, None))
    p, o = params, init_opt_state(params, tcfg)
    for s in range(steps):
        p, o, m = step(p, o, batch)
        out[f"{tag}/loss{s}"] = np.asarray(m["loss"])
        out[f"{tag}/aux{s}"] = np.asarray(m["aux"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
        key = ck._keypath_str(path)
        out[f"{tag}/p/{key}"] = np.asarray(leaf)
        if remat == "none":
            for sh in leaf.addressable_shards:
                r, c = np.argwhere(mesh.devices == sh.device)[0]
                out[f"{tag}/shape/{key}/{r},{c}"] = np.array(sh.data.shape)
np.savez(sys.argv[2], **out)
print("OK")
"""

RANKS_CODE = """
import dataclasses
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
runs, capacity, steps, tkw = CONFIG
rules = train_rules()
META = torch.device("meta")

def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}/{i}" if prefix else str(i))]
    return [prefix]

def params_of(arch, cfg):
    like = lm.init_params(cfg, torch.Generator(), META)
    return tree_unflatten(like, [torch.as_tensor(inputs[f"{arch}/p/{k}"]).clone()
                                 for k in paths(like)])

def batch_of(arch):
    return {k: inputs[f"{arch}/{k}"] for k in ("tokens", "labels", "mask")}

def grads(params, cfg, batch, mesh=None, groups=1):
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    orig = moe._num_groups
    if mesh is None:
        moe._num_groups = lambda: groups
    try:
        with use_sharding(mesh, rules if mesh is not None else None):
            loss, _ = lm.loss_fn(params, cfg, batch)
    finally:
        moe._num_groups = orig
    g = torch.autograd.grad(loss, leaves)
    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    return scalar(loss), [whole(x).detach().numpy() for x in g]

mesh_of = {}
for arch, arch_runs in runs:
    cfg = smoke_config(get_config(arch)).replace(dtype="float32")
    if arch in capacity:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity[arch]))
    for shape, remat in arch_runs:
        mesh = mesh_of.setdefault(shape, make_mesh(shape, ("data", "model"), device="cpu"))
        coord = ",".join(map(str, mesh.get_coordinate()))
        tag = f"{arch}/{shape[0]}x{shape[1]}/{remat}"
        tcfg = TrainConfig(remat=remat, **tkw)
        params = distribute_tree(params_of(arch, cfg),
                                 params_shardings(cfg, mesh, rules))
        opt = map_shardings(place, init_opt_state(params, tcfg),
                            opt_shardings(cfg, tcfg, mesh, rules)[0])
        step = jit_train_step(cfg, tcfg, mesh)
        for s in range(steps):
            batch = place_on_mesh(mesh, rules)(batch_of(arch))
            params, opt, m = step(params, opt, batch)
            out[f"{tag}/loss{s}"] = np.array(scalar(m["loss"]))
            out[f"{tag}/aux{s}"] = np.array(scalar(m["aux"]))
        for j, t in enumerate(tree_leaves(params)):
            whole = t.detach().full_tensor().numpy()
            if rank == 0:
                out[f"{tag}/p/{j}"] = whole
            if remat == "none":
                out[f"{tag}/shape/{j}/{coord}"] = np.array(t.to_local().shape)
        if remat != "none":
            continue
        # every gradient leaf against the port's unsharded one, its MoE
        # tokens in as many groups as the mesh has data shards
        one = {k: torch.as_tensor(v) for k, v in batch_of(arch).items()}
        ref_loss, ref = grads(params_of(arch, cfg), cfg, one, groups=shape[0])
        _, one_group = grads(params_of(arch, cfg), cfg, one)
        loss, got = grads(distribute_tree(params_of(arch, cfg),
                                          params_shardings(cfg, mesh, rules)),
                          cfg, place_on_mesh(mesh, rules)(batch_of(arch)), mesh)
        base = f"grad/{arch}/{shape[0]}x{shape[1]}"
        out[f"{base}/loss"] = np.array([ref_loss, loss])
        if rank == 0:
            for j, (a, b) in enumerate(zip(ref, got)):
                out[f"{base}/ref/{j}"] = a
                out[f"{base}/got/{j}"] = b
"""


def _jax_proc(arch, d):
    """The JAX side of one arch in a subprocess of its own (the archs and
    the gloo ranks run side by side)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    config = (arch, RUNS[arch], CAPACITY.get(arch), STEPS, TCFG)
    return subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(d / "in.npz"),
         str(d / f"jax_{arch}.npz"), repr(config)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory, require_fake_devices):
    d = tmp_path_factory.mktemp("sharded_moe_train")
    np.savez(d / "in.npz", **inputs)
    procs = [_jax_proc(arch, d) for arch in ARCHS]
    try:
        config = (tuple(RUNS.items()), CAPACITY, STEPS, TCFG)
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
    for arch in ARCHS:
        jax_out.update(np.load(d / f"jax_{arch}.npz"))
    return jax_out, ranks


def _port_tree(arch, leaves):
    _, cfg = _cfgs(arch)
    like = lm.init_params(cfg, torch.Generator(), torch.device("meta"))
    return cfg, tree_unflatten(like, [torch.as_tensor(a) for a in leaves])


def _ids(case):
    arch, (shape, remat) = case
    return f"{arch}-{shape[0]}x{shape[1]}-{remat}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sharded_losses_aux_and_params_match_jax(runs, case):
    jax_out, ranks = runs
    arch, run = case
    tag = _tag(arch, *run)
    for s in range(STEPS):
        want = float(jax_out[f"{tag}/loss{s}"])
        aux = float(jax_out[f"{tag}/aux{s}"])
        assert aux > 0
        for r in ranks:
            np.testing.assert_allclose(float(r[f"{tag}/loss{s}"]), want,
                                       rtol=TRAINER_TOL, atol=TRAINER_TOL)
            assert abs(float(r[f"{tag}/aux{s}"]) - aux) <= AUX_TOL
    n = sum(k.startswith(f"{tag}/p/") for k in ranks[0])
    cfg, tree = _port_tree(arch, [ranks[0][f"{tag}/p/{j}"]
                                  for j in range(n)])
    got = _jax_keys(to_jax_params(tree, cfg))
    assert len(got) == sum(k.startswith(f"{tag}/p/") for k in jax_out)
    for key, a in got.items():
        want = jax_out[f"{tag}/p/{key}"]
        err = np.linalg.norm(a - want) / np.linalg.norm(want)
        assert err <= GRAD_TOL, (key, err)


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}")
def test_local_shards_have_jax_shard_shapes(runs, case):
    jax_out, ranks = runs
    arch, shape = case
    tag = _tag(arch, shape, "none")
    cfg, tree = _port_tree(arch, [ranks[0][f"{tag}/p/{j}"] for j in range(
        sum(k.startswith(f"{tag}/p/") for k in ranks[0]))])
    keys = [k for k, _ in ckpt._flatten(to_jax_params(tree, cfg))]
    flat = tree_leaves(tree)
    checked = experts = 0
    for r in ranks:
        coord = next(k.rsplit("/", 1)[1] for k in r
                     if k.startswith(f"{tag}/shape/"))
        locals_ = [tuple(r[f"{tag}/shape/{j}/{coord}"]) for j in
                   range(len(flat))]
        for key in keys:
            want = tuple(jax_out[f"{tag}/shape/{key}/{coord}"])
            if key.startswith("blocks/"):
                want = want[1:]
                idx = _layer_leaf_indices(tree, cfg, key)
            else:
                idx = [_top_leaf_index(tree, key)]
            for j in idx:
                assert locals_[j] == want, (key, j, coord, locals_[j], want)
                checked += 1
                experts += key.rsplit("/", 1)[1] in EXPERT_LEAVES
    assert checked >= len(flat) * len(ranks)
    assert experts > 0


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}")
def test_every_gradient_leaf_matches_the_grouped_unsharded_port(runs, case):
    """Each leaf's sharded gradient equals the unsharded one at as many
    token groups: the MoE leaves by name first, then every leaf."""
    _, ranks = runs
    arch, shape = case
    r0 = ranks[0]
    base = f"grad/{arch}/{shape[0]}x{shape[1]}"
    _, cfg = _cfgs(arch)
    like = lm.init_params(cfg, torch.Generator(), torch.device("meta"))
    paths = _paths(like)
    assert sum(k.startswith(f"{base}/ref/") for k in r0) == len(paths)
    for r in ranks:
        ref_loss, loss = r[f"{base}/loss"]
        assert abs(ref_loss - loss) <= 1e-5 * abs(ref_loss)

    def check(name, j):
        a, b = r0[f"{base}/ref/{j}"], r0[f"{base}/got/{j}"]
        assert np.abs(a).max() > 0, name
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= SHARD_GRAD_TOL, (name, err)

    moe_leaves = [j for j, p in enumerate(paths)
                  if p.rsplit("/", 1)[1] in EXPERT_LEAVES]
    assert {paths[j].rsplit("/", 1)[1] for j in moe_leaves} == \
        set(EXPERT_LEAVES)
    for j in moe_leaves:
        check(paths[j], j)
    for j, name in enumerate(paths):
        check(name, j)


@pytest.mark.parametrize("shape", [s for s in MESHES[ARCHS[0]] if s[0] > 1],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_one_group_would_miss_jax_on_data_shards(runs, inputs, shape):
    """granite's first loss with one token group (the port's unsharded
    loss) is further than TRAINER_TOL from JAX's on a mesh of two or four
    data shards, which the sharded port matches."""
    jax_out, _ = runs
    arch = ARCHS[0]
    _, cfg = _cfgs(arch)
    like = lm.init_params(cfg, torch.Generator(), torch.device("meta"))
    params = tree_unflatten(like, [torch.as_tensor(inputs[f"{arch}/p/{k}"])
                                   for k in _paths(like)])
    batch = {k: torch.as_tensor(inputs[f"{arch}/{k}"])
             for k in ("tokens", "labels", "mask")}
    with torch.no_grad():
        one, _ = lm.loss_fn(params, cfg, batch)
    want = float(jax_out[f"{_tag(arch, shape, 'none')}/loss0"])
    assert abs(float(one) - want) > TRAINER_TOL, (float(one), want)
