"""The port's sharded training step against the JAX package's, on the CPU.

The port runs on 4 gloo ranks (``tests/torch_gloo.py``), JAX on 4 fake XLA
host devices in one subprocess: ``jit_train_step`` under ``train_rules``
in its reference mode, params placed by its ``params_shardings``. Both
start from the JAX package's ``init_params`` (key 1, converted by
``repro_torch.convert``) at the smoke configs of internlm2-1.8b and
mamba2-130m in fp32, take the same seeded batch, and run 2 steps on the
(2, 2), (1, 4) and (4, 1) ``("data", "model")`` meshes with remat
``"none"``, and on (2, 2) with remat ``"full"``. Each side runs once per
module:

* the losses of both steps agree within ``TRAINER_TOL``; each param leaf
  after them within ``GRAD_TOL`` in L2 norm relative to the leaf (not
  element by element: Adam's first update is ``lr * g / (|g| + eps)``,
  so an element whose gradient is near zero moves by up to ``lr`` on a
  rounding of ``g``; one element of mamba2's 75776 ``w_in`` lands at
  2.6e-4 of the leaf's max-abs while the leaf's norm error is 4.1e-6);
  every rank's local shard has the shape of JAX's shard at the same mesh
  coordinate;
* the gradients of the inputs that a kernel reads whole while its work is
  split (rmsnorm's scale, ``wk``/``wv``, ``A_log``/``dt_bias``/``D`` and
  the B/C columns of ``w_in``), and of every other leaf, equal the port's
  unsharded gradients within ``SHARD_GRAD_TOL`` of their max-abs. A
  ``Partial`` gradient placement left at ``Replicate`` is off by a factor
  of the split (2 or 4) and fails here; summing the same terms in another
  order leaves up to 2.0e-6 on mamba2's ``D`` (the SSD backward sums over
  batch, sequence and head dim), so the bound is 1e-5;
* ``loss_fn`` with ``loss_chunk`` under remat ``"full"`` and ``"dots"`` on
  the (2, 2) mesh equals the unsharded loss and gradients, the gradient
  taken outside the sharding context (as the autograd engine's thread on
  a card takes it), so each recomputed forward must bring its own;
* a ``Trainer`` checkpoint written on (2, 2) restores into (1, 2)
  shardings on 2 ranks with every whole tensor unchanged, bit for bit; a
  JAX checkpoint restores into the port's shardings the same way;
* a ``Trainer`` builds on an ``AbstractMesh`` for every ported config and
  refuses a mesh of another device type. The MoE and hybrid stacks on a
  mesh are held to JAX in ``tests/test_torch_sharded_moe_train.py``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import SRC
from torch_gloo import run_ranks

from repro.config import get_config as jget_config
from repro.config import smoke_config as jsmoke_config
from repro.models import model as jlm
from repro.training import checkpoint as jckpt
from repro_torch.config import TrainConfig, get_config, smoke_config
from repro_torch.configs import PORTED_ARCHS
from repro_torch.convert import (from_jax_opt_state, from_jax_params,
                                 to_jax_opt_state, to_jax_params)
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.models import model as lm
from repro_torch.models.transformer import block_period
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_loop import Trainer
from repro_torch.tree import tree_leaves, tree_unflatten

ARCHS = ("internlm2-1.8b", "mamba2-130m")
MESHES = ((2, 2), (1, 4), (4, 1))
# (mesh, remat) of each 2-step run: remat "none" on every mesh, "full"
# on (2, 2) (the recompute's shardings do not depend on the mesh shape)
RUNS = tuple((shape, "none") for shape in MESHES) + (((2, 2), "full"),)
STEPS = 2
TRAINER_TOL = 1e-4       # tests/test_torch_training.py
GRAD_TOL = 1e-4          # tests/test_torch_training.py
SHARD_GRAD_TOL = 1e-5
TCFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=4)
BATCH, SEQ = 4, 32


def _tag(arch, shape, remat):
    return f"{arch}/{shape[0]}x{shape[1]}/{remat}"


def _cfgs(arch):
    return (jsmoke_config(jget_config(arch)).replace(dtype="float32"),
            smoke_config(get_config(arch)).replace(dtype="float32"))


def _jax_keys(tree):
    """JAX keypath -> numpy leaf, as checkpoints name them."""
    return {ckpt_key: np.asarray(v) for ckpt_key, v in
            ckpt._flatten(tree)}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += _paths(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            out += _paths(v, f"{prefix}/{i}" if prefix else str(i))
        return out
    return [prefix]


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
archs, runs, steps, tkw = eval(sys.argv[3])
out = {}
devs = np.array(jax.devices()[:4])
rules = train_rules()
for arch in archs:
    cfg = smoke_config(get_config(arch)).replace(dtype="float32")
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
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.config import TrainConfig, get_config, smoke_config
from repro_torch.convert import to_jax_shardings
from repro_torch.distributed.sharding import train_rules, use_sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import opt_shardings, params_shardings
from repro_torch.models import model as lm
from repro_torch.training import checkpoint as ck
from repro_torch.training.data import place_on_mesh
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_loop import Trainer, jit_train_step, scalar
from repro_torch.distributed.sharding import distribute_tree, map_shardings, place
from repro_torch.tree import tree_leaves, tree_unflatten
archs, meshes, runs, steps, tkw, ckdir, mydir = CONFIG
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

def grads(params, cfg, batch, mesh=None, **kw):
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    with use_sharding(mesh, rules if mesh is not None else None):
        loss, _ = lm.loss_fn(params, cfg, batch, **kw)
    # outside the context, as the backward runs on a CUDA card (on the
    # autograd engine's thread): a remat recompute brings its own
    g = torch.autograd.grad(loss, leaves)
    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    return scalar(loss), [whole(x).detach().numpy() for x in g]

mesh_of = {shape: make_mesh(shape, ("data", "model"), device="cpu")
           for shape in meshes}
for arch in archs:
    cfg = smoke_config(get_config(arch)).replace(dtype="float32")
    for shape, remat in runs:
        mesh = mesh_of[shape]
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
        for j, t in enumerate(tree_leaves(params)):
            whole = t.detach().full_tensor().numpy()
            if rank == 0:
                out[f"{tag}/p/{j}"] = whole
            if remat == "none":
                out[f"{tag}/shape/{j}/{coord}"] = np.array(t.to_local().shape)
    # gradients against the port's own unsharded ones
    batch = {k: torch.as_tensor(v) for k, v in batch_of(arch).items()}
    ref_loss, ref = grads(params_of(arch, cfg), cfg, batch)
    for shape, mesh in mesh_of.items():
        loss, got = grads(distribute_tree(params_of(arch, cfg),
                                          params_shardings(cfg, mesh, rules)),
                          cfg, place_on_mesh(mesh, rules)(batch_of(arch)), mesh)
        if rank == 0:
            for j, (a, b) in enumerate(zip(ref, got)):
                out[f"grad/{arch}/{shape[0]}x{shape[1]}/ref/{j}"] = a
                out[f"grad/{arch}/{shape[0]}x{shape[1]}/got/{j}"] = b
    # loss_chunk under remat full and dots on (2, 2)
    mesh = mesh_of[(2, 2)]
    batch = {k: torch.as_tensor(v) for k, v in batch_of(arch).items()}
    for remat in ("full", "dots"):
        kw = dict(remat=remat, loss_chunk=8)
        ref_loss, ref = grads(params_of(arch, cfg), cfg, batch, **kw)
        loss, got = grads(distribute_tree(params_of(arch, cfg),
                                          params_shardings(cfg, mesh, rules)),
                          cfg, place_on_mesh(mesh, rules)(batch_of(arch)), mesh, **kw)
        out[f"chunk/{arch}/{remat}/loss"] = np.array([ref_loss, loss])
        out[f"chunk/{arch}/{remat}/err"] = np.array([
            np.abs(a - b).max() / max(np.abs(a).max(), 1e-30) for a, b in zip(ref, got)])

# checkpoints: a Trainer on (2, 2) saves; (1, 2) on ranks 0 and 1 restores
arch = archs[0]
cfg = smoke_config(get_config(arch)).replace(dtype="float32")
tcfg = TrainConfig(remat="none", **tkw)
mesh = mesh_of[(2, 2)]
from repro_torch.training.data import DataConfig, PrefetchingLoader
hist = Trainer(cfg, tcfg, mesh=mesh, device="cpu", ckpt_dir=mydir, ckpt_every=2
               ).run(PrefetchingLoader(DataConfig(vocab_size=cfg.vocab_size,
                     seq_len=32, global_batch=4)), steps=2, log_every=100)
small = DeviceMesh("cpu", torch.arange(2).reshape(1, 2), mesh_dim_names=("data", "model"))
if small.get_coordinate() is not None:
    p, o, start = Trainer(cfg, tcfg, mesh=small, device="cpu", ckpt_dir=mydir).init_state()
    coord = ",".join(map(str, small.get_coordinate()))
    for j, t in enumerate(tree_leaves(p)):
        out[f"remesh/p/{j}"] = t.detach().full_tensor().numpy()
        out[f"remesh/local/{j}/{coord}"] = np.array(t.to_local().shape)
    for j, t in enumerate(tree_leaves(o.m)):
        out[f"remesh/m/{j}"] = t.full_tensor().numpy()
    out["remesh/start"] = np.array(start)
    # a JAX checkpoint into the port's shardings
    like = lm.init_params(cfg, torch.Generator(), META)
    from repro_torch.convert import to_jax_params, from_jax_params
    tree = ck.restore(ckdir, {"params": to_jax_params(like, cfg)},
                      shardings={"params": to_jax_shardings(
                          params_shardings(cfg, small, rules), cfg)})
    for key, t in ck._flatten(tree):
        out[f"jaxckpt/{key}"] = t.full_tensor().numpy()
        out[f"jaxckpt_local/{key}/{coord}"] = np.array(t.to_local().shape)
    mine = from_jax_params(tree["params"], cfg, "cpu")
    out["jaxckpt/layers_sharded"] = np.array([
        t.to_local().shape != t.shape for t in tree_leaves(mine)])
"""


def _jax_proc(arch, d, config):
    """The JAX side of one arch in a subprocess of its own (the archs and
    the gloo ranks run side by side)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(d / "in.npz"),
         str(d / f"jax_{arch}.npz"), repr(((arch,),) + config)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory, require_fake_devices):
    d = tmp_path_factory.mktemp("sharded_train")
    np.savez(d / "in.npz", **inputs)
    jcfg, _ = _cfgs(ARCHS[0])
    jckpt.save(str(d / "jaxckpt"), 0, {"params": jlm.init_params(
        jcfg, jax.random.key(1))})
    config = (RUNS, STEPS, TCFG)
    procs = [_jax_proc(arch, d, config) for arch in ARCHS]
    try:
        code = "CONFIG = %r\n" % (((ARCHS, MESHES) + config + (
            str(d / "jaxckpt"), str(d / "port_ckpt"))),) + RANKS_CODE
        ranks = run_ranks(code, 4, d / "ranks", inputs, timeout=300)
        jax_out = {}
        for p in procs:
            stdout, stderr = p.communicate(timeout=300)
            assert "OK" in stdout, stderr[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for arch in ARCHS:
        jax_out.update(np.load(d / f"jax_{arch}.npz"))
    return jax_out, ranks, d


def _port_tree(arch, leaves):
    _, cfg = _cfgs(arch)
    like = lm.init_params(cfg, torch.Generator(), torch.device("meta"))
    return cfg, tree_unflatten(like, [torch.as_tensor(a) for a in leaves])


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[0][0]}x{r[0][1]}"
                         f"-{r[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_losses_and_params_match_jax(runs, arch, run):
    jax_out, ranks, _ = runs
    tag = _tag(arch, *run)
    for s in range(STEPS):
        want = float(jax_out[f"{tag}/loss{s}"])
        for r in ranks:
            np.testing.assert_allclose(float(r[f"{tag}/loss{s}"]), want,
                                       rtol=TRAINER_TOL, atol=TRAINER_TOL)
    n = sum(k.startswith(f"{tag}/p/") for k in ranks[0])
    cfg, tree = _port_tree(arch, [ranks[0][f"{tag}/p/{j}"]
                                  for j in range(n)])
    got = _jax_keys(to_jax_params(tree, cfg))
    assert len(got) == sum(k.startswith(f"{tag}/p/") for k in jax_out)
    for key, a in got.items():
        want = jax_out[f"{tag}/p/{key}"]
        err = np.linalg.norm(a - want) / np.linalg.norm(want)
        assert err <= GRAD_TOL, (key, err)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shards_have_jax_shard_shapes(runs, arch, shape):
    jax_out, ranks, _ = runs
    tag = _tag(arch, shape, "none")
    cfg, tree = _port_tree(arch, [ranks[0][f"{tag}/p/{j}"] for j in range(
        sum(k.startswith(f"{tag}/p/") for k in ranks[0]))])
    keys = [k for k, _ in ckpt._flatten(to_jax_params(tree, cfg))]
    flat = tree_leaves(tree)
    checked = 0
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
    assert checked >= len(flat) * len(ranks)


def _top_leaf_index(tree, key):
    return _paths(tree).index(key)


def _layer_leaf_indices(tree, cfg, key):
    """Indices of the port leaves that stack into JAX leaf ``key``
    (``blocks/<position>/...``): layer i is repeat i // p of position
    i % p."""
    _, pos, rest = key.split("/", 2)
    p = block_period(cfg)
    paths = _paths(tree)
    return [paths.index(f"layers/{i}/{rest}")
            for i in range(int(pos), cfg.num_layers, p)]


GRAD_LEAVES = {
    "internlm2-1.8b": ("layers/0/norm1/scale", "layers/1/norm2/scale",
                       "final_norm/scale", "layers/0/mixer/wk",
                       "layers/0/mixer/wv", "layers/3/mixer/wk"),
    "mamba2-130m": ("layers/0/norm1/scale", "final_norm/scale",
                    "layers/0/mixer/A_log", "layers/0/mixer/dt_bias",
                    "layers/0/mixer/D", "layers/2/mixer/A_log",
                    "layers/0/mixer/w_in"),
}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_whole_inputs_of_split_kernels_get_summed_gradients(runs, arch,
                                                            shape):
    """Each leaf's sharded gradient equals the unsharded one: those of
    GRAD_LEAVES by name (the whole inputs of kernels run on local shards,
    and for mamba2 the B/C columns of ``w_in`` on their own), then every
    other leaf."""
    _, ranks, _ = runs
    r0 = ranks[0]
    base = f"grad/{arch}/{shape[0]}x{shape[1]}"
    n = sum(k.startswith(f"{base}/ref/") for k in r0)
    _, cfg = _cfgs(arch)
    like = lm.init_params(cfg, torch.Generator(), torch.device("meta"))
    paths = _paths(like)
    assert n == len(paths)

    def check(name, a, b):
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= SHARD_GRAD_TOL, (name, err)
        assert np.abs(a).max() > 0, name

    for name in GRAD_LEAVES[arch]:
        j = paths.index(name)
        a, b = r0[f"{base}/ref/{j}"], r0[f"{base}/got/{j}"]
        check(name, a, b)
        if name.endswith("w_in"):
            m = cfg.mamba
            di, n_ = m.d_inner(cfg.d_model), m.d_state
            cols = slice(2 * di, 2 * di + 2 * n_)     # [z, x, B, C, dt]
            check("w_in B/C", a[:, cols], b[:, cols])
    for j, name in enumerate(paths):
        check(name, r0[f"{base}/ref/{j}"], r0[f"{base}/got/{j}"])


@pytest.mark.parametrize("remat", ("full", "dots"))
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_loss_under_remat_on_a_mesh(runs, arch, remat):
    _, ranks, _ = runs
    for r in ranks:
        ref, got = r[f"chunk/{arch}/{remat}/loss"]
        assert abs(ref - got) <= 1e-5 * abs(ref), (ref, got)
        assert r[f"chunk/{arch}/{remat}/err"].max() <= SHARD_GRAD_TOL


def test_trainer_checkpoint_restores_onto_a_smaller_mesh(runs):
    _, ranks, d = runs
    arch = ARCHS[0]
    _, cfg = _cfgs(arch)
    tcfg = TrainConfig(remat="none", **TCFG)
    like = lm.init_params(cfg, torch.Generator(), torch.device("meta"))
    saved = ckpt.restore(str(d / "port_ckpt"), {
        "params": to_jax_params(like, cfg),
        "opt": to_jax_opt_state(init_opt_state(like, tcfg), cfg)},
        device="cpu")
    assert ckpt.latest_step(str(d / "port_ckpt")) == 2
    params = from_jax_params(saved["params"], cfg, "cpu")
    opt = from_jax_opt_state(saved["opt"], cfg, "cpu")
    for r in ranks[:2]:
        assert int(r["remesh/start"]) == 2
        for j, t in enumerate(tree_leaves(params)):
            np.testing.assert_array_equal(r[f"remesh/p/{j}"], t.numpy())
        for j, t in enumerate(tree_leaves(opt.m)):
            np.testing.assert_array_equal(r[f"remesh/m/{j}"], t.numpy())
    # the local shards are the (1, 2) mesh's: the model axis splits
    assert any(tuple(ranks[0][f"remesh/local/{j}/0,0"]) != tuple(t.shape)
               for j, t in enumerate(tree_leaves(params)))
    # ranks 2 and 3 are off the (1, 2) mesh and restore nothing
    assert not any(k.startswith("remesh") for k in ranks[2])


def test_a_jax_checkpoint_restores_into_the_port_shardings(runs):
    _, ranks, d = runs
    jcfg, cfg = _cfgs(ARCHS[0])
    want = _jax_keys({"params": jlm.init_params(jcfg, jax.random.key(1))})
    for r in ranks[:2]:
        got = {k[len("jaxckpt/"):]: v for k, v in r.items()
               if k.startswith("jaxckpt/params/")}
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)
        assert r["jaxckpt/layers_sharded"].any()


def test_moe_hybrid_and_a_foreign_mesh_are_refused():
    """Only a mesh of another device type is refused: a Trainer builds on
    an ``AbstractMesh`` for every ported config, the MoE and hybrid ones
    included (``tests/test_torch_sharded_moe_train.py`` runs them)."""
    mesh = AbstractMesh((2, 2), ("data", "model"))
    for arch in PORTED_ARCHS:
        cfg = smoke_config(get_config(arch))
        trainer = Trainer(cfg, TrainConfig(), mesh=mesh, device="cpu")
        assert trainer.mesh is mesh
    assert not hasattr(lm, "check_mesh_support")

    class CudaMesh:
        device_type = "cuda"
    with pytest.raises(ValueError, match="mesh"):
        Trainer(smoke_config(get_config(ARCHS[0])), TrainConfig(),
                mesh=CudaMesh(), device="cpu")
