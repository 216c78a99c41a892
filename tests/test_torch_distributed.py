"""The port's distributed layer against the JAX package's, on the CPU.

The port runs on gloo ranks (``tests/torch_gloo.py``: one process a rank,
a file store), the JAX package under ``shard_map`` on as many fake XLA
host devices (one subprocess, as ``tests/test_multidevice.py`` runs it);
the same seeded numpy inputs go to both. Each side runs once per module
and the tests read its results:

* the ring and naive collective-matmuls and ``tp_matmul_overlapped`` at
  8 ranks, each rank's shard within 1e-5 of the output's max-abs;
* ``compressed_psum_mean`` at 8 ranks within 1e-6 relative, the linear
  int8 codes and scales equal bit for bit, the log-space codes within
  one step (``log`` may differ by an ulp between the two libraries), the
  wire-byte formulas equal;
* ``make_pipelined_fn`` at 4 stages x 8 microbatches within 1e-6;
* ``make_tp_block`` at 4 ranks, ring and blocking, within 1e-5;
* ``place_on_mesh`` on a 2 x 2 mesh: each rank's shard equals the JAX
  device's at the same mesh coordinate, bit for bit;
* ``remesh_arrays`` from 2 x 2 onto ``shrink_mesh_shape``'s 1 x 2: every
  full tensor unchanged, bit for bit, each local shard the shape the
  resolver gives.
"""
import json

import numpy as np
import pytest

from conftest import run_in_subprocess
from torch_gloo import run_ranks

from repro.distributed import compression as jcomp
from repro_torch.distributed import compression as tcomp

MATMULS = ("ring_ag", "ring_rs", "naive_ag", "naive_rs", "tp_overlapped")
PSUM_SIZES = (4096, 1000)          # a multiple of 8 x 256, and a padded one
RULES = ("train", "seq_over_model")
BATCH_KEYS = ("tokens", "labels", "mask", "vision_embeds")


def _inputs():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "x": f32(16, 64), "w": f32(64, 32),
        "g4096": f32(8, 4096), "g1000": f32(8, 1000),
        "q": f32(3, 1000), "err": f32(3, 1000) * 0.01,
        "pw": f32(4, 16, 16) * 0.5, "px": f32(8, 4, 16),
        "tx": f32(8, 32), "tw1": f32(32, 64) * 0.1, "tw2": f32(64, 32) * 0.1,
        "tokens": rng.integers(0, 1000, (4, 16)).astype(np.int32),
        "labels": rng.integers(0, 1000, (4, 16)).astype(np.int32),
        "mask": (rng.random((4, 16)) < 0.9).astype(np.float32),
        "vision_embeds": f32(4, 16, 8),
    }


JAX_CODE = """
import functools, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.compat import shard_map
from repro.distributed import collectives as C
from repro.distributed.compression import compressed_psum_mean
from repro.distributed.pipeline import make_pipelined_fn
from repro.distributed.sharding import train_rules
from repro.core.collaborative import make_tp_block
from repro.training.data import place_on_mesh
i = dict(np.load(sys.argv[1]))
out = {}
devs = np.array(jax.devices())
m8 = Mesh(devs[:8], ("model",))
def sm(f, mesh, ins, o):
    return jax.jit(shard_map(functools.partial(f, axis_name=mesh.axis_names[0]),
        mesh=mesh, in_specs=ins, out_specs=o))
col, row = P(None, "model"), P("model", None)
x, w = jnp.asarray(i["x"]), jnp.asarray(i["w"])
out["ring_ag"] = sm(C.ring_ag_matmul, m8, (col, col), col)(x, w)
out["naive_ag"] = sm(C.naive_ag_matmul, m8, (col, col), col)(x, w)
out["ring_rs"] = sm(C.ring_matmul_rs, m8, (col, row), col)(x, w)
out["naive_rs"] = sm(C.naive_matmul_rs, m8, (col, row), col)(x, w)
out["tp_overlapped"] = C.tp_matmul_overlapped(x, w, m8)
for n in (4096, 1000):
    out[f"psum{n}"] = sm(compressed_psum_mean, Mesh(devs[:8], ("d",)),
                         (P("d"),), P("d"))(jnp.asarray(i[f"g{n}"]))
m4 = Mesh(devs[:4], ("stage",))
out["pipeline"] = jax.jit(make_pipelined_fn(
    lambda p, v: jnp.tanh(v @ p["w"]), m4, 4))(
    {"w": jnp.asarray(i["pw"])}, jnp.asarray(i["px"]))
t4 = Mesh(devs[:4], ("model",))
for ov in (False, True):
    out[f"tp_block_{ov}"] = make_tp_block(t4, 32, 64, overlap=ov)(
        jnp.asarray(i["tx"]), jnp.asarray(i["tw1"]), jnp.asarray(i["tw2"]))
m22 = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
batch = {k: i[k] for k in ("tokens", "labels", "mask", "vision_embeds")}
for name, rules in (("train", train_rules()),
                    ("seq_over_model", train_rules().override(seq=("model",)))):
    for k, a in place_on_mesh(m22, rules)(batch).items():
        for s in a.addressable_shards:
            r, c = np.argwhere(m22.devices == s.device)[0]
            out[f"place/{name}/{k}/{r},{c}"] = s.data
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("OK")
"""

RANKS8_CODE = """
from repro_torch.launch.mesh import make_mesh
from repro_torch.distributed import collectives as C
from repro_torch.distributed.compression import compressed_psum_mean
mesh = make_mesh((world,), ("model",), device="cpu")
g = mesh.get_group("model")
x, w = torch.as_tensor(inputs["x"]), torch.as_tensor(inputs["w"])
kl, nl = x.shape[1] // world, w.shape[1] // world
xl = x[:, rank * kl:(rank + 1) * kl]
wc, wr = w[:, rank * nl:(rank + 1) * nl], w[rank * kl:(rank + 1) * kl]
out["ring_ag"] = C.ring_ag_matmul(xl, wc, g).numpy()
out["naive_ag"] = C.naive_ag_matmul(xl, wc, g).numpy()
out["ring_rs"] = C.ring_matmul_rs(xl, wr, g).numpy()
out["naive_rs"] = C.naive_matmul_rs(xl, wr, g).numpy()
y = C.tp_matmul_overlapped(x, w, mesh)
out["tp_overlapped"] = y.to_local().numpy()
for n in (4096, 1000):
    out[f"psum{n}"] = compressed_psum_mean(
        torch.as_tensor(inputs[f"g{n}"][rank]), g).numpy()
"""

RANKS4_CODE = """
import math
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, distribute_tensor
from repro_torch.config import get_config, smoke_config
from repro_torch.core.collaborative import make_tp_block
from repro_torch.distributed.fault import remesh_arrays, shrink_mesh_shape
from repro_torch.distributed.pipeline import make_pipelined_fn
from repro_torch.distributed.sharding import (AbstractMesh, resolve_spec,
    shard, shard_shape, train_rules, use_sharding)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import params_shardings
from repro_torch.models import model as lm
from repro_torch.training.data import place_on_mesh
from repro_torch.tree import tree_leaves, tree_unflatten
T = lambda k: torch.as_tensor(inputs[k])
stages = make_mesh((world,), ("stage",), device="cpu")
out["pipeline"] = make_pipelined_fn(lambda p, v: torch.tanh(v @ p["w"]),
    stages, world)({"w": T("pw")}, T("px")).to_local().numpy()
tp = make_mesh((world,), ("model",), device="cpu")
for ov in (False, True):
    out[f"tp_block_{ov}"] = make_tp_block(tp, 32, 64, overlap=ov)(
        T("tx"), T("tw1"), T("tw2")).to_local().numpy()
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
coord = ",".join(map(str, mesh.get_coordinate()))
rules = train_rules()
for name, r in (("train", rules),
                ("seq_over_model", rules.override(seq=("model",)))):
    batch = {k: inputs[k] for k in ("tokens", "labels", "mask",
                                    "vision_embeds")}
    for k, a in place_on_mesh(mesh, r)(batch).items():
        out[f"place/{name}/{k}/{coord}"] = a.to_local().numpy()
# the resolver on a DeviceMesh agrees with it on an AbstractMesh
ab = AbstractMesh((2, 2), ("data", "model"))
for shp, lg in (((8, 6), ("batch", "p_mlp")), ((4, 16, 8), ("batch", "kv_seq", None))):
    assert resolve_spec(shp, lg, rules, mesh) == resolve_spec(shp, lg, rules, ab)
# shard(): a DTensor is redistributed to its logical sharding
d = distribute_tensor(T("x"), mesh, [Replicate(), Replicate()])
with use_sharding(mesh, rules):
    s = shard(d, ("batch", "p_mlp"))
out["shard_placements"] = np.array([str(p) for p in s.placements])
out["shard_local"] = s.to_local().numpy()
# remesh: smoke internlm2's params from 2 x 2 onto the shrunk 1 x 2 mesh
cfg = smoke_config(get_config("internlm2-1.8b"))
params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                        torch.device("cpu"))
is_sh = lambda s: hasattr(s, "placements")
old = tree_leaves(params_shardings(cfg, mesh, rules), is_leaf=is_sh)
placed = tree_unflatten(params, [
    distribute_tensor(p, s.mesh, list(s.placements))
    for p, s in zip(tree_leaves(params), old)])
shape = shrink_mesh_shape((2, 2), ("data", "model"), 1)
new_mesh = DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=("data", "model"))
moved = remesh_arrays(placed, params_shardings(cfg, new_mesh, rules))
out["new_shape"] = np.array(shape)
if new_mesh.get_coordinate() is not None:
    full = [t.full_tensor() for t in tree_leaves(moved)]
    out["remesh_equal"] = np.array([
        torch.equal(a, b) for a, b in zip(full, tree_leaves(params))])
    new_ab = AbstractMesh(shape, ("data", "model"))
    out["remesh_local_ok"] = np.array([
        tuple(t.to_local().shape) == shard_shape(
            p.shape, resolve_spec(p.shape, lg, rules, new_ab), new_ab)
        for t, p, lg in zip(tree_leaves(moved), tree_leaves(params),
                            tree_leaves(lm.param_specs(cfg), is_leaf=lambda t: isinstance(t, tuple)))])
"""


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_out(inputs, tmp_path_factory, require_fake_devices):
    d = tmp_path_factory.mktemp("jax")
    np.savez(d / "in.npz", **inputs)
    r = run_in_subprocess(
        f"import sys; sys.argv = ['', {str(d / 'in.npz')!r}, "
        f"{str(d / 'out.npz')!r}]\n" + JAX_CODE, devices=8)
    assert "OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def port8(inputs, tmp_path_factory):
    return run_ranks(RANKS8_CODE, 8,
                     tmp_path_factory.mktemp("r8"), inputs)


@pytest.fixture(scope="module")
def port4(inputs, tmp_path_factory):
    return run_ranks(RANKS4_CODE, 4,
                     tmp_path_factory.mktemp("r4"), inputs)


def _shard(full, rank, world, dim):
    n = full.shape[dim] // world
    return np.take(full, range(rank * n, (rank + 1) * n), axis=dim)


@pytest.mark.parametrize("name", MATMULS)
def test_collective_matmul_shards_match_jax(name, port8, jax_out, inputs):
    full = jax_out[name]
    np.testing.assert_allclose(full, inputs["x"] @ inputs["w"],
                               atol=1e-4 * np.abs(full).max())
    tol = 1e-5 * np.abs(full).max()
    for rank, out in enumerate(port8):
        np.testing.assert_allclose(out[name], _shard(full, rank, 8, 1),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("n", PSUM_SIZES)
def test_compressed_psum_mean_matches_jax(n, port8, jax_out, inputs):
    want = jax_out[f"psum{n}"]
    assert want.shape == (8, n)
    for rank, out in enumerate(port8):
        np.testing.assert_allclose(out[f"psum{n}"], want[rank], rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    # and it is the mean, to int8 accuracy
    mean = inputs[f"g{n}"].mean(axis=0)
    assert np.abs(want - mean).max() < 0.05 * np.abs(mean).max()


@pytest.mark.parametrize("block", (256, 128))
def test_quantize_blockwise_codes_equal_jax(block, inputs):
    import jax.numpy as jnp
    import torch
    x = inputs["q"]
    jq, js, jpad = jcomp.quantize_blockwise(jnp.asarray(x), block)
    tq, ts, tpad = tcomp.quantize_blockwise(torch.as_tensor(x), block)
    assert tpad == jpad and tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcomp.dequantize_blockwise(tq, ts, tpad, x.shape).numpy(),
        np.asarray(jcomp.dequantize_blockwise(jq, js, jpad, x.shape)))
    (fq, fs, _), ferr = tcomp.quantize_with_feedback(
        torch.as_tensor(x), torch.as_tensor(inputs["err"]), block)
    (gq, gs, _), gerr = jcomp.quantize_with_feedback(
        jnp.asarray(x), jnp.asarray(inputs["err"]), block)
    np.testing.assert_array_equal(fq.numpy(), np.asarray(gq))
    np.testing.assert_array_equal(fs.numpy(), np.asarray(gs))
    np.testing.assert_array_equal(ferr.numpy(), np.asarray(gerr))


@pytest.mark.parametrize("block", (256, 128))
def test_quantize_blockwise_log_within_one_code_of_jax(block, inputs):
    """One code step: the codes go through ``log``, whose last bit may
    differ between XLA and PyTorch."""
    import jax.numpy as jnp
    import torch
    v = np.abs(inputs["q"]) ** 3
    v[0, :5] = 0.0
    jq, jlo, jsc, jpad = jcomp.quantize_blockwise_log(jnp.asarray(v), block)
    tq, tlo, tsc, tpad = tcomp.quantize_blockwise_log(torch.as_tensor(v),
                                                      block)
    assert tpad == jpad and tq.dtype == torch.uint8
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)
                  ).max() <= 1
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), rtol=1e-6)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-5)
    # dequantized from the same codes: exp may differ by an ulp
    back = tcomp.dequantize_blockwise_log(
        torch.as_tensor(np.array(jq)), torch.as_tensor(np.array(jlo)),
        torch.as_tensor(np.array(jsc)), jpad, v.shape)
    want = jcomp.dequantize_blockwise_log(jq, jlo, jsc, jpad, v.shape)
    np.testing.assert_allclose(back.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-30)


@pytest.mark.parametrize("n,a", [(1 << 20, 8), (1 << 20, 4), (4096, 2),
                                 (1000, 5), (12345, 1)])
def test_wire_bytes_equal_jax(n, a):
    assert tcomp.wire_bytes_fp32(n, a) == jcomp.wire_bytes_fp32(n, a)
    for block in (256, 64):
        assert tcomp.wire_bytes_compressed(n, a, block) == \
            jcomp.wire_bytes_compressed(n, a, block)


def test_pipeline_matches_jax(port4, jax_out, inputs):
    want = jax_out["pipeline"]
    ref = inputs["px"]
    for s in range(4):
        ref = np.tanh(ref @ inputs["pw"][s])
    np.testing.assert_allclose(want, ref, atol=1e-5)
    for out in port4:           # replicated: every stage holds the outputs
        np.testing.assert_allclose(out["pipeline"], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("overlap", (False, True))
def test_tp_block_matches_jax(overlap, port4, jax_out):
    full = jax_out[f"tp_block_{overlap}"]
    tol = 1e-5 * np.abs(full).max()
    for rank, out in enumerate(port4):
        np.testing.assert_allclose(out[f"tp_block_{overlap}"],
                                   _shard(full, rank, 4, 1), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("key", BATCH_KEYS)
def test_place_on_mesh_gives_each_rank_the_jax_shard(rules, key, port4,
                                                     jax_out):
    for out in port4:
        mine = [k for k in out if k.startswith(f"place/{rules}/{key}/")]
        assert len(mine) == 1
        np.testing.assert_array_equal(out[mine[0]], jax_out[mine[0]])
        assert out[mine[0]].dtype == jax_out[mine[0]].dtype


def test_shard_redistributes_a_dtensor(port4, inputs):
    for rank, out in enumerate(port4):
        assert json.dumps(out["shard_placements"].tolist()) == \
            json.dumps(["S(0)", "S(1)"])
        r, c = divmod(rank, 2)
        want = _shard(_shard(inputs["x"], r, 2, 0), c, 2, 1)
        np.testing.assert_array_equal(out["shard_local"], want)


def test_remesh_keeps_every_full_tensor(port4):
    assert port4[0]["new_shape"].tolist() == [1, 2]
    for rank, out in enumerate(port4):
        if rank < 2:            # the ranks of the shrunk mesh
            assert out["remesh_equal"].all() and out["remesh_equal"].size
            assert out["remesh_local_ok"].all()
        else:
            assert "remesh_equal" not in out
