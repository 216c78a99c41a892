"""The port's sharded serving of the MoE and hybrid stacks, and weight-only
int8 on a mesh, against the JAX package's, on the CPU.

The port runs on 4 gloo ranks (``tests/torch_gloo.py``), JAX on 4 fake XLA
host devices (one subprocess an arch, beside the ranks):
``ServingEngine(mesh=...)`` in its reference mode under ``serve_rules``,
at the smoke configs in fp32, from the JAX package's ``init_params`` (key
1, converted by ``repro_torch.convert``). granite-moe-1b-a400m runs on the
(2, 2), (1, 4) and (4, 1) ``("data", "model")`` meshes,
llama4-maverick-400b-a17b and jamba-1.5-large-398b (Mamba and attention
layers, MoE every second one) on (2, 2) and (4, 1). jamba runs at
``capacity_factor`` 0.5 on both sides: at its default no expert of the
smoke config overflows, and its token groups move the logits by less than
5e-7, so only dropped tokens show them.

A MoE layer cuts its tokens into one group a data shard (``moe.py``), in
the flattened ``(b·s)`` order: at data 2 and 4 a prefill of 4 prompts
gives each group whole prompts, and a batch-1 prefill in the batcher cuts
the prompt itself when its length divides by the groups (16 at 2 and 4;
30 at 2 only; 17 never: one group).

* a prefill of 4 prompts and 3 greedy decode steps: logits within
  ``tests/test_torch_model.py``'s fp32 ``TOL``, tokens equal;
* a ``ContinuousBatcher`` of 4 slots over 5 prompts of 16, 30 and 17
  tokens: tokens equal;
* weight-only int8 on the mesh (internlm2-1.8b and granite-moe on (2, 2)
  and (4, 1)): every int8 payload and scale equals the unsharded int8
  engine's, bit for bit, and the payload keeps the leaf's local shard
  shape; prefill and decode logits within the 2^-6 of
  ``tests/test_torch_moe.py``'s int8 test of JAX's int8 engine on the
  same mesh and of the port's unsharded int8 engine (its MoE tokens in as
  many groups as the mesh has data shards), and greedy tokens equal to
  the unsharded engine's. The dequantized weights are bf16, and so are
  the activations: where the model axis splits a contraction, each
  rank's product is rounded to bf16 before the sum, and an expert's
  product over one group's rows rounds as the CPU's bf16 GEMM blocks
  that row count. Against the unsharded engine that left up to 4.9e-3
  (internlm2 and granite-moe on (2, 2)) and 2.0e-3 (granite-moe on
  (4, 1)), one or two bf16 ulps at the logits' size; internlm2 on (4, 1)
  was bit for bit.
"""
import contextlib
import dataclasses
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
from repro_torch.config import ServeConfig, get_config, smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.models import model as lm
from repro_torch.models import moe
from repro_torch.serving.engine import ServingEngine
from repro_torch.tree import tree_leaves, tree_unflatten

MESHES = {"granite-moe-1b-a400m": ((2, 2), (1, 4), (4, 1)),
          "llama4-maverick-400b-a17b": ((2, 2), (4, 1)),
          "jamba-1.5-large-398b": ((2, 2), (4, 1))}
INT8_MESHES = {"internlm2-1.8b": ((2, 2), (4, 1)),
               "granite-moe-1b-a400m": ((2, 2), (4, 1))}
ARCHS = tuple(dict.fromkeys((*MESHES, *INT8_MESHES)))
CAPACITY = {"jamba-1.5-large-398b": 0.5}
TOL = 1e-4          # tests/test_torch_model.py
INT8_TOL = 2.0 ** -6  # tests/test_torch_moe.py::test_moe_int8_logits_...
MAX_LEN, DECODE_STEPS, NEW = 64, 3, 5
PROMPT_LENS = (16, 30, 17, 30, 16)
CASES = [(a, s) for a, shapes in MESHES.items() for s in shapes]
INT8_CASES = [(a, s) for a, shapes in INT8_MESHES.items() for s in shapes]


def _ids(case):
    return f"{case[0]}-{case[1][0]}x{case[1][1]}"


def _cfgs(arch):
    jcfg = jsmoke_config(jget_config(arch)).replace(dtype="float32")
    cfg = smoke_config(get_config(arch)).replace(dtype="float32")
    if arch in CAPACITY:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=CAPACITY[arch]))
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=CAPACITY[arch]))
    return jcfg, cfg


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree
                for p in _paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}/{i}" if prefix else str(i))]
    return [prefix]


@contextlib.contextmanager
def _groups(g):
    """The port's MoE layers cut their tokens into ``g`` groups, as on a
    mesh of ``g`` data shards."""
    orig = moe._num_groups
    moe._num_groups = lambda: g
    try:
        yield
    finally:
        moe._num_groups = orig


def _port_params(inputs, arch, cfg):
    like = lm.init_params(cfg, torch.Generator(), torch.device("meta"))
    return tree_unflatten(like, [torch.as_tensor(inputs[f"{arch}/p/{k}"])
                                 .clone() for k in _paths(like)])


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
        out[f"{arch}/batch"] = rng.integers(0, cfg.vocab_size,
                                            (4, 16)).astype(np.int32)
        for i, n in enumerate(PROMPT_LENS):
            out[f"{arch}/prompt{i}"] = rng.integers(
                0, cfg.vocab_size, n).astype(np.int32)
    return out


# Prefill + decode steps (+ the batcher) of one engine; ``E`` is the
# engine, ``A`` turns a step's logits into a numpy array, ``T`` a numpy
# token batch into the engine's input, ``argmax`` picks the next tokens.
STEPS_CODE = """
def drive(tag, E, A, T, argmax, batcher_cls, batch, prompts, steps, new):
    logits, caches = E.prefill_fn(E.params, {"tokens": T(batch)})
    pos = batch.shape[1]
    out[f"{tag}/logits0"] = A(logits)
    for s in range(steps):
        nxt = argmax(logits)
        out[f"{tag}/tokens{s}"] = np.asarray(nxt)
        logits, caches = E.decode_fn(E.params, T(np.asarray(nxt)[:, None]),
                                     caches, pos + s)
        out[f"{tag}/logits{s + 1}"] = A(logits)
    if batcher_cls is None:
        return
    b = batcher_cls(E, 4)
    for p in prompts:
        b.submit(p, new)
    for r in b.run_to_completion():
        out[f"{tag}/batcher/{r.rid}"] = np.array(r.generated)
"""

JAX_CODE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.config import ServeConfig, get_config, smoke_config
from repro.models import model as lm
from repro.serving.batcher import ContinuousBatcher
from repro.serving.engine import ServingEngine
i = dict(np.load(sys.argv[1]))
arch, runs, cf, max_len, steps, new, n_prompts = eval(sys.argv[3])
out = {}
""" + STEPS_CODE + """
devs = np.array(jax.devices()[:4])
cfg = smoke_config(get_config(arch)).replace(dtype="float32")
if cf:
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
params = lm.init_params(cfg, jax.random.key(1))
prompts = [i[f"{arch}/prompt{k}"] for k in range(n_prompts)]
for shape, int8 in runs:
    tag = f"{arch}/{shape[0]}x{shape[1]}" + ("/int8" if int8 else "")
    eng = ServingEngine(cfg, ServeConfig(max_seq_len=max_len,
                                         quantize_weights=int8),
                        mesh=Mesh(devs.reshape(shape), ("data", "model")))
    eng.load(params)
    drive(tag, eng, lambda l: np.asarray(l, np.float32), jnp.asarray,
          lambda l: jnp.argmax(l, axis=-1).astype(jnp.int32),
          None if int8 else ContinuousBatcher, i[f"{arch}/batch"], prompts,
          steps, new)
np.savez(sys.argv[2], **out)
print("OK")
"""

RANKS_CODE = STEPS_CODE + """
import dataclasses
from repro_torch.config import ServeConfig, get_config, smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as lm
from repro_torch.models import moe
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.engine import ServingEngine, whole
from repro_torch.tree import tree_leaves, tree_unflatten
runs, capacity, max_len, steps, new, n_prompts = CONFIG

def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}/{i}" if prefix else str(i))]
    return [prefix]

is_q = lambda l: isinstance(l, dict) and "__int8__" in l
for arch, shape, int8 in runs:
    cfg = smoke_config(get_config(arch)).replace(dtype="float32")
    if arch in capacity:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity[arch]))
    like = lm.init_params(cfg, torch.Generator(), torch.device("meta"))
    tag = f"{arch}/{shape[0]}x{shape[1]}" + ("/int8" if int8 else "")
    eng = ServingEngine(cfg, ServeConfig(max_seq_len=max_len, quantize_weights=int8),
                        device="cpu", mesh=make_mesh(shape, ("data", "model"), device="cpu"))
    eng.load(tree_unflatten(like, [torch.as_tensor(inputs[f"{arch}/p/{k}"]).clone()
                                   for k in paths(like)]))
    drive(tag, eng, lambda l: whole(l).float().numpy(), torch.as_tensor,
          lambda l: torch.argmax(whole(l), dim=-1),
          None if int8 else ContinuousBatcher,
          inputs[f"{arch}/batch"], [inputs[f"{arch}/prompt{k}"] for k in range(n_prompts)],
          steps, new)
    if int8:
        leaves = tree_leaves(eng.params, is_leaf=is_q)
        for j, (leaf, p) in enumerate(zip(leaves, tree_leaves(like))):
            if not is_q(leaf):
                continue
            q, s = leaf["__int8__"], leaf["scale"]
            qw, sw = q.full_tensor().numpy(), s.full_tensor().numpy()
            if rank == 0:
                out[f"{tag}/q/{j}"], out[f"{tag}/scale/{j}"] = qw, sw
            out[f"{tag}/q_local/{j}"] = np.array(q.to_local().shape)
            out[f"{tag}/q_placements/{j}"] = np.array(str(q.placements))
"""


def _jax_proc(arch, d):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    runs = [(s, False) for s in MESHES.get(arch, ())] + \
        [(s, True) for s in INT8_MESHES.get(arch, ())]
    config = (arch, runs, CAPACITY.get(arch), MAX_LEN, DECODE_STEPS, NEW,
              len(PROMPT_LENS))
    return subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(d / "in.npz"),
         str(d / f"jax_{arch}.npz"), repr(config)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory, require_fake_devices):
    d = tmp_path_factory.mktemp("sharded_moe_serve")
    np.savez(d / "in.npz", **inputs)
    procs = [_jax_proc(arch, d) for arch in ARCHS]
    try:
        config = ([(a, s, False) for a, s in CASES]
                  + [(a, s, True) for a, s in INT8_CASES], CAPACITY,
                  MAX_LEN, DECODE_STEPS, NEW, len(PROMPT_LENS))
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


def _tag(arch, shape):
    return f"{arch}/{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_prefill_and_decode_match_jax(runs, case):
    jax_out, ranks = runs
    tag = _tag(*case)
    for r in ranks:
        for s in range(DECODE_STEPS + 1):
            np.testing.assert_allclose(r[f"{tag}/logits{s}"],
                                       jax_out[f"{tag}/logits{s}"],
                                       rtol=TOL, atol=TOL)
        for s in range(DECODE_STEPS):
            np.testing.assert_array_equal(r[f"{tag}/tokens{s}"],
                                          jax_out[f"{tag}/tokens{s}"])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_batcher_tokens_equal_jax(runs, case):
    jax_out, ranks = runs
    tag = f"{_tag(*case)}/batcher"
    want = {k: v for k, v in jax_out.items() if k.startswith(tag)}
    assert len(want) == len(PROMPT_LENS)
    for r in ranks:
        got = {k: v for k, v in r.items() if k.startswith(tag)}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert len(got[k]) == NEW


@pytest.fixture(scope="module")
def unsharded_int8(inputs):
    """The port's unsharded int8 engine with as many MoE token groups as
    each mesh has data shards (``moe._num_groups`` patched): its payloads
    and scales, and the same prefill and decode steps."""
    out = {}
    is_q = lambda l: isinstance(l, dict) and "__int8__" in l
    for arch, shape in INT8_CASES:
        tag = _tag(arch, shape)
        _, cfg = _cfgs(arch)
        eng = ServingEngine(cfg, ServeConfig(max_seq_len=MAX_LEN,
                                             quantize_weights=True),
                            device="cpu")
        eng.load(_port_params(inputs, arch, cfg))
        for j, leaf in enumerate(tree_leaves(eng.params, is_leaf=is_q)):
            if is_q(leaf):
                out[f"{tag}/q/{j}"] = leaf["__int8__"].numpy()
                out[f"{tag}/scale/{j}"] = leaf["scale"].numpy()
        with _groups(shape[0]):
            logits, caches = eng.prefill_fn(eng.params, {
                "tokens": torch.as_tensor(inputs[f"{arch}/batch"])})
            pos = inputs[f"{arch}/batch"].shape[1]
            out[f"{tag}/logits0"] = logits.float().numpy()
            for s in range(DECODE_STEPS):
                nxt = torch.argmax(logits, dim=-1)
                out[f"{tag}/tokens{s}"] = nxt.numpy()
                logits, caches = eng.decode_fn(eng.params, nxt[:, None],
                                               caches, pos + s)
                out[f"{tag}/logits{s + 1}"] = logits.float().numpy()
    return out


@pytest.mark.parametrize("case", INT8_CASES, ids=_ids)
def test_int8_on_a_mesh_matches_unsharded_and_jax(runs, unsharded_int8,
                                                  case):
    jax_out, ranks = runs
    arch, shape = case
    base = _tag(*case)
    tag = f"{base}/int8"
    want = unsharded_int8
    r0 = ranks[0]
    qs = [k.rsplit("/", 1)[1] for k in r0 if k.startswith(f"{tag}/q/")]
    assert qs and len(qs) == sum(k.startswith(f"{base}/q/") for k in want)
    for j in qs:
        np.testing.assert_array_equal(r0[f"{tag}/q/{j}"],
                                      want[f"{base}/q/{j}"])
        np.testing.assert_array_equal(r0[f"{tag}/scale/{j}"],
                                      want[f"{base}/scale/{j}"])
    # the payload keeps the leaf's placements: every rank holds its share
    # of each leaf, and on (2, 2) the model axis splits some of them
    split = 0
    for j in qs:
        whole_shape = r0[f"{tag}/q/{j}"].shape
        locs = [tuple(r[f"{tag}/q_local/{j}"]) for r in ranks]
        n = np.prod(whole_shape)
        split += any(loc != whole_shape for loc in locs)
        assert all(n % np.prod(loc) == 0 for loc in locs)
    assert (split > 0) == (shape[1] > 1)
    for r in ranks:
        for s in range(DECODE_STEPS + 1):
            got = r[f"{tag}/logits{s}"]
            assert np.abs(got - want[f"{base}/logits{s}"]).max() <= INT8_TOL
            assert np.abs(got - jax_out[f"{tag}/logits{s}"]).max() \
                <= INT8_TOL
        for s in range(DECODE_STEPS):
            np.testing.assert_array_equal(r[f"{tag}/tokens{s}"],
                                          want[f"{base}/tokens{s}"])
