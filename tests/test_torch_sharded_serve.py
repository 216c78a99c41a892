"""The port's sharded serving against the JAX package's, on the CPU.

The port runs on 4 gloo ranks (``tests/torch_gloo.py``), JAX on 4 fake XLA
host devices (one subprocess an arch): ``ServingEngine(mesh=...)`` in its
reference mode under ``serve_rules``, on the (2, 2), (1, 4) and (4, 1)
``("data", "model")`` meshes, at the smoke configs of internlm2-1.8b and
mamba2-130m in fp32, from the JAX package's ``init_params`` (key 1,
converted by ``repro_torch.convert``). Each side runs once per module:

* a prefill of 4 prompts and 3 greedy decode steps: the logits agree at
  ``tests/test_torch_model.py``'s fp32 ``TOL`` and the tokens are equal;
* a ``ContinuousBatcher`` of 4 slots over 5 prompts of 16 and 30 tokens:
  the tokens are equal. The caches (64 rows) are sequence-sharded over
  ``model``, so slots end inside the first shard, cross into the next
  and, at 4 shards, fill one exactly.

The kernel ops on local shards, on the same ranks:

* decode attention over 1, 2 and 4 sequence shards (partial mode and
  ``combine_partials``) equals ``decode_attention_ref`` on the whole
  cache, with slots of length 0, inside one shard, across shards and
  full;
* prefill attention on local q heads (``local_kv_heads``: a slice of the
  kv heads, or the repeat where the local heads and the group do not
  divide one another) equals the plain version, and so do the gradients
  of q, k and v.

And in this process: ``local_kv_heads`` against the head map q -> q // g
for every rank of each (hq, hkv, tp) case, the plain partial decode
against ``decode_attention_ref``, and the one refusal left (a mesh of
another device type): an engine builds on an ``AbstractMesh`` for every
ported config, with and without ``quantize_weights``. The MoE and hybrid
stacks and int8 weights on a mesh are held to JAX in
``tests/test_torch_sharded_moe_serve.py``.
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
from repro_torch.config import ServeConfig, get_config, smoke_config
from repro_torch.configs import PORTED_ARCHS
from repro_torch.convert import from_jax_params
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.kernels import ops, ref
from repro_torch.serving.engine import ServingEngine
from repro_torch.tree import tree_leaves

ARCHS = ("internlm2-1.8b", "mamba2-130m")
MESHES = ((2, 2), (1, 4), (4, 1))
TOL = 1e-4          # tests/test_torch_model.py
MAX_LEN, DECODE_STEPS, NEW = 64, 3, 5
PROMPT_LENS = (16, 30, 16, 30, 16)
GQA_CASES = ((4, 2, 2), (4, 2, 4), (8, 2, 4), (6, 2, 2), (12, 2, 4),
             (12, 3, 2), (6, 3, 2), (16, 4, 4), (6, 3, 4))
SEQ_SHARDS = (1, 2, 4)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree
                for p in _paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}/{i}" if prefix else str(i))]
    return [prefix]


@pytest.fixture(scope="module")
def inputs():
    out = {}
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        jcfg = jsmoke_config(jget_config(arch)).replace(dtype="float32")
        cfg = smoke_config(get_config(arch)).replace(dtype="float32")
        params = from_jax_params(jax.tree.map(np.asarray, jlm.init_params(
            jcfg, jax.random.key(1))), cfg, "cpu")
        for path, t in zip(_paths(params), tree_leaves(params)):
            out[f"{arch}/p/{path}"] = t.numpy()
        out[f"{arch}/batch"] = rng.integers(0, cfg.vocab_size,
                                            (4, 16)).astype(np.int32)
        for i, n in enumerate(PROMPT_LENS):
            out[f"{arch}/prompt{i}"] = rng.integers(
                0, cfg.vocab_size, n).astype(np.int32)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    out["dec_q"], out["dec_k"], out["dec_v"] = (f32(4, 8, 16),
                                                f32(4, 32, 2, 16),
                                                f32(4, 32, 2, 16))
    out["dec_len"] = np.array([0, 5, 19, 32], np.int32)
    for hq, hkv, tp in GQA_CASES:
        out[f"gqa/{hq},{hkv}/q"] = f32(2, 8, hq, 16)
        out[f"gqa/{hq},{hkv}/k"] = f32(2, 8, hkv, 16)
        out[f"gqa/{hq},{hkv}/v"] = f32(2, 8, hkv, 16)
        out[f"gqa/{hq},{hkv}/dy"] = f32(2, 8, hq, 16)
    return out


JAX_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.config import ServeConfig, get_config, smoke_config
from repro.models import model as lm
from repro.serving.batcher import ContinuousBatcher
from repro.serving.engine import ServingEngine
i = dict(np.load(sys.argv[1]))
arch, meshes, max_len, steps, new, n_prompts = eval(sys.argv[3])
out = {}
devs = np.array(jax.devices()[:4])
cfg = smoke_config(get_config(arch)).replace(dtype="float32")
params = lm.init_params(cfg, jax.random.key(1))
for shape in meshes:
    tag = f"{arch}/{shape[0]}x{shape[1]}"
    eng = ServingEngine(cfg, ServeConfig(max_seq_len=max_len),
                        mesh=Mesh(devs.reshape(shape), ("data", "model")))
    eng.load(params)
    logits, caches = eng.prefill_fn(eng.params, {"tokens": jnp.asarray(i[f"{arch}/batch"])})
    pos = i[f"{arch}/batch"].shape[1]
    out[f"{tag}/logits0"] = np.asarray(logits)
    for s in range(steps):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out[f"{tag}/tokens{s}"] = np.asarray(nxt)
        logits, caches = eng.decode_fn(eng.params, nxt[:, None], caches, pos + s)
        out[f"{tag}/logits{s + 1}"] = np.asarray(logits)
    b = ContinuousBatcher(eng, 4)
    for k in range(n_prompts):
        b.submit(i[f"{arch}/prompt{k}"], new)
    for r in b.run_to_completion():
        out[f"{tag}/batcher/{r.rid}"] = np.array(r.generated)
np.savez(sys.argv[2], **out)
print("OK")
"""

RANKS_CODE = """
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.config import ServeConfig, get_config, smoke_config
from repro_torch.distributed.sharding import serve_rules, train_rules, use_sharding
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as lm
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.engine import ServingEngine, whole
from repro_torch.tree import tree_unflatten
archs, meshes, max_len, steps, new, n_prompts, gqa_cases, seq_shards = CONFIG

def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}/{i}" if prefix else str(i))]
    return [prefix]

T = lambda k: torch.as_tensor(inputs[k])
for arch in archs:
    cfg = smoke_config(get_config(arch)).replace(dtype="float32")
    like = lm.init_params(cfg, torch.Generator(), torch.device("meta"))
    for shape in meshes:
        tag = f"{arch}/{shape[0]}x{shape[1]}"
        eng = ServingEngine(cfg, ServeConfig(max_seq_len=max_len), device="cpu",
                            mesh=make_mesh(shape, ("data", "model"), device="cpu"))
        eng.load(tree_unflatten(like, [T(f"{arch}/p/{k}").clone() for k in paths(like)]))
        logits, caches = eng.prefill_fn(eng.params, {"tokens": T(f"{arch}/batch")})
        pos = inputs[f"{arch}/batch"].shape[1]
        out[f"{tag}/logits0"] = whole(logits).numpy()
        for s in range(steps):
            nxt = torch.argmax(whole(logits), dim=-1)
            out[f"{tag}/tokens{s}"] = nxt.numpy()
            logits, caches = eng.decode_fn(eng.params, nxt[:, None], caches, pos + s)
            out[f"{tag}/logits{s + 1}"] = whole(logits).numpy()
        b = ContinuousBatcher(eng, 4)
        for k in range(n_prompts):
            b.submit(inputs[f"{arch}/prompt{k}"], new)
        for r in b.run_to_completion():
            out[f"{tag}/batcher/{r.rid}"] = np.array(r.generated)

# decode attention over n sequence shards of the cache
for n in seq_shards:
    mesh = make_mesh((4 // n, n), ("data", "model"), device="cpu")
    plc = [Replicate(), Shard(1)]
    k = distribute_tensor(T("dec_k"), mesh, plc)
    v = distribute_tensor(T("dec_v"), mesh, plc)
    q = distribute_tensor(T("dec_q"), mesh, [Replicate(), Replicate()])
    with use_sharding(mesh, serve_rules()):
        o = ops.decode_attention(q, k, v, T("dec_len"))
    out[f"dec/{n}"] = o.full_tensor().numpy()
    out[f"dec/{n}/local_rows"] = np.array(k.to_local().shape[1])

# prefill attention on local q heads, forward and backward
for hq, hkv, tp in gqa_cases:
    mesh = make_mesh((4 // tp, tp), ("data", "model"), device="cpu")
    key = f"gqa/{hq},{hkv}"
    rep = [Replicate(), Replicate()]
    qkv = [distribute_tensor(T(f"{key}/{x}"), mesh, rep).requires_grad_(True)
           for x in "qkv"]
    with use_sharding(mesh, train_rules()):
        y = ops.attention(*qkv, causal=True)
        g = torch.autograd.grad(y, qkv, distribute_tensor(T(f"{key}/dy"), mesh, rep))
    out[f"{key}/{tp}/y"] = y.full_tensor().detach().numpy()
    out[f"{key}/{tp}/y_local_heads"] = np.array(y.to_local().shape[2])
    for x, gx in zip("qkv", g):
        out[f"{key}/{tp}/d{x}"] = gx.full_tensor().numpy()
"""


def _jax_proc(arch, d):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    config = (arch, MESHES, MAX_LEN, DECODE_STEPS, NEW, len(PROMPT_LENS))
    return subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(d / "in.npz"),
         str(d / f"jax_{arch}.npz"), repr(config)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory, require_fake_devices):
    d = tmp_path_factory.mktemp("sharded_serve")
    np.savez(d / "in.npz", **inputs)
    procs = [_jax_proc(arch, d) for arch in ARCHS]
    try:
        config = (ARCHS, MESHES, MAX_LEN, DECODE_STEPS, NEW,
                  len(PROMPT_LENS), GQA_CASES, SEQ_SHARDS)
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


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(runs, arch, shape):
    jax_out, ranks = runs
    tag = f"{arch}/{shape[0]}x{shape[1]}"
    for r in ranks:
        for s in range(DECODE_STEPS + 1):
            np.testing.assert_allclose(r[f"{tag}/logits{s}"],
                                       jax_out[f"{tag}/logits{s}"],
                                       rtol=TOL, atol=TOL)
        for s in range(DECODE_STEPS):
            np.testing.assert_array_equal(r[f"{tag}/tokens{s}"],
                                          jax_out[f"{tag}/tokens{s}"])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_tokens_equal_jax(runs, arch, shape):
    jax_out, ranks = runs
    tag = f"{arch}/{shape[0]}x{shape[1]}/batcher"
    want = {k: v for k, v in jax_out.items() if k.startswith(tag)}
    assert len(want) == len(PROMPT_LENS)
    for r in ranks:
        got = {k: v for k, v in r.items() if k.startswith(tag)}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert len(got[k]) == NEW


@pytest.mark.parametrize("n", SEQ_SHARDS)
def test_decode_over_sequence_shards_equals_the_whole_cache(runs, inputs,
                                                            n):
    _, ranks = runs
    T = lambda k: torch.as_tensor(inputs[k])
    want = ref.decode_attention_ref(T("dec_q"), T("dec_k"), T("dec_v"),
                                    T("dec_len")).numpy()
    # the length-0 slot: the plain version averages every row, the
    # sharded one has no row to attend and gives 0 (the kernel's l == 0)
    assert inputs["dec_len"][0] == 0
    for r in ranks:
        assert int(r[f"dec/{n}/local_rows"]) == 32 // n
        np.testing.assert_allclose(r[f"dec/{n}"][1:], want[1:], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(r[f"dec/{n}"][0], 0.0)


@pytest.mark.parametrize("case", GQA_CASES,
                         ids=[f"hq{a}-hkv{b}-tp{c}" for a, b, c in GQA_CASES])
def test_attention_on_local_heads_equals_the_plain_version(runs, inputs,
                                                           case):
    _, ranks = runs
    hq, hkv, tp = case
    key = f"gqa/{hq},{hkv}"
    q, k, v = (torch.as_tensor(inputs[f"{key}/{x}"]).requires_grad_(True)
               for x in "qkv")
    y = ref.attention_ref(q, k, v, causal=True)
    grads = torch.autograd.grad(y, (q, k, v),
                                torch.as_tensor(inputs[f"{key}/dy"]))
    heads = hq // tp if hq % tp == 0 else hq
    for r in ranks:
        assert int(r[f"{key}/{tp}/y_local_heads"]) == heads
        np.testing.assert_allclose(r[f"{key}/{tp}/y"], y.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        for x, g in zip("qkv", grads):
            np.testing.assert_allclose(r[f"{key}/{tp}/d{x}"], g.numpy(),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", GQA_CASES + ((10, 2, 2), (12, 4, 4), (24, 6, 4),
                                              (40, 8, 8), (14, 2, 4)),
                         ids=lambda c: f"hq{c[0]}-hkv{c[1]}-tp{c[2]}")
def test_local_kv_heads_map_each_q_head_to_its_group(case):
    hq, hkv, tp = case
    g = hq // hkv
    if hq % tp:
        tp = 1                      # heads_act falls back to replicated
    n = hq // tp
    for r in range(tp):
        lo, hi, rep = ops.local_kv_heads(g, r * n, n, 0, hkv)
        kv = np.arange(hkv)[lo:hi]
        if rep is not None:
            kv = np.repeat(kv, g)[rep:rep + n]
            assert len(kv) == n
        else:
            assert n % len(kv) == 0
            kv = np.repeat(kv, n // len(kv))
        np.testing.assert_array_equal(kv, (r * n + np.arange(n)) // g)
        aligned = n % g == 0 or g % n == 0
        assert (rep is None) == aligned, (case, r)


@pytest.mark.parametrize("length", [0, 1, 17, 40])
def test_plain_partial_decode(length):
    rng = np.random.default_rng(length)
    f32 = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(
        np.float32))
    q, k, v = f32(3, 6, 16), f32(3, 40, 2, 16), f32(3, 40, 2, 16)
    lens = torch.tensor([length, 40, 3], dtype=torch.int32)
    out, lse = ref.decode_attention_partial_ref(q, k, v, lens)
    want = ref.decode_attention_ref(q, k, v, lens)
    assert out.dtype == q.dtype and lse.shape == (3, 6)
    assert lse.dtype == torch.float32
    rows = slice(0, 3) if length else slice(1, 3)
    torch.testing.assert_close(out[rows], want[rows], rtol=1e-5, atol=1e-5)
    s = torch.einsum("bhgd,bkhd->bhgk", q.reshape(3, 2, 3, 16), k) / 4.0
    valid = torch.arange(40)[None, :] < lens[:, None]
    s = torch.where(valid[:, None, None], s, -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(3, 6))
    if length == 0:
        assert torch.isneginf(lse[0]).all() and (out[0] == 0).all()


def test_serving_refusals_on_a_mesh():
    """Only a mesh of another device type is refused: an engine builds on
    an ``AbstractMesh`` for every ported config, the MoE and hybrid ones
    included, with and without ``quantize_weights``
    (``tests/test_torch_sharded_moe_serve.py`` runs them)."""
    mesh = AbstractMesh((2, 2), ("data", "model"))
    for arch in PORTED_ARCHS:
        for int8 in (False, True):
            eng = ServingEngine(smoke_config(get_config(arch)),
                                ServeConfig(quantize_weights=int8),
                                mesh=mesh, device="cpu")
            assert eng.mesh is mesh
    cfg = smoke_config(get_config(ARCHS[0]))

    class CudaMesh:
        device_type = "cuda"
    with pytest.raises(ValueError, match="mesh"):
        ServingEngine(cfg, mesh=CudaMesh(), device="cpu")
