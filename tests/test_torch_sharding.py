"""The port's logical-axis sharding against the JAX package's, on the CPU
and without ranks (abstract meshes).

* ``tests/test_sharding_rules.py``'s cases, and its resolver properties
  over seeded random draws (hypothesis is not needed), on the port's
  resolver, each spec also equal to JAX's.
* For every ported arch at full width, on (16, 16), (2, 16, 16) and
  (2, 4, 8) meshes, under ``train_rules`` and ``serve_rules`` with each
  ``serve_fsdp`` and ``batch1``: the port's spec of every param, opt-state
  (fp32 and int8 moments), cache and batch leaf equals JAX's, and so does
  its local shard shape (JAX's ``NamedSharding.shard_shape``). The port
  keeps one tree a layer where JAX stacks each block position with a
  leading ``None`` dim, so layer ``i``'s leaf is held to JAX's position
  ``i % period`` leaf less that dim.
* The entry points of ``launch/specs.py`` give the placements of those
  specs; ``placements`` maps specs to ``Shard``/``Replicate`` and refuses
  a multi-axis dim out of mesh order; the mesh constructors refuse a
  missing card and a world of the wrong size.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

import repro.config as jconfig
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import model as jlm
from repro.models.transformer import block_period
from repro.training import optimizer as jopt
from repro_torch.config import ShapeSpec, TrainConfig, get_config
from repro_torch.configs import PORTED_ARCHS
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.models import model as tlm
from repro_torch.training.optimizer import init_opt_state, opt_state_specs

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4x8": ((2, 4, 8), ("pod", "data", "model"))}
RULES = {"train": lambda m: m.train_rules(),
         "serve": lambda m: m.serve_rules(False, False),
         "serve_fsdp": lambda m: m.serve_rules(True, False),
         "serve_batch1": lambda m: m.serve_rules(False, True),
         "serve_fsdp_batch1": lambda m: m.serve_rules(True, True)}
TRAIN = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG = ShapeSpec("long_500k", 524288, 1, "decode")
OPT_DTYPES = ("fp32", "int8")
SMALL_MESH = tsh.AbstractMesh((2, 4, 8), ("pod", "data", "model"))
JSMALL_MESH = JAbstractMesh((2, 4, 8), ("pod", "data", "model"))


def _jshape(s: ShapeSpec):
    return jconfig.ShapeSpec(s.name, s.seq_len, s.global_batch, s.kind)


# ---------------------------------------------------------------------------
# Trees as {path: leaf}, in the port's layout.
# ---------------------------------------------------------------------------
def _port_flat(tree, prefix=()):
    """Paths of the port's trees: dict keys, list indices, NamedTuple
    fields, ``children()`` indices."""
    if tsh.is_spec(tree) or isinstance(tree, (torch.Tensor,
                                              tsh.NamedSharding)):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "children"):
        items = enumerate(tree.children())
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_flat(v, (*prefix, str(k))))
    return out


def _key(k):
    for a in ("key", "idx", "name"):
        if hasattr(k, a):
            return str(getattr(k, a))
    raise TypeError(k)


def _jax_flat(tree, cfg, is_leaf=None):
    """JAX's tree as {port path: (leaf, stacked)}: ``blocks/j/...`` is
    listed under ``layers/i/...`` for every layer i at position j; the
    list of per-position caches likewise."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    p = block_period(cfg)
    out = {}
    for path, leaf in flat:
        keys = tuple(_key(k) for k in path)
        if "blocks" in keys or keys[0].isdigit():
            at = keys.index("blocks") + 1 if "blocks" in keys else 0
            j = int(keys[at])
            for i in range(j, cfg.num_layers, p):
                k = (*keys[:at], str(i), *keys[at + 1:])
                out[tuple("layers" if x == "blocks" else x
                          for x in k)] = (leaf, True)
        else:
            out[keys] = (leaf, False)
    return out


def _strip(spec, stacked):
    """JAX's spec of a stacked leaf, less its leading ``None``."""
    t = tuple(spec)
    if stacked and t:
        assert t[0] is None, t
        return t[1:]
    return t


# ---------------------------------------------------------------------------
# Both packages' stand-ins and logical specs, once per arch.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    cfg = jconfig.get_config(arch)
    params = jlm.param_shapes(cfg)
    trees = {"params": (params, jlm.param_specs(cfg))}
    for dt in OPT_DTYPES:
        tcfg = jconfig.TrainConfig(opt_state_dtype=dt)
        trees[f"opt_{dt}"] = (
            jax.eval_shape(lambda p, t=tcfg: jopt.init_opt_state(p, t),
                           params),
            jopt.opt_state_specs(jlm.param_specs(cfg), tcfg))
    for name, shape in (("decode", DECODE), ("long", LONG)):
        tokens, caches, _ = jspecs.decode_input_specs(cfg, _jshape(shape))
        trees[f"cache_{name}"] = (caches, jlm.cache_specs(cfg))
        trees[f"tokens_{name}"] = ({"tokens": tokens},
                                   {"tokens": jspecs.BATCH_LOGICAL["tokens"]})
    for name, fn, shape in (("train", jspecs.train_batch_specs, TRAIN),
                            ("prefill", jspecs.prefill_batch_specs,
                             PREFILL)):
        b = fn(cfg, _jshape(shape))
        trees[f"batch_{name}"] = (b, {k: jspecs.BATCH_LOGICAL[k] for k in b})
    return cfg, trees


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    cfg = get_config(arch)
    params = tlm.param_shapes(cfg)
    trees = {"params": (params, tlm.param_specs(cfg))}
    for dt in OPT_DTYPES:
        tcfg = TrainConfig(opt_state_dtype=dt)
        trees[f"opt_{dt}"] = (init_opt_state(params, tcfg),
                              opt_state_specs(tlm.param_specs(cfg), tcfg))
    for name, shape in (("decode", DECODE), ("long", LONG)):
        tokens, caches, _ = tspecs.decode_input_specs(cfg, shape)
        trees[f"cache_{name}"] = (caches, tlm.cache_specs(cfg))
        trees[f"tokens_{name}"] = ({"tokens": tokens},
                                   {"tokens": tspecs.BATCH_LOGICAL["tokens"]})
    for name, fn, shape in (("train", tspecs.train_batch_specs, TRAIN),
                            ("prefill", tspecs.prefill_batch_specs,
                             PREFILL)):
        b = fn(cfg, shape)
        trees[f"batch_{name}"] = (b, {k: tspecs.BATCH_LOGICAL[k] for k in b})
    return cfg, trees


def _is_jleaf(x):
    return isinstance(x, jax.ShapeDtypeStruct)


def _is_jspec(x):
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


@functools.lru_cache(maxsize=None)
def _leaves(arch):
    """{tree name: [(path, port leaf, port logical, JAX leaf, JAX
    logical, stacked)]}, with the port's and JAX's shapes and dtypes
    checked equal (less the stacking dim)."""
    jcfg, jtrees = _jax_trees(arch)
    _, ttrees = _port_trees(arch)
    assert jtrees.keys() == ttrees.keys()
    out = {}
    for name, (tvals, tspecs_) in ttrees.items():
        jvals, jspecs_ = jtrees[name]
        jv = _jax_flat(jvals, jcfg, _is_jleaf)
        js = _jax_flat(jspecs_, jcfg, _is_jspec)
        tv, ts = _port_flat(tvals), _port_flat(tspecs_)
        assert tv.keys() == ts.keys() == jv.keys() == js.keys(), name
        rows = []
        for path, t in tv.items():
            (jleaf, stacked), (jlogical, _) = jv[path], js[path]
            assert tuple(t.shape) == jleaf.shape[stacked:], (name, path)
            assert str(t.dtype).removeprefix("torch.") == \
                str(jleaf.dtype), (name, path)
            rows.append((path, t, ts[path], jleaf, jlogical, stacked))
        out[name] = rows
    return out


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_every_leaf_spec_and_shard_equals_jax(arch, mesh, rules):
    shape, axes = MESHES[mesh]
    jmesh, tmesh = JAbstractMesh(shape, axes), tsh.AbstractMesh(shape, axes)
    jrules, trules = RULES[rules](jsh), RULES[rules](tsh)
    _, ttrees = _port_trees(arch)
    jax_side = {}       # (shape, logical) -> (spec, shard shape): layers repeat
    checked = 0
    for name, rows in _leaves(arch).items():
        shardings = _port_flat(tsh.tree_shardings(*ttrees[name], tmesh,
                                                  trules))
        for path, t, logical, jleaf, jlogical, stacked in rows:
            key = (jleaf.shape, tuple(jlogical))
            if key not in jax_side:
                want = jsh.resolve_spec(jleaf.shape, jlogical, jrules, jmesh)
                jax_side[key] = (want, JNamedSharding(jmesh, want)
                                 .shard_shape(jleaf.shape))
            want, jshard = jax_side[key]
            got = tsh.resolve_spec(t.shape, logical, trules, tmesh)
            assert got == _strip(want, stacked), (name, path, got, want)
            assert tsh.shard_shape(t.shape, got, tmesh) == \
                jshard[stacked:], (name, path)
            assert shardings[path].placements == \
                tsh.placements(got, tmesh), (name, path)
            checked += 1
    assert checked > 20


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_launch_specs_entry_points_give_the_resolved_placements(arch):
    """``params_shardings``, ``opt_shardings``, ``batch_shardings`` and
    ``cache_shardings`` at the (2, 4, 8) mesh under train_rules: the
    placements of the specs the resolver gives for each leaf."""
    cfg, trees = _port_trees(arch)
    rules = tsh.train_rules()

    def check(shardings, key):
        vals, specs = trees[key]
        got = _port_flat(shardings)
        want = _port_flat(tsh.tree_shardings(vals, specs, SMALL_MESH, rules))
        assert got.keys() == want.keys()
        for path, s in got.items():
            assert s.mesh is SMALL_MESH
            assert s.placements == want[path].placements, (key, path)

    check(tspecs.params_shardings(cfg, SMALL_MESH, rules), "params")
    caches = trees["cache_decode"][0]
    check(tspecs.cache_shardings(cfg, caches, SMALL_MESH, rules),
          "cache_decode")
    batch = trees["batch_train"][0]
    check(tspecs.batch_shardings(batch, SMALL_MESH, rules), "batch_train")
    if cfg.num_params < 30e9:   # int8 stand-ins cost seconds at 400B
        sh, meta = tspecs.opt_shardings(cfg, TrainConfig(), SMALL_MESH,
                                        rules)
        check(sh, "opt_fp32")
        assert _port_flat(meta).keys() == _port_flat(
            trees["opt_fp32"][0]).keys()


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-130m"])
def test_param_shapes_are_meta_and_equal_jax(arch):
    jcfg, jtrees = _jax_trees(arch)
    _, ttrees = _port_trees(arch)
    tv = _port_flat(ttrees["params"][0])
    assert all(t.device.type == "meta" for t in tv.values())
    jv = _jax_flat(jtrees["params"][0], jcfg, _is_jleaf)
    for path, t in tv.items():
        leaf, stacked = jv[path]
        assert tuple(t.shape) == leaf.shape[stacked:]
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)


# ---------------------------------------------------------------------------
# tests/test_sharding_rules.py on the port's resolver.
# ---------------------------------------------------------------------------
CASES = [
    # divisibility fallback
    ({"heads": ("model",)}, (10,), ("heads",), ()),
    ({"heads": ("model",)}, (16,), ("heads",), ("model",)),
    # prefix greedy multi-axis
    ({"batch": ("pod", "data", "model")}, (8,), ("batch",),
     (("pod", "data"),)),
    ({"batch": ("pod", "data", "model")}, (64,), ("batch",),
     (("pod", "data", "model"),)),
    ({"batch": ("pod", "data", "model")}, (2,), ("batch",), ("pod",)),
    # no double use
    ({"a": ("model",), "b": ("model",)}, (8, 8), ("a", "b"), ("model",)),
    # unknown logical name replicates
    ({}, (128, 128), ("x", "y"), ()),
]


@pytest.mark.parametrize("rules,shape,logical,want", CASES)
def test_sharding_rules_cases(rules, shape, logical, want):
    got = tsh.resolve_spec(shape, logical, tsh.RuleSet(rules), SMALL_MESH)
    assert got == want
    assert got == tuple(jsh.resolve_spec(shape, logical, jsh.RuleSet(rules),
                                         JSMALL_MESH))


def test_serve_rules_batch1_shards_kvseq_everywhere():
    spec = tsh.resolve_spec((1, 524288, 8, 128),
                            ("batch", "kv_seq", "kv_heads_act", None),
                            tsh.serve_rules(False, batch1=True), SMALL_MESH)
    assert spec[1] == ("pod", "data", "model")
    assert tsh.placements(spec, SMALL_MESH) == (Shard(1),) * 3


@pytest.mark.parametrize("seed", range(8))
def test_resolver_properties(seed):
    """The hypothesis property of ``tests/test_sharding_rules.py`` over
    25 seeded draws each: no axis used twice, every assignment divides
    its dim, and the spec equals JAX's."""
    rng = np.random.default_rng(seed)
    dims_pool = [1, 2, 3, 4, 6, 8, 16, 30, 64]
    names_pool = ["batch", "heads_act", "mlp_act", "p_embed", "kv_seq", None]
    sizes = dict(zip(SMALL_MESH.axis_names, SMALL_MESH.axis_sizes))
    for _ in range(25):
        n = int(rng.integers(1, 5))
        dims = tuple(int(d) for d in rng.choice(dims_pool, n))
        names = tuple(names_pool[i] for i in rng.integers(0, 6, n))
        spec = tsh.resolve_spec(dims, names, tsh.train_rules(), SMALL_MESH)
        assert spec == tuple(jsh.resolve_spec(dims, names, jsh.train_rules(),
                                              JSMALL_MESH))
        used = []
        for i, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            prod = 1
            for a in axes:
                assert a not in used, "axis used twice"
                used.append(a)
                prod *= sizes[a]
            assert dims[i] % prod == 0, "non-dividing assignment"


def test_rule_tables_equal_jax():
    assert tsh.train_rules().rules == jsh.train_rules().rules
    for fsdp in (False, True):
        for b1 in (False, True):
            assert tsh.serve_rules(fsdp, b1).rules == \
                jsh.serve_rules(fsdp, b1).rules
    r = tsh.train_rules().override(seq=("model",))
    assert r.rules == jsh.train_rules().override(seq=("model",)).rules
    assert r.get(None) == () and r.get("nope") == ()


# ---------------------------------------------------------------------------
# Placements, named shardings, the context, the meshes.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec,want", [
    ((), (Replicate(), Replicate(), Replicate())),
    ((None, "model"), (Replicate(), Replicate(), Shard(1))),
    ((("pod", "data"), "model"), (Shard(0), Shard(0), Shard(1))),
    (("data", None, ("pod", "model")), (Shard(2), Shard(0), Shard(2))),
])
def test_placements_of_a_spec(spec, want):
    assert tsh.placements(spec, SMALL_MESH) == want


def test_placements_refuse_a_dim_out_of_mesh_order():
    with pytest.raises(ValueError, match="mesh's order"):
        tsh.placements((("data", "pod"),), SMALL_MESH)


def test_named_sharding_and_shard_without_a_mesh():
    assert tsh.named_sharding((8, 8), ("batch", "mlp_act")) is None
    x = torch.ones(4, 4)
    assert tsh.shard(x, ("batch", "mlp_act")) is x
    with tsh.use_sharding(SMALL_MESH, tsh.train_rules()):
        assert tsh.active_mesh() is SMALL_MESH
        ns = tsh.named_sharding((8, 8), ("batch", "mlp_act"))
        assert ns == tsh.NamedSharding(SMALL_MESH,
                                       (Shard(0), Shard(0), Shard(1)))
        assert tsh.shard(x, ("batch", "mlp_act")) is x     # not a DTensor
    assert tsh.active_mesh() is None
    assert jsh.named_sharding((8, 8), ("batch", "mlp_act")) is None


def test_shard_shape_equals_jax():
    spec = (("pod", "data"), None, "model")
    assert tsh.shard_shape((16, 3, 64), spec, SMALL_MESH) == \
        JNamedSharding(JSMALL_MESH, P(*spec)).shard_shape((16, 3, 64))


def test_mesh_constructors_refuse_a_missing_card_and_a_wrong_world(
        monkeypatch):
    from repro_torch.launch import mesh as tmesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_mesh((1,), ("model",))
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.make_mesh((2, 2), ("model",), device="cpu")
