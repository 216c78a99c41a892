"""The port's vision models (``repro_torch.models.{resnet,yolo}``) against
the JAX package's, on the CPU.

Both packages run the same weights: the JAX package's ``resnet_init`` /
``yolo_init`` pytree, with batch norm statistics and conv biases drawn from
a seed (the inits leave them at 1 and 0, where a wrong formula would not
show), moved over by ``repro_torch.convert``. Neither model has a width
knob, so the real widths run at small images (32-96 px), even and odd, so
that every stride-2 "SAME" case (asymmetric at even sizes, symmetric at
odd) is taken. Outputs are held to ``REL_TOL`` times the max-abs of the
reference's output; measured (seed 0): resnet-50 2e-6 and 3e-6,
resnet-152 5e-6, yolo 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.models import resnet as jresnet
from repro.models import yolo as jyolo
from repro_torch import convert
from repro_torch.models import resnet, yolo
from repro_torch.models.conv import conv2d_same, max_pool2d_same, same_pads
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")
REL_TOL = 1e-4


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# "SAME" padding against XLA's.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n, k, s, want", [
    (224, 7, 2, (2, 3)),        # ResNet stem
    (112, 3, 2, (0, 1)),        # ResNet max pool
    (56, 3, 2, (0, 1)),         # first block of a stage (also 28, 14)
    (56, 1, 2, (0, 0)),         # its 1x1 projection
    (320, 3, 2, (0, 1)),        # YOLO down (also 160, 80, 40)
    (640, 6, 2, (2, 2)),        # YOLO stem
    (65, 6, 2, (2, 3)),         # YOLO stem at an odd size
    (20, 5, 1, (2, 2)),         # SPPF pool
])
def test_same_pads_of_the_full_size_layers(n, k, s, want):
    assert same_pads(n, k, s) == want


SIZES = [(8, 11), (9, 14), (1, 2)]   # (h, w): each input one even, one odd


@pytest.mark.parametrize("hw", SIZES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 5, 6, 7])
def test_conv2d_same_matches_xla(k, s, hw):
    rng = np.random.default_rng(k * 10 + s)
    x = rng.standard_normal((2, *hw, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = conv2d_same(_nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1), s)
    assert got.shape == (2, 5, *np.asarray(want).shape[1:3])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", SIZES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 5, 6, 7])
def test_max_pool2d_same_matches_xla(k, s, hw):
    """Negative inputs, so that a pad of 0 in place of -inf would show."""
    rng = np.random.default_rng(k * 10 + s)
    x = -np.abs(rng.standard_normal((2, *hw, 3))).astype(np.float32) - 1
    want = lax.reduce_window(jnp.asarray(x), -jnp.inf, lax.max,
                             (1, k, k, 1), (1, s, s, 1), "SAME")
    got = max_pool2d_same(_nchw(x), k, s).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# The models.
# ---------------------------------------------------------------------------
def _perturb(tree, seed):
    """Batch norm statistics and conv biases drawn from ``seed`` (in
    place), so that the inference-form batch norm and the biases count."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, list):
            for v in t:
                walk(v)
            return
        if "var" in t:
            c = t["var"].shape
            t["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            t["bias"] = 0.1 * rng.standard_normal(c).astype(np.float32)
            t["mean"] = 0.1 * rng.standard_normal(c).astype(np.float32)
            t["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            return
        if "b" in t and "w" in t:
            t["b"] = 0.1 * rng.standard_normal(t["b"].shape).astype(
                np.float32)
            return
        for v in t.values():
            if isinstance(v, (dict, list)):
                walk(v)
    walk(tree)
    return tree


@pytest.fixture(scope="module")
def resnet_pair():
    """variant -> (JAX params, jitted JAX apply, the port's params), each
    variant built once."""
    pairs = {}

    def get(variant):
        if variant not in pairs:
            tree = _perturb(jax.tree.map(np.asarray, jresnet.resnet_init(
                jax.random.key(0), variant)), seed=1)
            pairs[variant] = (
                jax.tree.map(jnp.asarray, tree),
                jax.jit(lambda p, x: jresnet.resnet_apply(p, x, variant)),
                convert.from_jax_resnet_params(tree, CPU))
        return pairs[variant]
    return get


@pytest.fixture(scope="module")
def yolo_pair():
    tree = _perturb(jax.tree.map(np.asarray, jyolo.yolo_init(
        jax.random.key(0))), seed=1)
    return (jax.tree.map(jnp.asarray, tree), jax.jit(jyolo.yolo_apply),
            convert.from_jax_yolo_params(tree, CPU))


def _close(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    err = float(np.abs(got.numpy() - want).max())
    scale = float(np.abs(want).max())
    assert err <= REL_TOL * scale, (err, scale)
    return err


@pytest.mark.parametrize("variant, b, n", [("resnet-50", 2, 32),
                                           ("resnet-50", 1, 33),
                                           ("resnet-152", 1, 32)])
def test_resnet_apply_matches_jax(resnet_pair, variant, b, n):
    jparams, fn, params = resnet_pair(variant)
    x = np.random.default_rng(n).standard_normal((b, n, n, 3)).astype(
        np.float32)
    want = fn(jparams, jnp.asarray(x))
    got = resnet.resnet_apply(params, torch.from_numpy(x), variant)
    assert got.shape == (b, 1000)
    _close(got, want)
    assert (got.argmax(-1).numpy() == np.asarray(want).argmax(-1)).all()


@pytest.mark.parametrize("n", [64, 96, 65])
def test_yolo_apply_matches_jax(yolo_pair, n):
    jparams, fn, params = yolo_pair
    x = np.random.default_rng(n).standard_normal((1, n, n, 3)).astype(
        np.float32)
    got = yolo.yolo_apply(params, torch.from_numpy(x))
    assert got.shape == (1, -(-n // 32), -(-n // 32), 255)
    _close(got, fn(jparams, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# Weights: the converters and the port's own inits.
# ---------------------------------------------------------------------------
def _jax_tree(model):
    key = jax.random.key(3)
    if model == "yolov5x":
        return jax.tree.map(np.asarray, jyolo.yolo_init(key))
    return jax.tree.map(np.asarray, jresnet.resnet_init(key, model))


CONVERT = {"resnet-50": (convert.from_jax_resnet_params,
                         convert.to_jax_resnet_params),
           "resnet-152": (convert.from_jax_resnet_params,
                          convert.to_jax_resnet_params),
           "yolov5x": (convert.from_jax_yolo_params,
                       convert.to_jax_yolo_params)}
MODELS = list(CONVERT)


def _port_init(model, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if model == "yolov5x":
        return yolo.yolo_init(gen, device=CPU)
    return resnet.resnet_init(gen, model, device=CPU)


def _same_layout(a, b):
    """The same nested dicts (keys in any order; JAX sorts them) and
    lists, with leaves of the same shapes and dtypes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same_layout(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for u, v in zip(a, b):
            _same_layout(u, v)
    else:
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("model", MODELS)
def test_converter_round_trip_is_bitwise(model):
    from_jax, to_jax = CONVERT[model]
    tree = _jax_tree(model)
    params = from_jax(tree, CPU)
    for t in tree_leaves(params):
        assert t.device == CPU and t.dtype == torch.float32
        if t.dim() == 4:
            assert t.is_contiguous(memory_format=torch.channels_last)
    back = to_jax(params)
    _same_layout(back, tree)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    again = from_jax(back, CPU)
    for a, b in zip(tree_leaves(again), tree_leaves(params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", MODELS)
def test_port_init_has_the_jax_layout_and_scales(model):
    """Leaf for leaf the JAX pytree's structure, shapes and dtypes (once
    the convs are HWIO); each conv's std within 5 % of sqrt(2 / fan_in);
    ``fc`` at 0.01, batch norm at 1, 0, 0, 1, biases 0."""
    tree = _jax_tree(model)
    params = _port_init(model)
    _same_layout(CONVERT[model][1](params), tree)
    for t in tree_leaves(params):
        if t.dim() == 4:
            fan_in = t.shape[1] * t.shape[2] * t.shape[3]
            assert abs(t.std().item() / (2.0 / fan_in) ** 0.5 - 1) < 0.05
    if model == "yolov5x":
        for st in [params["stem"], params["head"]]:
            assert not st["b"].any()
    else:
        assert abs(params["fc"].std().item() / 0.01 - 1) < 0.05
        bn = params["stages"][0][0]["bn1"]
        assert bn["scale"].eq(1).all() and bn["var"].eq(1).all()
        assert not bn["bias"].any() and not bn["mean"].any()
    # the same seed gives the same weights
    for a, b in zip(tree_leaves(params), tree_leaves(_port_init(model))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", MODELS)
def test_init_refuses_a_missing_card(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator()
    with pytest.raises(RuntimeError, match="is_available"):
        if model == "yolov5x":
            yolo.yolo_init(gen, device="cuda")
        else:
            resnet.resnet_init(gen, model, device="cuda")


def test_resnet_flops_is_the_reference_count():
    """The reference's count (4.1e9 a ResNet-50 image, which is the
    published MAC count: ``workloads/dlserving.py`` counts 8.2e9 FLOPs),
    copied as it is."""
    for v in resnet.RESNET_LAYOUT:
        assert resnet.resnet_flops(v) == jresnet.resnet_flops(v)
    assert resnet.RESNET_LAYOUT == jresnet.RESNET_LAYOUT
    assert (yolo._WIDTHS, yolo._DEPTHS) == (jyolo._WIDTHS, jyolo._DEPTHS)
