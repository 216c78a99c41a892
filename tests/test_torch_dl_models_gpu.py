"""The vision models on the card against the same weights and images on
the CPU, in fp32 with TF32 off. Every test is marked ``gpu`` and skips
where there is no CUDA device; the file imports no JAX, so it runs on a
machine without it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_dl_models_gpu.py

cuDNN and the CPU sum each convolution in another order (and cuDNN may
take a Winograd or FFT algorithm), so the outputs are held to ``REL_TOL``
times the CPU output's max-abs, the card-vs-CPU bound of
``chip_smoke.py``'s parity phases; a ResNet's top class must agree.
"""
import pytest
import torch

from repro_torch.models import resnet, yolo
from repro_torch.tree import tree_map

REL_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


@pytest.mark.gpu
@pytest.mark.parametrize("model, b", [("resnet-50", 2), ("resnet-152", 1),
                                      ("yolov5x", 1)])
def test_card_matches_cpu_at_64_px(cuda, model, b):
    gen = torch.Generator().manual_seed(0)
    if model == "yolov5x":
        params = yolo.yolo_init(gen, device="cpu")
        apply = yolo.yolo_apply
    else:
        params = resnet.resnet_init(gen, model, device="cpu")
        apply = lambda p, x: resnet.resnet_apply(p, x, model)
    x = torch.randn((b, 64, 64, 3), generator=gen)
    want = apply(params, x)
    with torch.no_grad():
        got = apply(tree_map(lambda t: t.to(cuda), params), x.to(cuda))
    assert got.device.type == "cuda" and got.shape == want.shape
    got = got.cpu()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * want.abs().max().item()
    if model != "yolov5x":
        assert torch.equal(got.argmax(-1), want.argmax(-1))
