"""The dry run's recorder (``repro_torch.roofline.counter``) alone, on the
CPU: local FLOPs of a sharded matmul, the wire-byte rule of each
collective, the live-storage peak, the kernels' fake paths on fake CUDA
tensors, a traced step against a real one on a fake world of one, the
depth probes against the full-depth count, and full-width cells on the
production mesh, which allocate nothing."""
import resource

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import SHAPES, ShapeSpec, get_config, smoke_config
from repro_torch.distributed.sharding import serve_rules, train_rules
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import int8_matmul as kint8
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as krms
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.train import data_config
from repro_torch.models.transformer import block_period
from repro_torch.roofline import counter, kernel_cost
from repro_torch.roofline.analysis import wire_bytes
from repro_torch.roofline.counter import Recorder, local_bytes
from repro_torch.training.data import _gen_batch
from repro_torch.training.train_loop import Trainer


@pytest.fixture
def pod():
    """A fake world of 256 ranks and its 16 x 16 CPU mesh."""
    with fake_world(256):
        yield make_mesh((16, 16), ("data", "model"), device="cpu")


def _dt(local_shape, mesh, plc, dtype=torch.float32):
    return DTensor.from_local(torch.empty(local_shape, dtype=dtype), mesh,
                              plc, run_check=False)


def test_sharded_matmul_counts_rank0s_local_product(pod):
    """x (2048 x 4096, rows over data) @ w (4096 x 8192, columns over
    model): rank 0 multiplies 128 x 4096 by 4096 x 512; FlopCounterMode
    over the same DTensor call counts the global product, 256x that."""
    with FakeTensorMode():
        x = _dt((128, 4096), pod, [Shard(0), Replicate()])
        w = _dt((4096, 512), pod, [Replicate(), Shard(1)])
        with Recorder() as rec:
            y = x @ w
        with FlopCounterMode(display=False) as fc:
            x @ w
    assert y.placements == (Shard(0), Shard(1))
    assert rec.flops == 2 * 128 * 4096 * 512
    assert fc.get_total_flops() == 256 * rec.flops
    assert rec.bytes == 4 * (128 * 4096 + 4096 * 512 + 128 * 512)
    assert not rec.collectives.counts


@pytest.mark.parametrize("src,dst,kind,result,group", [
    # all-gather of a (64, 128) fp32 shard over model: a (1024, 128) result
    ([Replicate(), Shard(0)], [Replicate(), Replicate()], "all-gather",
     1024 * 128 * 4, 16),
    # all-reduce of a Partial over model: the result is the shard's size
    ([Replicate(), Partial()], [Replicate(), Replicate()], "all-reduce",
     64 * 128 * 4, 16),
    # reduce-scatter of a Partial over data into rows: 1/16 of it
    ([Partial(), Replicate()], [Shard(0), Replicate()], "reduce-scatter",
     4 * 128 * 4, 16),
    # Shard(0) -> Shard(1) over model is an all-to-all; a CPU mesh runs it
    # as an all-gather of the whole dim, then a chunk
    ([Replicate(), Shard(0)], [Replicate(), Shard(1)], "all-gather",
     1024 * 128 * 4, 16),
])
def test_collective_wire_bytes(pod, src, dst, kind, result, group):
    with FakeTensorMode():
        t = _dt((64, 128), pod, src)
        with Recorder() as rec:
            t.redistribute(pod, dst)
    st = rec.collectives
    assert st.counts == {kind: 1}
    assert st.result_bytes == {kind: result}
    assert st.wire_bytes == {kind: wire_bytes(kind, result, group)}
    want = {"all-gather": result * 15 / 16, "all-reduce": 2 * result * 15 / 16,
            "reduce-scatter": result * 15}[kind]
    assert st.total_wire_bytes == want


def test_temp_is_the_peak_of_live_storage():
    """Three 4 KiB tensors, one freed before the third: the peak holds
    two; views and in-place ops allocate nothing; a new output is left
    out of the temp peak when named."""
    with FakeTensorMode():
        arg = torch.empty(1024)
        with Recorder() as rec:
            a = arg * 2
            b = a + 1
            b.view(32, 32).add_(1)
            del a
            c = b * 3
    assert rec.temp_bytes() == 2 * 4096
    assert rec.temp_bytes([c]) == 2 * 4096
    assert rec.temp_bytes([b, c]) == 4096
    mem = rec.memory_analysis(args=(arg,), outputs=(arg, c), aliased=(arg,))
    assert mem["argument_size_in_bytes"] == 4096
    assert mem["output_size_in_bytes"] == 2 * 4096
    assert mem["alias_size_in_bytes"] == 4096
    assert mem["temp_size_in_bytes"] == 2 * 4096
    assert mem["total_nonalias_bytes"] == 4 * 4096
    f32 = torch.float32
    assert rec.peak_storages() == (2 * 4096, [
        (4096, "aten.mul.Tensor", (1024,), f32),
        (4096, "aten.add.Tensor", (1024,), f32)])
    assert rec.peak_storages([b, c]) == (4096, [
        (4096, "aten.mul.Tensor", (1024,), f32)])


def test_peak_storages_name_what_a_traced_step_holds_at_its_peak():
    """internlm2's smoke config, one train step traced on a fake world of
    one: the storages live at the peak add up to ``temp_size_in_bytes``
    (new outputs set aside as it sets them aside), largest first, each
    named by the aten op that allocated it."""
    cfg, shape = _smoke_train()
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        traced, _, _ = dryrun._lower_cell(cfg, shape, mesh, opts={},
                                          scan=True)
    mem = dryrun._memory_analysis_dict(traced)
    arg_keys = {id(t.untyped_storage())
                for t in counter.local_tensors(traced.args)}
    new_outs = [t for t in counter.local_tensors(traced.outputs)
                if id(t.untyped_storage()) not in arg_keys]
    peak, live = traced.recorder.peak_storages(new_outs)
    assert peak == mem["temp_size_in_bytes"] > 0
    assert sum(n for n, *_ in live) == peak
    assert [n for n, *_ in live] == sorted((n for n, *_ in live),
                                           reverse=True)
    assert all(op.startswith("aten.") or op.startswith("_c10d")
               for _, op, _, _ in live)
    assert traced.recorder.peak_storages()[0] >= peak


def _cuda(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="cuda")


def _refuse(*_, **__):
    raise AssertionError("a fake CUDA tensor took the plain path")


def test_fake_cuda_tensors_take_each_kernels_fake_path(monkeypatch):
    """Every kernel and backward kernel on fake CUDA tensors: outputs of
    the kernel's shapes and dtypes on the fake card, one call each with
    its kernel_cost counted, never the plain path, a pointer or a launch.
    (Autograd needs a CUDA build to run on fake CUDA tensors, so the
    backward kernels are called as their Functions call them.)"""
    for mod in (krms, kflash, kdec, kssd, kint8):
        monkeypatch.setattr(mod, "plain", _refuse)
    for mod in (krms, kflash, kssd):
        monkeypatch.setattr(mod, "plain_bwd", _refuse)
    monkeypatch.setattr(torch.Tensor, "data_ptr", _refuse)
    before = ops.launch_counts()
    with FakeTensorMode():
        x, w = _cuda(8, 64), _cuda(64, dtype=torch.float32)
        q, k = _cuda(2, 16, 4, 64), _cuda(2, 16, 2, 64)
        q1, length = _cuda(2, 4, 64), _cuda(2, dtype=torch.int32)
        xs, dt = _cuda(1, 64, 4, 16), _cuda(1, 64, 4, dtype=torch.float32)
        A, bc = _cuda(4, dtype=torch.float32), _cuda(1, 64, 16)
        xq, wq = (_cuda(4, 32, dtype=torch.int8),
                  _cuda(32, 8, dtype=torch.int8))
        with Recorder() as rec:
            outs = [ops.rmsnorm(x, w),
                    *krms._kernel_backward(x, w, x, 1e-5),
                    ops.attention(q, k, k),
                    *kflash._kernel_forward(q, k, k, True, 0.125,
                                            with_lse=True)]
            outs += kflash._kernel_backward(q, k, k, q, q, outs[-1], True,
                                            0.125)
            outs += [ops.decode_attention(q1, k, k, length),
                     *kdec.decode_attention(q1, k, k, length,
                                            return_lse=True)]
            outs += ops.ssd(xs, dt, A, bc, bc, A, chunk=64)
            outs += kssd._kernel_backward(xs, dt, A, bc, bc, A, xs, None,
                                          chunk=64)
            outs.append(kint8.int8_matmul(xq, A, wq, _cuda(
                8, dtype=torch.float32), torch.bfloat16))
    assert ops.launch_counts() == before
    assert all(t.device.type == "cuda" for t in outs)
    assert [tuple(t.shape) for t in outs[:4]] == [(8, 64), (8, 64), (64,),
                                                 (2, 16, 4, 64)]
    assert outs[5].shape == (2, 4, 16) and outs[5].dtype == torch.float32
    assert outs[-1].shape == (4, 8) and outs[-1].dtype == torch.bfloat16
    assert rec.kernel_calls() == {
        "decode_attention": 2, "flash_attention": 2,
        "flash_attention_bwd": 1, "int8_matmul": 1, "rmsnorm": 1,
        "rmsnorm_bwd": 1, "ssd_scan": 1, "ssd_scan_bwd": 1}
    bf16 = torch.bfloat16
    want = [kernel_cost.rmsnorm(8, 64, 2), kernel_cost.rmsnorm_bwd(8, 64, 2),
            kernel_cost.flash(2, 16, 16, 4, 2, 64, bf16),
            kernel_cost.flash(2, 16, 16, 4, 2, 64, bf16, lse=True),
            kernel_cost.flash_bwd(2, 16, 16, 4, 2, 64, bf16),
            kernel_cost.decode(2, 4, 2, 64, 2 * 16, bf16),
            kernel_cost.decode(2, 4, 2, 64, 2 * 16, bf16, lse=True),
            kernel_cost.ssd(1, 64, 4, 16, 16, bf16, 64),
            kernel_cost.ssd_bwd(1, 64, 4, 16, 16, bf16, 64, False),
            kernel_cost.int8_matmul(4, 32, 8, bf16)]
    assert rec.kernel_flops == sum(c.ops for c in want)
    assert rec.kernel_bytes == sum(c.bytes for c in want)
    assert rec.flops == 0


def test_fake_cuda_call_checks_shapes_as_the_card_does():
    """The fake path refuses what the card refuses (head dim 0) and takes
    what it takes (257, on the column-tile kernel)."""
    with FakeTensorMode():
        q, k = _cuda(1, 8, 2, 0), _cuda(1, 8, 2, 0)
        with pytest.raises(ValueError, match="head_dim 0"):
            kflash.flash_attention(q, k, k)
        q, k = _cuda(1, 8, 2, 257), _cuda(1, 8, 2, 257)
        assert tuple(kflash.flash_attention(q, k, k).shape) == (1, 8, 2, 257)


def test_fake_rmsnorm_backward_under_lowp_at_any_width(monkeypatch):
    """The rmsnorm backward's fake path under lowp and at a row no ring or
    block_rows plan takes (20000 bf16): one call each at
    ``kernel_cost.rmsnorm_bwd``, never the plain path."""
    monkeypatch.setattr(krms, "plain_bwd", _refuse)
    with FakeTensorMode():
        x, w = _cuda(8, 20000), _cuda(20000, dtype=torch.float32)
        x2, w2 = _cuda(8, 2048), _cuda(2048, dtype=torch.float32)
        with Recorder() as rec:
            dx, dw = krms._kernel_backward(x, w, x, 1e-5, lowp=True)
            krms._kernel_backward(x2, w2, x2, 1e-5, lowp=True)
    assert tuple(dx.shape) == (8, 20000) and dw.dtype == torch.float32
    assert rec.kernel_calls() == {"rmsnorm_bwd": 2}
    assert rec.kernel_bytes == kernel_cost.rmsnorm_bwd(8, 20000, 2).bytes + \
        kernel_cost.rmsnorm_bwd(8, 2048, 2).bytes


def _smoke_train(arch="internlm2-1.8b"):
    cfg = smoke_config(get_config(arch))
    return cfg, ShapeSpec("train_4k", 32, 4, "train")


def test_traced_flops_equal_a_real_step_on_a_world_of_one():
    """On a fake world of one, the traced step's FLOPs (a CPU mesh: the
    plain versions' aten ops) equal FlopCounterMode's over a real CPU
    step of the same Trainer, exactly; its argument bytes are the bytes
    the Trainer's params, optimizer state and batch hold."""
    cfg, shape = _smoke_train()
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        traced, _, _ = dryrun._lower_cell(cfg, shape, mesh, opts={},
                                          scan=True)
        cost, _ = dryrun._cost_and_collectives(traced)
        mem = dryrun._memory_analysis_dict(traced)
        trainer = Trainer(cfg, S.default_train_config(cfg), mesh=mesh,
                          device="cpu")
        params, opt_state, _ = trainer.init_state(0)
        batch = trainer._place(_gen_batch(data_config(
            cfg, shape.seq_len, shape.global_batch), 0))
        args = local_bytes((params, opt_state, batch))
        with FlopCounterMode(display=False) as fc:
            trainer.step_fn(params, opt_state, batch)
    assert cost["kernel_flops"] == 0 and cost["kernel_calls"] == {}
    assert cost["flops"] == fc.get_total_flops() > 0
    assert mem["argument_size_in_bytes"] == args


def test_depth_probes_extrapolate_to_the_full_depth_count():
    """The JAX package's extrapolation (``dryrun.py:216``), mb x (x1 +
    (nb - 1) x (x2 - x1)), of the depth-p and 2p probes reproduces the
    full-depth trace's FLOPs for internlm2's smoke config (4 layers)."""
    cfg, shape = _smoke_train()
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        res = dryrun._cell("internlm2-1.8b", cfg, shape, mesh, "pod2x4",
                           opts={}, probes=True, verbose=False)
    p = res["probe"]
    x1, x2, nb, mb = (p["probe1_flops"], p["probe2_flops"], p["blocks"],
                      p["mb_multiplier"])
    assert (p["period"], nb, mb) == (1, 4, 1)
    assert mb * (x1 + (nb - 1) * max(x2 - x1, 0.0)) == \
        res["cost_analysis"]["flops"]


@pytest.mark.parametrize("shape_name", ["decode_32k", "train_4k"])
def test_full_width_on_the_production_mesh(shape_name):
    """internlm2-1.8b at full width on pod16x16 (a CPU mesh): the argument
    bytes are the local shard bytes of the leaves ``launch/specs.py``
    places, and the trace allocates nothing of the model's size."""
    cfg, shape = get_config("internlm2-1.8b"), SHAPES[shape_name]
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    with fake_world(256):
        mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        traced, kind, _ = dryrun._lower_cell(cfg, shape, mesh, opts={},
                                             scan=True)
        mem = dryrun._memory_analysis_dict(traced)
        if kind == "train":
            rules = train_rules()
            opt_sh, opt_meta = S.opt_shardings(
                cfg, S.default_train_config(cfg), mesh, rules)
            batch = S.train_batch_specs(cfg, shape)
            trees = [(S.lm.param_shapes(cfg),
                      S.params_shardings(cfg, mesh, rules)),
                     (opt_meta, opt_sh),
                     (batch, S.batch_shardings(batch, mesh, rules))]
        else:
            rules = serve_rules(S.default_serve_config(cfg,
                                                         shape).serve_fsdp)
            tok, caches, _ = S.decode_input_specs(cfg, shape)
            trees = [(S.lm.param_shapes(cfg),
                      S.params_shardings(cfg, mesh, rules)),
                     (caches, S.cache_shardings(cfg, caches, mesh, rules))]
    want = 0
    for meta, shardings in trees:
        with FakeTensorMode():
            want += local_bytes(dryrun._fake(meta, shardings))
    if kind == "decode":    # the tokens (8 of 128 rows a rank) and pos
        want += 8 * 4 + 4
    assert mem["argument_size_in_bytes"] == want
    assert mem["temp_size_in_bytes"] > 0
    grown_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss
    assert grown_kib * 1024 < mem["argument_size_in_bytes"] + \
        mem["temp_size_in_bytes"]


# What the production mesh showed in the port's model steps, each now
# done on local shards: a projection whose columns DTensor split into
# pieces of heads (8 kv heads over a model axis of 16), the picked logit
# and the embedding lookup on vocab shards (gathered whole before), and
# a tied embedding's two gradients summed in its own placements. Held on
# 4 gloo ranks, a (1, 4) mesh, against the same ops on whole tensors.
LOCAL_SHARD_CODE = """
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.mesh import make_mesh
from repro_torch.distributed.sharding import own_grad, whole_heads
from repro_torch.models.layers import _lookup
from repro_torch.models.model import _pick
mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
def dt(t, plc):
    return DTensor.from_local(t.chunk(4, dim=plc[1].dim)[rank]
                              if isinstance(plc[1], Shard) else t,
                              mesh, plc, run_check=False).requires_grad_()
R, S = Replicate(), Shard
rep = lambda t: DTensor.from_local(t, mesh, [R, R], run_check=False)
g = torch.Generator().manual_seed(0)
y_full = torch.randn(2, 3, 8, generator=g)      # (b, s, h * k), h 2, k 4
coef = torch.randn(2, 3, 2, 4, generator=g)
y = dt(y_full, (R, S(2)))                       # 2 columns a rank
yw = whole_heads(y, 2)
out["whole_plc"] = int(all(p == R for p in yw.placements))
(yw.reshape(2, 3, 2, 4) * rep(coef)).sum().backward()
out["whole"] = yw.full_tensor().detach().numpy()
out["whole_grad"] = y.grad.full_tensor().numpy()
logits_full = torch.randn(2, 3, 8, generator=g)  # vocab 8, 2 a rank
labels = torch.tensor([[0, 3, 7], [5, 2, 6]])
logits = dt(logits_full, (R, S(2)))
lab = rep(labels[..., None])
picked = _pick(logits, lab)
picked.sum().backward()
out["picked"] = picked.full_tensor().detach().numpy()
out["picked_grad"] = logits.grad.full_tensor().numpy()
table_full = torch.randn(8, 3, generator=g)      # vocab 8 over model
table = dt(table_full, (R, S(0)))
tok = rep(labels)
w = torch.randn(2, 3, 3, generator=g)
look = _lookup(table, tok)
tied = torch.matmul(look, own_grad(table).t())   # a tied unembedding
((look * rep(w)).sum() + tied.sum()).backward()
out["lookup"] = look.full_tensor().detach().numpy()
out["table_grad"] = table.grad.full_tensor().numpy()
out["grad_plc"] = int(tuple(table.grad.placements) == (R, S(0)))
"""


def test_local_shard_ops_equal_whole_tensor_ops(tmp_path):
    from torch_gloo import run_ranks
    outs = run_ranks(LOCAL_SHARD_CODE, 4, tmp_path)
    g = torch.Generator().manual_seed(0)
    y = torch.randn(2, 3, 8, generator=g)
    coef = torch.randn(2, 3, 2, 4, generator=g)
    logits = torch.randn(2, 3, 8, generator=g).requires_grad_()
    labels = torch.tensor([[0, 3, 7], [5, 2, 6]])
    table = torch.randn(8, 3, generator=g).requires_grad_()
    w = torch.randn(2, 3, 3, generator=g)
    picked = torch.gather(logits, -1, labels[..., None])
    picked.sum().backward()
    look = table[labels]
    ((look * w).sum() + torch.matmul(look, table.t()).sum()).backward()
    for o in outs:
        assert o["whole_plc"] == 1 and o["grad_plc"] == 1
        assert torch.equal(torch.from_numpy(o["whole"]), y)
        assert torch.equal(torch.from_numpy(o["whole_grad"]),
                           coef.reshape(2, 3, 8))
        assert torch.equal(torch.from_numpy(o["picked"]), picked.detach())
        assert torch.equal(torch.from_numpy(o["picked_grad"]), logits.grad)
        assert torch.equal(torch.from_numpy(o["lookup"]), look.detach())
        torch.testing.assert_close(torch.from_numpy(o["table_grad"]),
                                   table.grad, rtol=1e-6, atol=1e-6)


# What the production mesh showed where the model axis divides neither
# the heads nor the vocab, each now done on whole heads or local rows: a
# flattened (h * k) tensor whose gradient a product hands back in pieces
# of heads (3 heads of 4 over a model axis of 2), and the unembedding of
# a table whose vocab stays whole (gathered over the batch on every rank
# before), tied and untied. Held on 4 gloo ranks, a (2, 2) mesh, against
# the same ops on whole tensors.
UNEVEN_LOCAL_SHARD_CODE = """
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.mesh import make_mesh
from repro_torch.distributed.sharding import whole_heads_grad
from repro_torch.models.layers import unembed_apply
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
R, S = Replicate(), Shard
coord = mesh.get_coordinate()
def dt(t, plc):
    for i, p in enumerate(plc):
        if isinstance(p, Shard):
            t = t.chunk(2, dim=p.dim)[coord[i]]
    return DTensor.from_local(t.contiguous(), mesh, plc,
                              run_check=False).requires_grad_()
g = torch.Generator().manual_seed(0)
y_full = torch.randn(4, 3, 3, 4, generator=g)    # (b, s, h, k), h 3, k 4
w_full = torch.randn(12, 5, generator=g)         # (h * k, d)
for fix in (True, False):
    y = dt(y_full, (S(0), R))                     # rows over data
    w = dt(w_full, (R, S(0)))                     # columns over model
    flat = y.reshape(4, 3, 12)
    if fix:
        flat = whole_heads_grad(flat, 3)
    try:
        (flat @ w).sum().backward()
        out[f"heads_ok{int(fix)}"] = 1
        out[f"heads_grad{int(fix)}"] = y.grad.full_tensor().numpy()
    except RuntimeError as e:
        out[f"heads_ok{int(fix)}"] = int("unevenly" not in str(e)) + 2
x_full = torch.randn(4, 3, 6, generator=g)       # (b, s, d)
table_full = torch.randn(10, 6, generator=g)     # vocab 10, d 6
coef = torch.randn(4, 3, 10, generator=g)
for tied in (True, False):
    x = dt(x_full, (S(0), R))
    if tied:
        table = dt(table_full, (S(1), R))         # d over data (fsdp)
        params = {"embedding": table}
    else:
        table = dt(table_full.t(), (S(0), R))
        params = {"embedding": dt(table_full, (S(1), R)), "unembed": table}
    logits = unembed_apply(params, x)
    (logits * DTensor.from_local(coef, mesh, [R, R], run_check=False)
     ).sum().backward()
    t = "tied" if tied else "untied"
    out[f"{t}_logits"] = logits.full_tensor().detach().numpy()
    out[f"{t}_plc"] = int(tuple(logits.placements) == (S(0), R))
    out[f"{t}_x_grad"] = x.grad.full_tensor().numpy()
    out[f"{t}_w_grad"] = table.grad.full_tensor().numpy()
    out[f"{t}_grad_plc"] = int(tuple(table.grad.placements) ==
                               tuple(table.placements))
"""


def test_uneven_local_shard_ops_equal_whole_tensor_ops(tmp_path):
    from torch_gloo import run_ranks
    outs = run_ranks(UNEVEN_LOCAL_SHARD_CODE, 4, tmp_path)
    g = torch.Generator().manual_seed(0)
    y = torch.randn(4, 3, 3, 4, generator=g).requires_grad_()
    w = torch.randn(12, 5, generator=g)
    (y.reshape(4, 3, 12) @ w).sum().backward()
    x = torch.randn(4, 3, 6, generator=g)
    table = torch.randn(10, 6, generator=g)
    coef = torch.randn(4, 3, 10, generator=g)
    want = {}
    for t in ("tied", "untied"):
        xl = x.clone().requires_grad_()
        tl = table.clone().requires_grad_()
        logits = xl @ tl.t()
        (logits * coef).sum().backward()
        want[t] = (logits.detach(), xl.grad,
                   tl.grad if t == "tied" else tl.grad.t())
    for o in outs:
        # the flattened heads: DTensor's own view backward refuses the
        # gradient's split, the repaired one matches whole tensors
        assert o["heads_ok0"] == 2 and o["heads_ok1"] == 1
        torch.testing.assert_close(torch.from_numpy(o["heads_grad1"]),
                                   y.grad, rtol=1e-6, atol=1e-6)
        for t in ("tied", "untied"):
            assert o[f"{t}_plc"] == 1 and o[f"{t}_grad_plc"] == 1
            for got, ref in zip((o[f"{t}_logits"], o[f"{t}_x_grad"],
                                 o[f"{t}_w_grad"]), want[t]):
                torch.testing.assert_close(torch.from_numpy(got), ref,
                                           rtol=1e-6, atol=1e-6)


def _one_period_train_cell(arch):
    """``arch`` at full width, its depth cut to one block period, at
    train_4k on pod16x16 (a CPU mesh): the traced step's memory
    analysis."""
    cfg = get_config(arch)
    cfg = dryrun._probe_cfg(cfg, block_period(cfg))
    with fake_world(256):
        mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        traced, kind, _ = dryrun._lower_cell(cfg, SHAPES["train_4k"], mesh,
                                             opts={}, scan=True)
    assert kind == "train"
    return dryrun._memory_analysis_dict(traced)


@pytest.mark.parametrize("arch", ["internvl2-1b", "mamba2-130m",
                                  "phi3-medium-14b"])
def test_uneven_heads_train_cells_trace_on_the_production_mesh(arch):
    """14 q heads, 24 Mamba heads and 40 q heads over a model axis of 16:
    the backward of each flattened heads tensor unflattened DTensor's
    split of its gradient, which failed the trace before
    ``whole_heads_grad``."""
    mem = _one_period_train_cell(arch)
    assert mem["temp_size_in_bytes"] > 0


def test_lowp_train_cell_traces_on_the_production_mesh():
    """internlm2-1.8b's train_4k cell with ``mlp_lowp`` (every norm's
    backward under the flag) at one block period on the 16 x 16 CPU
    mesh, as the reference's dry run traces it."""
    cfg = get_config("internlm2-1.8b").replace(mlp_lowp=True)
    cfg = dryrun._probe_cfg(cfg, block_period(cfg))
    with fake_world(256):
        mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        traced, kind, _ = dryrun._lower_cell(cfg, SHAPES["train_4k"], mesh,
                                             opts={}, scan=True)
    assert kind == "train"
    assert dryrun._memory_analysis_dict(traced)["temp_size_in_bytes"] > 0


def test_granite_unembedding_keeps_to_its_own_rows():
    """granite-moe's tied table (vocab 49155, whole over the model axis):
    its logits and their gradient stay on each rank's 16 of the 256 rows,
    the temp peak below a quarter of the global batch's fp32 logits
    (243 GiB a chip before, the global (256, 4096, 49155) gradient)."""
    mem = _one_period_train_cell("granite-moe-1b-a400m")
    assert mem["temp_size_in_bytes"] < 256 * 4096 * 49155 * 4 / 4
