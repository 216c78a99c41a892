"""``repro_torch.launch.dryrun.run_cells``, the runner behind ``--all``
and ``chip_smoke.py``'s dry-run phase, on the CPU: each cell traced by
the module's CLI in a process of its own, its result file written, and a
cell past its time limit stopped."""
import json
import os

from repro_torch.launch import dryrun

TAG = "test_run_cells"
# Full width, one layer: a few seconds a cell on a CPU mesh.
ONE_LAYER = json.dumps({"model_overrides": {"num_layers": 1}})
CELLS = [("mamba2-130m", "decode_32k", False),
         ("internlm2-1.8b", "decode_32k", True)]


def test_two_cells_each_in_a_process_of_its_own():
    paths = [dryrun.result_path(*cell, TAG) for cell in CELLS]
    try:
        done = list(dryrun.run_cells(CELLS, device="cpu", probes=False,
                                     tag=TAG, opts=ONE_LAYER))
        assert sorted(cell for cell, _, _ in done) == sorted(CELLS)
        for cell, rc, out in done:
            assert rc == 0, out
            assert "dry-run complete: all cells traced." in out
        for (arch, shape, multi), path in zip(CELLS, paths):
            with open(path) as f:
                res = json.load(f)
            assert (res["arch"], res["shape"]) == (arch, shape)
            assert res["mesh"] == ("pod2x16x16" if multi else "pod16x16")
            assert res["chips"] == (512 if multi else 256)
            assert res["cost_analysis"]["kernel_calls"] == {}
            assert res["memory_analysis"]["argument_size_in_bytes"] > 0
    finally:
        for path in paths:
            if os.path.exists(path):
                os.remove(path)


def test_a_cell_past_its_time_limit_is_stopped():
    cell = CELLS[0]
    (got, rc, _), = dryrun.run_cells([cell], device="cpu", probes=False,
                                     tag=TAG, opts=ONE_LAYER, timeout=0.5)
    assert got == cell and rc is None
    assert not os.path.exists(dryrun.result_path(*cell, TAG))


def test_a_cell_with_opts_of_its_own_keeps_its_own_file():
    """A cell's fourth item, its own opts (here gemma-2b's heads at one
    layer through ``model_overrides``), is traced under its own tag:
    beside the plain cell of the same arch, shape and mesh."""
    heads = {"model_overrides": {"num_layers": 1, "num_heads": 8,
                                 "num_kv_heads": 1, "head_dim": 256}}
    cells = [CELLS[1][:2] + (False,), CELLS[1][:2] + (False, heads)]
    tags = [dryrun.cell_tag(TAG), dryrun.cell_tag(TAG, heads)]
    assert tags[0] == TAG and tags[1] != TAG
    assert dryrun.cell_tag(TAG, dict(heads)) == tags[1]
    paths = [dryrun.result_path(*c[:3], t) for c, t in zip(cells, tags)]
    try:
        done = list(dryrun.run_cells(cells, device="cpu", probes=False,
                                     tag=TAG, opts=ONE_LAYER))
        assert all(rc == 0 for _, rc, _ in done)
        res = []
        for path in paths:
            with open(path) as f:
                res.append(json.load(f))
        # one kv head of 256 against internlm2's 8 of 128: a smaller
        # cache and k, v projections at the same depth
        args = [r["memory_analysis"]["argument_size_in_bytes"] for r in res]
        assert 0 < args[1] < args[0]
        assert res[0]["cost_analysis"]["kernel_calls"] == \
            res[1]["cost_analysis"]["kernel_calls"] == {}
    finally:
        for path in paths:
            if os.path.exists(path):
                os.remove(path)
