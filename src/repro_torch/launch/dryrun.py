"""The production-mesh dry run of the port: the JAX package's
``launch/dryrun.py``, traced where the original lowers and compiles.

    python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape decode_32k

For one (arch x shape x mesh) cell it builds the step the port would run on
a 16 x 16 (``pod16x16``) or 2 x 16 x 16 (``pod2x16x16``) mesh of cards:
``jit_train_step`` under ``train_rules()``, ``lm.prefill`` or
``lm.decode_step`` under ``serve_rules(...)``, at full width, on inputs laid
out by ``launch/specs.py``. The world is fake (``launch.mesh.fake_world``:
256 or 512 ranks in this process, this one rank 0) and so is every tensor:
each input is a DTensor built from a fake local shard, so no global tensor
is ever live and nothing is allocated. The step runs once, eagerly, under
``roofline.counter.Recorder``, which counts rank 0's local ops. That gives
what the original reads from XLA:

* ``cost_analysis``: FLOPs and HBM bytes per chip, of the aten ops and of
  the hand-written kernels apart (``aten_*``, ``kernel_*``,
  ``kernel_calls``). On a CUDA mesh (``--device cuda``, the default) each
  kernel call is counted by its fake path as the one kernel the card
  would launch, with ``roofline/kernel_cost.py``'s FLOPs and bytes; a
  decode call is counted as a read of the whole cache. On a CPU mesh
  (``--device cpu``, as the tests run it) the calls run the plain
  versions, as a CPU step runs them, and their aten ops are counted;
* ``memory_analysis``: the original's keys per chip (see
  ``Recorder.memory_analysis``); ``generated_code_size_in_bytes`` is 0;
* ``collectives``: counts and wire bytes by kind. On a CPU mesh DTensor
  runs an all-to-all as an all-gather and a chunk, and the counts say so
  (the note of ``roofline`` names it).

The terms are per chip against ``roofline.hw.H100_SXM``; ``opts["chip"]``
of ``"tpu-v5e"`` turns the same counts into the original's terms.
``lower_s`` is the trace's time and ``compile_s`` 0.

The original lowers a scan over layers, whose body XLA counts once, and so
extrapolates its totals from unrolled probes of depth p and 2p. An eager
trace counts every layer, so the totals here come from the full-depth
trace; with ``probes`` the depth-p and 2p traces still run and report
``probe1_flops`` and ``probe2_flops``, but ``scan_reported_flops`` (the
scan build's undercount) has no counterpart and is left out. A decode
step's position, a traced scalar in the original, is an int here, the
cache's last row (an eager step reads it); its stand-in is in the
arguments as the original's is.

Results go to ``results/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.config import (ALL_SHAPES, SHAPES, ModelConfig, ServeConfig,
                                ShapeSpec, TrainConfig, get_config,
                                resolve_device, shape_applicable)
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.distributed.sharding import (NamedSharding, map_shardings,
                                              placements, resolve_spec,
                                              serve_rules, train_rules,
                                              use_sharding, zeros)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import model as lm
from repro_torch.models.transformer import block_period
from repro_torch.roofline.analysis import (CollectiveStats, model_flops,
                                           roofline_from_artifacts)
from repro_torch.roofline.counter import Recorder
from repro_torch.roofline.hw import H100_SXM, TPU_V5E
from repro_torch.training.train_loop import jit_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
CHIPS = {H100_SXM.name: H100_SXM, TPU_V5E.name: TPU_V5E}
CPU_ALL_TO_ALL = ("CPU mesh: DTensor runs each all-to-all as an all-gather "
                  "and a chunk")


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


@dataclasses.dataclass
class Traced:
    """One traced step: its recorder, its arguments, its outputs and the
    arguments it updates in place."""

    recorder: Recorder
    args: Any
    outputs: Any
    aliased: Any
    device: str


def _memory_analysis_dict(traced: Traced) -> Dict[str, float]:
    return traced.recorder.memory_analysis(traced.args, traced.outputs,
                                           traced.aliased)


def _probe_cfg(cfg: ModelConfig, depth: int) -> ModelConfig:
    pattern = None
    if cfg.layer_pattern is not None:
        pattern = tuple(cfg.layer_kinds()[:depth])
    return cfg.replace(num_layers=depth, layer_pattern=pattern)


def _fake(meta: Any, shardings: Any) -> Any:
    """Fake DTensors laid out by ``shardings``, each from its local shard
    alone (call under a ``FakeTensorMode``)."""
    return map_shardings(lambda t, ns: zeros(t.shape, t.dtype, ns), meta,
                         shardings)


def _lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                opts: Dict[str, Any], scan: bool):
    """Build + trace one step on fake inputs over ``mesh``. Returns
    (traced, step_kind, tokens). ``scan`` is the original's choice of a
    scan build; an eager trace runs every layer either way."""
    device = mesh.device_type
    if shape.kind == "train":
        tcfg = S.default_train_config(cfg)
        over = {k: opts[k] for k in
                ("remat", "opt_state_dtype", "microbatches",
                 "grad_compression", "loss_chunk") if k in opts}
        tcfg = TrainConfig(**{**tcfg.__dict__, **over,
                              "scan_layers": scan})
        rules = train_rules()
        if "rules_override" in opts:
            rules = rules.override(**opts["rules_override"])
        step = jit_train_step(cfg, tcfg, mesh, rules)
        params_sh = S.params_shardings(cfg, mesh, rules)
        opt_sh, opt_meta = S.opt_shardings(cfg, tcfg, mesh, rules)
        batch_meta = S.train_batch_specs(cfg, shape)
        batch_sh = S.batch_shardings(batch_meta, mesh, rules)
        with FakeTensorMode():
            params = _fake(lm.param_shapes(cfg), params_sh)
            opt_state = _fake(opt_meta, opt_sh)
            batch = _fake(batch_meta, batch_sh)
            with Recorder() as rec:
                out = step(params, opt_state, batch)
        # The update is in place: params and optimizer state are aliased.
        return (Traced(rec, (params, opt_state, batch), out,
                       (params, opt_state), device), "train",
                shape.global_batch * shape.seq_len)

    scfg = S.default_serve_config(cfg, shape)
    if "serve_fsdp" in opts:
        scfg = ServeConfig(**{**scfg.__dict__,
                              "serve_fsdp": opts["serve_fsdp"]})
    rules = serve_rules(scfg.serve_fsdp, batch1=shape.global_batch == 1)
    if "rules_override" in opts:
        rules = rules.override(**opts["rules_override"])
    params_sh = S.params_shardings(cfg, mesh, rules)

    if shape.kind == "prefill":
        batch_meta = S.prefill_batch_specs(cfg, shape)
        batch_sh = S.batch_shardings(batch_meta, mesh, rules)
        with FakeTensorMode(), torch.no_grad():
            params = _fake(lm.param_shapes(cfg), params_sh)
            batch = _fake(batch_meta, batch_sh)
            with Recorder() as rec, use_sharding(mesh, rules):
                out = lm.prefill(params, cfg, batch, max_len=shape.seq_len)
        return (Traced(rec, (params, batch), out, (), device), "prefill",
                shape.global_batch * shape.seq_len)

    # decode
    cache_dtype = getattr(torch, opts.get("kv_cache_dtype", cfg.dtype))
    tok_meta, caches_meta, pos_meta = S.decode_input_specs(
        cfg, shape, cache_dtype)
    tok_sh = NamedSharding(mesh, placements(
        resolve_spec(tok_meta.shape, ("batch", None), rules, mesh), mesh))
    caches_sh = S.cache_shardings(cfg, caches_meta, mesh, rules)
    pos_sh = NamedSharding(mesh, placements((), mesh))
    with FakeTensorMode(), torch.no_grad():
        params = _fake(lm.param_shapes(cfg), params_sh)
        tokens = _fake(tok_meta, tok_sh)
        caches = _fake(caches_meta, caches_sh)
        pos = _fake(pos_meta, pos_sh)
        with Recorder() as rec, use_sharding(mesh, rules):
            out = lm.decode_step(params, cfg, tokens, caches,
                                 shape.seq_len - 1)
    # The caches are written in place: aliased.
    return (Traced(rec, (params, tokens, caches, pos), out, caches, device),
            "decode", shape.global_batch)


def _cost_and_collectives(traced: Traced
                          ) -> Tuple[Dict[str, Any], CollectiveStats]:
    rec = traced.recorder
    return ({**rec.cost(), "aten_flops": rec.flops,
             "aten_bytes_accessed": rec.bytes,
             "kernel_flops": rec.kernel_flops,
             "kernel_bytes_accessed": rec.kernel_bytes,
             "kernel_calls": rec.kernel_calls()}, rec.collectives)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             opts: Optional[Dict[str, Any]] = None,
             probes: bool = True, verbose: bool = True,
             device: str = "cuda") -> Dict[str, Any]:
    """Trace one (arch x shape x mesh) cell on a fake world of 256 or 512
    ranks; returns roofline and memory artifacts. ``opts`` carries
    hillclimb overrides. ``device="cuda"`` raises without a card."""
    dev = resolve_device(device)
    opts = dict(opts or {})
    cfg = get_config(arch)
    if opts.get("model_overrides"):
        cfg = cfg.replace(**opts.pop("model_overrides"))
    if opts.get("moe_dispatch") and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch=opts["moe_dispatch"]))
    shape = SHAPES[shape_name]
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev.type)
        return _cell(arch, cfg, shape, mesh, _mesh_name(multi_pod),
                     opts=opts, probes=probes, verbose=verbose)


def _cell(arch: str, cfg: ModelConfig, shape: ShapeSpec, mesh,
          mesh_name: str, *, opts: Dict[str, Any], probes: bool,
          verbose: bool) -> Dict[str, Any]:
    """The body of :func:`run_cell` on a given config, shape and mesh."""
    sanctioned, skip_note = shape_applicable(cfg, shape)
    chips = mesh.size()
    chip = CHIPS[opts.get("chip", H100_SXM.name)]

    t0 = time.monotonic()
    traced, step_kind, tokens = _lower_cell(cfg, shape, mesh, opts=opts,
                                            scan=True)
    t_lower = time.monotonic() - t0
    mem = _memory_analysis_dict(traced)
    cost, coll = _cost_and_collectives(traced)

    # Depth probes, as the original runs them: at one microbatch of
    # global_batch / mb, results scaled by mb. Here they are reported
    # beside the full-depth totals, which need no extrapolation.
    p = block_period(cfg)
    nb = cfg.num_layers // p
    probe_info: Dict[str, Any] = {"period": p, "blocks": nb}
    if probes and nb > 1:
        mb = 1
        probe_shape = shape
        probe_opts = dict(opts)
        if step_kind == "train":
            tc = S.default_train_config(cfg)
            mb = int(opts.get("microbatches", tc.microbatches))
            if mb > 1:
                probe_shape = ShapeSpec(shape.name,
                                        shape.seq_len,
                                        shape.global_batch // mb,
                                        shape.kind)
                probe_opts["microbatches"] = 1
        probe_info["mb_multiplier"] = mb
        flops = []
        for depth in (p, 2 * p):
            t, _, _ = _lower_cell(_probe_cfg(cfg, depth), probe_shape, mesh,
                                  opts=probe_opts, scan=False)
            flops.append(_cost_and_collectives(t)[0]["flops"])
        probe_info.update({"probe1_flops": flops[0],
                           "probe2_flops": flops[1]})

    notes = [f"chip {chip.name}", f"traced on {traced.device}"]
    if traced.device == "cpu":
        notes.append(CPU_ALL_TO_ALL)
    if not sanctioned:
        notes.append(f"bonus cell ({skip_note})")
    mf = model_flops(cfg.num_active_params, tokens, step_kind)
    terms = roofline_from_artifacts(
        arch=arch, shape=shape.name, mesh_name=mesh_name,
        step_kind=step_kind, chips=chips, cost=cost, collectives=coll,
        model_flops_total=mf, memory_analysis=mem, chip=chip,
        note="; ".join(notes))

    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "chips": chips, "step_kind": step_kind,
        "sanctioned": sanctioned, "skip_note": skip_note,
        "opts": {k: v for k, v in opts.items() if k != "rules_override"},
        "lower_s": t_lower, "compile_s": 0.0,
        "probe": probe_info,
        "cost_analysis": cost,
        "memory_analysis": mem,
        "collectives": {
            "counts": dict(coll.counts),
            "wire_bytes": dict(coll.wire_bytes),
            "total_wire_bytes": float(coll.total_wire_bytes),
        },
        "roofline": json.loads(terms.to_json()),
    }
    if verbose:
        r = result["roofline"]
        wire = ", ".join(f"{k} {v:.4g}" for k, v in
                         sorted(coll.wire_bytes.items())) or "none"
        print(f"[{arch} x {shape.name} x {mesh_name}] "
              f"trace {t_lower:.1f}s | "
              f"compute {r['compute_s']*1e3:.2f}ms "
              f"memory {r['memory_s']*1e3:.2f}ms "
              f"collective {r['collective_s']*1e3:.2f}ms "
              f"-> {r['bound']}-bound, roofline frac "
              f"{r['roofline_fraction']:.3f} | "
              f"mem/device {mem.get('total_nonalias_bytes', 0)/2**30:.2f} GiB"
              f" | wire bytes {wire} | kernels {cost['kernel_calls']}",
              flush=True)
    return result


def save_result(result: Dict[str, Any], tag: str = "") -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fname = (f"{result['arch']}__{result['shape']}__{result['mesh']}"
             f"{suffix}.json").replace("/", "_")
    path = os.path.join(RESULTS_DIR, fname)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return path


def result_path(arch: str, shape: str, multi_pod: bool, tag: str = "") -> str:
    suffix = f"__{tag}" if tag else ""
    return os.path.join(RESULTS_DIR,
                        f"{arch}__{shape}__{_mesh_name(multi_pod)}"
                        f"{suffix}.json")


def cell_tag(tag: str, opts: Optional[Dict[str, Any]] = None) -> str:
    """The result tag of a cell traced with its own ``opts``: ``tag``,
    with a hash of the opts appended when there are any, so that cells of
    one arch, shape and mesh under other opts keep files of their own."""
    if not opts:
        return tag
    h = hashlib.sha1(json.dumps(opts, sort_keys=True).encode()).hexdigest()
    return f"{tag}-{h[:8]}" if tag else h[:8]


# Cells that ``run_cells`` traces at once: the card's host has 8 cores,
# and each trace is one busy Python process.
JOBS = 8


def run_cells(cells, *, device: str = "cuda", probes: bool = True,
              tag: str = "", opts: str = "{}", jobs: int = JOBS,
              timeout: Optional[float] = None):
    """Trace each (arch, shape, multi-pod) cell of ``cells`` through this
    module's CLI, each in a process of its own (a fake world is one to a
    process, and cannot share one with an NCCL group), ``jobs`` at a
    time, each stopped after ``timeout`` s. A cell may carry a fourth
    item, a dict of opts of its own (``model_overrides`` and the like),
    laid over ``opts`` key by key. Yields (cell, exit code or None when
    stopped, its stdout and stderr) as each ends; the result is at
    ``result_path(*cell[:3], cell_tag(tag, cell's own opts))``."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                      "..")),
         os.environ.get("PYTHONPATH", "")])}

    def one(cell):
        arch, shape_name, multi_pod, *own = cell
        own = own[0] if own else None
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--shape", shape_name, "--device", device,
                "--tag", cell_tag(tag, own),
                "--opts", json.dumps({**json.loads(opts), **own}) if own
                else opts] + \
            (["--multi-pod"] if multi_pod else []) + \
            ([] if probes else ["--no-probes"])
        try:
            proc = subprocess.run(argv, env=env, text=True, timeout=timeout,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
        except subprocess.TimeoutExpired as e:     # killed by run()
            out = e.stdout or ""
            return cell, None, out.decode() if isinstance(out, bytes) \
                else out
        return cell, proc.returncode, proc.stdout

    with ThreadPoolExecutor(max(1, min(jobs, len(cells)))) as pool:
        for done in as_completed([pool.submit(one, c) for c in cells]):
            yield done.result()


def main() -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell on this mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--include-bonus", action="store_true",
                    help="also trace spec-skippable long_500k cells")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the depth-probe traces (the totals come "
                         "from the full-depth trace either way)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--opts", default="{}",
                    help="JSON dict of hillclimb overrides")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device: cuda (kernels counted as the "
                         "card launches them) or cpu (plain versions)")
    args = ap.parse_args()
    opts = json.loads(args.opts)
    resolve_device(args.device)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = []
    if args.all:
        for arch in ASSIGNED_ARCHS:
            for shape in ALL_SHAPES:
                cells.append((arch, shape.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    todo = []
    for multi_pod in meshes:
        for arch, shape_name in cells:
            cfg = get_config(arch)
            ok, note = shape_applicable(cfg, SHAPES[shape_name])
            if args.all and not ok and not args.include_bonus:
                print(f"[{arch} x {shape_name}] SKIP (sanctioned): {note}",
                      flush=True)
                continue
            if args.skip_existing and os.path.exists(
                    result_path(arch, shape_name, multi_pod, args.tag)):
                print(f"[{arch} x {shape_name} x {_mesh_name(multi_pod)}] "
                      f"cached", flush=True)
                continue
            todo.append((arch, shape_name, multi_pod))
    failures = []
    if len(todo) == 1:
        arch, shape_name, multi_pod = todo[0]
        try:
            res = run_cell(arch, shape_name, multi_pod=multi_pod,
                           opts=dict(opts), probes=not args.no_probes,
                           device=args.device)
            save_result(res, tag=args.tag)
        except Exception as e:  # noqa: BLE001
            failures.append((arch, shape_name, multi_pod, repr(e)))
            print(f"[{arch} x {shape_name} x "
                  f"{_mesh_name(multi_pod)}] FAILED: {e}", flush=True)
            traceback.print_exc()
    else:
        for cell, rc, out in run_cells(todo, device=args.device,
                                       probes=not args.no_probes,
                                       tag=args.tag, opts=args.opts):
            print(out, end="", flush=True)
            if rc != 0:
                failures.append((*cell, f"exit {rc}"))
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: "
                         f"{[(f[0], f[1], f[2]) for f in failures]}")
    print("dry-run complete: all cells traced.")


if __name__ == "__main__":
    main()
