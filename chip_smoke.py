#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. ``device``   card name and power limit (nvidia-smi), the card's power
                draw before any work beside the idle floor that the
                runtime's ``h100_sxm`` spec assumes, torch and CUDA
                versions. No card: exit non-zero before any result.
2. ``build``    nvcc builds ``src/repro_torch/csrc/*.cu`` for sm_90a; build
                time and each kernel's registers/spills from ``-Xptxas -v``;
                fails if an instantiation the main paths launch spills.
3. ``kernels``  each hand-written kernel against its plain PyTorch version
                on the card, at the full-width shapes each serving path
                gives it (rmsnorm at the three models' widths; flash at
                prompts of 101, 333, 512 and 700 tokens at internlm2's
                heads and of 333 at granite-moe's, bf16 on the wgmma
                kernel and fp32 on the CUDA-core one; decode at the serve
                cache at both models' heads and at a cache of 4096;
                ssd_scan at 512, 129, 101 and
                1024 steps in bf16 on its tensor-core design, with each of
                its kernels' device time from torch.profiler, and at 512
                and 129 in fp32 on its CUDA-core one), in bf16 and fp32:
                max error, kernel time, plain-version time, the time of
                the nearest PyTorch library call, and the bound (the least
                time the card could take for the same work).
                phi3-medium-14b, stablelm-12b, internvl2-1b,
                musicgen-large and bert-base add rmsnorm at d 5120,
                896, 2048 and 768, flash at their heads (stablelm-12b's
                32/8 at d 160 on the wgmma kernel's three boxes), decode at
                their heads (internvl2-1b's group of 7; stablelm-12b's d
                160 at the serve cache and at 4096) and at
                llama4-maverick's 40/8 (group 5), which has no full-width
                path: its launches, like int8_matmul's, are the ones
                checked here.
                ``int8_matmul`` has no model call site; this phase is its
                path, and its launches here are the ones reported; beside
                its library call (``torch._int_mm`` and the scales) it
                times ``torch._int_mm`` alone (``int_mm_ms``).
3b. ``contract`` the kernels at shapes the Pallas kernels compute and no
                model path runs, in bf16 and fp32: flash forward and
                backward at b 8, s 256, causal, at 32/32 heads d 96
                (phi-3-mini) and d 80 (phi-2), 8/1 d 256 (gemma-2b), 8/8
                d 100 and 8/2 d 99 (rows not whole 16-byte chunks in
                bf16: route "wgmma_staged", forward and backward; fp32
                below 257 route "wide" at one tile), and above
                256 on the column-tile kernels: 8/8 d 257 (in bf16 route
                "wgmma_wide_staged", flash_attention_wide.cu on copies
                in 16-byte rows), 8/2 d 288, 8/8 d 512, 8/1 d 576;
                decode at the serve cache with 71/1
                d 64 (falcon-7b: five slices of q heads), 8/1 d 256
                (route "mma", decode_attention_tc.cu), 32/32 d 96, 16/1
                d 512 and 128/1 d 576 (an absorbed MLA
                decode: eight slices, three column tiles), each in plain
                and partial mode; ssd_scan forward and backward at b 1, s
                512, 8 heads, p 64, d_state 512. Each case against its
                plain version at the ``kernels`` phase's tolerances, its
                design, its launches (every call launched its kernel; the
                module's plain versions refuse while it runs), time by
                graph replay, bound, plain version's and SDPA's (with the
                lengths as a mask in decode) time, SDPA's backend named
                from the kernels it launched (``library_backend``), and
                the case's own ``seconds``; head dim 0 must raise,
                launching nothing; the ptxas line of every padded or
                tiled instantiation. Then internlm2-1.8b at
                PARITY_LAYERS layers with ``CONTRACT_MODELS``' heads
                (gemma-2b's, a group of 32, phi-3-mini's): ``parity`` and
                ``train_parity`` card vs CPU, launches exact.
4. ``serve``    three paths, each full width in bf16 with random weights,
                8 requests through ``repro_torch.launch.serve.serve``,
                which runs them through the port's ``ClusterRuntime``
                (activation gating, modelled energy over ``h100_sxm()``):
                internlm2-1.8b (rmsnorm, flash and decode attention),
                mamba2-130m (rmsnorm, ssd_scan), granite-moe-1b-a400m
                (rmsnorm, flash and decode attention; MoE layers), and
                phi3-medium-14b, stablelm-12b, internvl2-1b (tokens only,
                as the JAX launcher serves it), musicgen-large and
                bert-base (rmsnorm, flash and decode attention), each
                model freed before the next loads. Every
                kernel's launch count is reset just before each and read
                just after; the path's
                own kernels must have launched, the others not. The
                runtime's telemetry must equal, field for field, that of a
                run of the same counts on the CPU at smoke size (it is
                modelled per tick from counts alone).
5. ``profile``  one prefill and a few decode ticks of each model:
                host time per step, then under torch.profiler the kernels'
                device time per step and the device's idle share.
6. ``train``    internlm2-1.8b, then mamba2-130m, then stablelm-12b cut to
                4 of its 40 layers (``TRAIN_LAYERS``; the flash backward
                at d 160), at full width in bf16
                through the port's ``Trainer`` (``repro_torch.launch.
                train``'s config: ``default_train_config``, remat "full",
                seq 256, batch 8): 8 steps with fp32 moments, each loss
                finite; launches a step checked exactly against
                ``TRAIN_LAUNCHES`` (internlm2: rmsnorm 97, rmsnorm_bwd 49,
                flash 48, flash_bwd 24; mamba2: rmsnorm 49, rmsnorm_bwd 25,
                ssd_scan 48, ssd_scan_bwd 24; stablelm: rmsnorm 17,
                rmsnorm_bwd 9, flash 8, flash_bwd 4; nothing else); a run saved
                at step 4, restored into a fresh ``Trainer`` and continued
                to step 8 must give the unbroken run's losses bit for bit;
                then 3 steps with int8 moments. Step ms, grad norm,
                ``max_memory_allocated``; one more step timed, then traced
                (device busy ms, idle share, top kernels, the flash, SSD
                and rmsnorm backward kernels' device ms). Then
                internlm2-1.8b again with ``mlp_lowp`` (path
                ``LOWP_TRAIN_PATH``): 3 steps, launches a step as the
                unflagged run's, the first loss within 1 % of that run's
                first loss (same weights and batch), printed beside it.
7. ``train_parity`` fp32 internlm2-1.8b, mamba2-130m and stablelm-12b
                at full width with 2 layers: one ``loss_fn`` and its
                gradient on the card
                (kernels, their backward kernels) and on the CPU (plain
                versions): the loss and every gradient leaf, relative to
                its max-abs, within ``PARITY_TOL``; launches exact.
8. ``parity``   each model in fp32 at cut depth, on the card (kernels)
                and on the CPU (plain versions): prefill and per-slot decode
                logits must agree. For the MoE model each MoE layer's
                top-k experts are recorded on both sides; a sequence whose
                routing differed in any layer (a near-tie of the k-th and
                next expert, flipped by fp32 rounding) has its later logits
                left out of the comparison and counted on the line, and a
                flip at a top-k gap above ``FLIP_GAP`` fails the run.
                Without MoE layers the card's greedy tokens must equal the
                CPU's. stablelm-12b (d 160) and internvl2-1b (group 7, its
                256 frontend embeddings prefilled first) have this phase
                too.
9. ``fleet_parity`` the port's fleet engine, ``Fleet(backend="torch")`` on
                the card (one tick captured as a CUDA graph, replayed a
                block of 128 ticks at a time), against the port's
                ``Fleet(backend="vector")`` on the host, over fig16's
                parity set: the mixed 8 SoC + 2 Xeon fleet under each
                router on the short diurnal trace and under round-robin
                on the flash crowd, the 6-rack schedutil + thermal fleet,
                and an under-provisioned hedging fleet. Integer series
                (ticks, drained, active units, queued, hedges, scale
                events, throttled units) must be equal, the rest within
                the JAX engine's ``RTOL``/``ATOL``; the largest relative
                error of each series is printed.
10. ``fleet_sweep`` fig16's batched sweep, ``sweep()`` of 64 configs x 100
                racks (6000 SoCs) x 24 h at 300 s ticks on the card:
                warm seconds graph-replayed (each sweep captures its
                tick anew) and eager, scenarios/s beside
                the vector loop's (8 configs run one by one, extrapolated
                to 64 as fig16 does), ``max_memory_allocated``, a traced
                sweep's device-busy share and kernels a tick. Those 8 rows
                must be within 1e-9 of their dedicated vector runs, and a
                repeated sweep and an eager one equal to it bit for bit.
11. ``fleet_chaos`` fig16's fault study (benchmarks/fig16_fleet.py:269-345)
                through ``Fleet(backend="torch", chaos=...)`` on the card
                and ``backend="vector"`` on the host: (a) a 2-rack kill on
                a 1700 rps plateau under JSQ and round-robin, (b) the kill
                at a flash crowd's peak with hedging, and
                ``hedging_delta(..., backend="torch")``; every fault kind
                (kill, partial kill, fan failure, power cap) on 4 schedutil
                + thermal racks (tests/test_chaos.py::_full_schedule), a
                fan failure on racks whose fans spin; and
                fig16's 100 SoC + 20 Xeon fleet for 24 h under a random
                schedule on 12 of its racks.
12. ``fleet_degrade`` fig16's degradation study (:348-488), all three arms
                (pre-fault, degraded, accept-everything), and the same
                fig16-scale day with its ``DegradePolicy``.
                Both: integer series and counts equal, served and energy
                within 1e-12, power, queued and latency within 1e-9, every
                degrade cost, the offered series, tier percentiles,
                respilled and dropped cost and the p99 blow-up within
                fig16's ``JAX_RTOL`` (1e-9); fig16's asserts on the torch
                results; every block replayed from a captured graph;
                kernels a tick of the overlay-free, chaos and chaos +
                degrade tick; host walls beside the vector engine's.
                No fleet phase runs a hand-written kernel: every launch
                count must stay 0 across them.
13. ``dl``     (after ``profile``) fig11's DL-inference models,
                ``repro_torch.models.{resnet,yolo}``, in fp32 at full input
                size: resnet-50 and resnet-152 at 224 with batch 1 and 64,
                yolov5x at 640 and 320 with batch 1. Each case: ms a batch
                (CUDA events around back-to-back forwards) and images/s,
                device ms (graph-replayed), ``max_memory_allocated``,
                kernels a forward and the device-busy share of a traced
                one, FLOPs (``FlopCounterMode``) and the share of the
                fp32 peak; again on NCHW-contiguous storage (``nchw_*``)
                and with TF32 allowed (``tf32_*``). ``dl_parity``: one
                image at full input size, weights made on the CPU and
                moved across, card vs CPU within ``DL_PARITY_TOL`` of the
                CPU output's max-abs in fp32, a ResNet's top class equal;
                TF32's error reported. No hand-written kernel launches.
14. ``examples`` the example twins on the card:
                ``examples/torch_quickstart.py`` at internlm2-1.8b's smoke
                config for 5 steps and ``examples/torch_serve_lm.py`` with
                its defaults, each line with the example's printed lines
                and its kernel launches.
15. ``distributed`` (after ``examples``) the port's distributed layer
                over NCCL in a world of one (one card; a ``FileStore`` in a
                temporary directory, no port), so nothing crosses a link:
                the meshes of ``launch.mesh.make_mesh``, the ring and naive
                collective-matmuls at 16 x 64 by 64 x 32, ``make_tp_block``
                both ways at m 64, d 512, f 2048 (fp32, TF32 off; ms of
                each by CUDA events after a warm-up, beside the plain
                block's and its first product's ring and naive
                collective-matmul on local tensors), ``compressed_psum_mean``
                on 2^20 fp32 elements within its quantization bound and
                ``quantize_blockwise``'s codes equal to the CPU's bit for
                bit, a four-microbatch ``make_pipelined_fn`` on one stage,
                and ``place_on_mesh`` of an internlm2-1.8b training batch
                (8 x 256). Each result is held against its plain PyTorch
                computation on the card (matmuls within 1e-5 of the
                output's max-abs). If NCCL does not come up the phase
                fails: there is no fallback. The group is destroyed after
                the phase; no hand-written kernel may launch.
16. ``sharded`` (after ``distributed``) the model steps on a mesh over
                NCCL in a world of one, ``make_mesh((1, 1), ("data",
                "model"))``, at full width in bf16. Training:
                internlm2-1.8b, mamba2-130m and granite-moe-1b-a400m,
                ``Trainer(mesh=...)`` for 3 steps of
                ``default_train_config`` against ``Trainer(mesh=None)``
                from the same seed, losses within ``SHARDED_TRAIN_TOL``
                (and whether they are equal bit for bit), the launches a
                step of each kernel and backward kernel equal to the
                unsharded step's and to ``TRAIN_LAUNCHES``. Serving: the
                same three, jamba-1.5-large-398b cut to its first
                ``HYBRID_LAYERS`` layers (Mamba and attention mixers,
                dense and MoE FFNs) and internlm2-1.8b with weight-only
                int8; 5 prompts through a ``ContinuousBatcher`` over
                ``ServingEngine(mesh=...)`` and over the unsharded engine,
                one draw of weights loaded into each, greedy tokens equal
                and launches (decode in partial mode on the mesh) equal.
                Host ms a step and a tick and ``max_memory_allocated`` of
                every run. Then one granite-moe MoE layer at full width in
                fp32 with its tokens in 1, 2 and 4 groups
                (``moe._num_groups`` patched, since one card is one data
                shard), card against CPU: destinations and keep masks
                equal, output within ``MOE_LAYER_TOL`` of its max-abs,
                routing flips only at top-k gaps up to ``FLIP_GAP``.
                Each kernel runs on local shards through ``local_map``,
                and the MoE stages on local groups; one card moves no
                byte across a link, so the rank arithmetic of larger
                meshes is held by the gloo tests
                (``tests/test_torch_sharded_*.py``).
17. ``dryrun`` (after ``sharded``) ``python -m repro_torch.launch.dryrun
                --device cuda`` for each of ``DRYRUN_CELLS`` (internlm2-1.8b
                at train_4k, prefill_32k and decode_32k, granite-moe at
                train_4k, mamba2-130m at long_500k on pod16x16, and
                internlm2 decode_32k on pod2x16x16; then the train_4k
                cells of mamba2-130m and internvl2-1b, whose heads the
                model axis does not divide, and of stablelm-12b, d 160;
                then internlm2 decode_32k with a group of 32, and
                train_4k with gemma-2b's heads and with ``mlp_lowp``,
                through ``--opts`` ``model_overrides``),
                each in a process of
                its own (a fake world of 256 or 512 ranks cannot share one
                with an NCCL group), eight at once, the longest first:
                one line a cell with its
                three roofline terms on the H100 spec, bound, roofline
                fraction, GiB a device, collective wire bytes by kind and
                kernel calls; each cell's GiB a device but internvl2-1b
                train_4k's must be below the card's ``total_memory``
                (``DRYRUN_FIT``). Then
                ``dryrun_grounding``: on a (1, 1) mesh
                over NCCL internlm2-1.8b at full width is traced at the
                ``train`` phase's shape and config and one real step of
                the same ``Trainer`` runs; the traced kernel calls must
                equal the step's launches, the traced aten FLOPs
                ``FlopCounterMode``'s over the step, and the traced peak
                (arguments + temp) ``max_memory_allocated`` within 10 %;
                ``compute_s`` and ``memory_s`` are printed beside the
                step's device-busy ms. The trace launches nothing.

The ``kernels`` phase also holds the three backward kernels
(``rmsnorm_bwd``, ``flash_attention_bwd``, ``ssd_scan_bwd``) to their
closed-form plain backwards at the training shapes (2048 x 2048, 2048 x
768 and 2048 x 5120, and 2048 x 2048 under ``lowp``, against
``ref.rmsnorm_lowp_bwd_ref``; 2 x 20000, the stream design's row, with
and without ``lowp``; b 8, s 256, 16/8 heads, d 128, and stablelm-12b's
32/8 heads at d 160, bf16 and fp32; the flash
backward in bf16 at granite-moe's d 64 too; the SSD backward at b 8, s
256, 24 heads, p 64, n 128 in bf16 and fp32, the final state's gradient
zero and not, and in fp32 at p 128, two calls bitwise equal), beside
their library call's backward timed through autograd (``F.rms_norm``,
``F.scaled_dot_product_attention``; none computes the SSD), and ssd_scan's
forward at the training shape. Each flash and SSD backward case names its
route (``design``: the wgmma kernels for bf16 at d 64, 128 and 160, the
CUDA-core tiles of route ``wide`` in fp32, and in the contract phase
``wgmma_staged``, ``wgmma_wide`` and ``wgmma_wide_staged``; the
SSD backward's tensor-core kernels for bf16 at n <= 128, p <= 64, the
CUDA-core ones otherwise); a bf16 SSD backward
case also holds the CUDA-core design to the same checks on the same
inputs and times it in the same call (``simt_max_abs_err``,
``simt_abs_err``, ``simt_ms``, ``simt_kernel_us``). Each rmsnorm
backward case names its design (``ring`` where rows are up to 2048
16-byte chunks, ``stream`` past 2048 chunks) and holds every design that
takes the row (``ring``, ``block_rows``, ``stream``) to the same checks on
the same inputs (two calls and the replays of a captured graph bitwise
equal), timing them in turns (``ms_by_design``). The ``train`` profile reads the step's flash, SSD
and rmsnorm backward device time (``flash_bwd_device_ms``,
``ssd_bwd_device_ms``, ``rmsnorm_bwd_device_ms``).

Then the summary line of kernels (one row per kernel and path: a kernel
several paths run, rmsnorm on all three and flash and decode on two, has
a row for each, with that path's launches and its case at that path's
shape; each training path has rows for its kernels and their backward
kernels, with the launches of its 8-step run; the ``contract`` phase a
row for each of its cases and backward cases, path ``contract phase``,
with its checked launches), the nvidia-smi line, and the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.config import (ServeConfig, ShapeSpec,  # noqa: E402
                                get_config, smoke_config)
from repro_torch.core.cluster import (edge_server_cpu,  # noqa: E402
                                      h100_sxm, soc_cluster)
from repro_torch.distributed.fault import RetryPolicy  # noqa: E402
from repro_torch.core.collaborative import make_tp_block  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    compressed_psum_mean, quantize_blockwise)
from repro_torch.distributed.pipeline import make_pipelined_fn  # noqa: E402
from repro_torch.distributed.sharding import train_rules  # noqa: E402
from repro_torch.fleet import (ROUTERS, BreakerConfig,  # noqa: E402
                               ChaosSchedule, DegradePolicy, Fleet,
                               JoinShortestQueueRouter, PowerAwareRouter,
                               RoundRobinRouter, SweepConfig, TierSpec,
                               diurnal_trace, flash_crowd_trace,
                               hedging_delta, homogeneous_fleet,
                               scale_to_users, sweep,
                               tier_latency_percentiles)
from repro_torch.fleet import torch_engine as tte  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import int8_matmul as kint8  # noqa: E402
from repro_torch.kernels import rmsnorm as krms  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import data_config, train_config  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.resnet import (resnet_apply,  # noqa: E402
                                       resnet_flops, resnet_init)
from repro_torch.models.yolo import yolo_apply, yolo_init  # noqa: E402
from repro_torch.power import (SchedutilGovernor,  # noqa: E402
                               ThermalParams, sd865_opp_table)
from repro_torch.roofline import kernel_cost  # noqa: E402
from repro_torch.roofline.analysis import roofline_from_artifacts  # noqa: E402
from repro_torch.roofline.hw import H100_SXM  # noqa: E402
from repro_torch.runtime import ScalePolicy  # noqa: E402
from repro_torch.serving.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.data import (PrefetchingLoader,  # noqa: E402
                                       _gen_batch, place_on_mesh)
from repro_torch.training.optimizer import adamw_update  # noqa: E402
from repro_torch.training.train_loop import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "internlm2-1.8b"
# Prompt lengths of the serve phase: 100..700 tokens, none a multiple of 64
# (the flash kernel's tile), so every prefill has a ragged edge.
PROMPT_LENS = [333, 129, 700, 517, 258, 450, 101, 611]
NEW_TOKENS = 32
SLOTS = 4
MAX_LEN = max(PROMPT_LENS) + NEW_TOKENS + 8
# The serve phase's CPU twin: the same counts at smoke size, one prompt
# length that keeps the smoke SSD contract (<= its chunk of 32).
CPU_PROMPT_LEN = 16
# What the serve line's telemetry and tokens/s are: the runtime counts
# each tick as one modelled second, and its unit_rate decides how many
# slots it wakes.
ENERGY_MODEL = ("h100_sxm (8 shares), assumed idle floor, "
                "1 modelled s a tick")
THROUGHPUT = "gated by unit_rate=0.25 req/s a share, not capacity"
# decode_attention cases: (cache rows, per-slot lengths); the first is the
# serve run's cache.
DECODE_CASES = ((MAX_LEN, [129, 334, 517, 731]),
                (4096, [4000, 2731, 1290, 65]))
PARITY_LAYERS = 2
PARITY_SIDES = {"card": "cuda", "cpu": "cpu"}   # side -> device

MAMBA_ARCH = "mamba2-130m"
# Each <= 256 (the SSD chunk: one ragged chunk) or a multiple of it (the
# state carried across chunks), as the JAX contract asks.
MAMBA_PROMPT_LENS = [512, 129, 1024, 256, 200, 768, 101, 255]
MAMBA_PARITY_PROMPTS = (77, 200)
# ssd_scan cases of the kernels phase, by dtype: the first is a 512-token
# prefill (the row of the summary line), then the serve run's shortest and
# longest prompts. bf16 runs the tensor-core design, fp32 the CUDA-core one.
SSD_LENS = {torch.bfloat16: (512, 129, 101, 1024), torch.float32: (512, 129)}
MOE_ARCH = "granite-moe-1b-a400m"
# The other dense, VLM and audio archs, each served at full width through
# the launcher; stablelm-12b's head_dim 160 and internvl2-1b's group of 7
# are new shapes for the flash and decode kernels, and get a parity phase.
NEW_ARCHS = ("phi3-medium-14b", "stablelm-12b", "internvl2-1b",
             "musicgen-large", "bert-base")
NEW_PARITY_ARCHS = ("stablelm-12b", "internvl2-1b")
# llama4-maverick-400b-a17b is not served at full width on one card; its
# decode heads (40/8, group 5) are checked in the kernels phase alone.
GROUP5_ARCH = "llama4-maverick-400b-a17b"
ATTN_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
# Kernels each model's path runs; every other kernel must stay at 0.
PATH_KERNELS = {ARCH: ATTN_KERNELS,
                MAMBA_ARCH: ("rmsnorm", "ssd_scan"),
                MOE_ARCH: ATTN_KERNELS,
                **{arch: ATTN_KERNELS for arch in NEW_ARCHS}}
# The training paths: internlm2-1.8b, mamba2-130m and stablelm-12b (the
# flash backward at d 160) at the launcher's seq and batch, full remat.
# stablelm-12b trains at full width with 4 of its 40 layers: the whole
# model's fp32 moments alone would take 96 GB; at 4 layers the step needs
# about a third of the card.
TRAIN_PATH = f"train {ARCH}"
MAMBA_TRAIN_PATH = f"train {MAMBA_ARCH}"
D160_ARCH = "stablelm-12b"
D160_TRAIN_PATH = f"train {D160_ARCH}"
TRAIN_PATHS = {ARCH: TRAIN_PATH, MAMBA_ARCH: MAMBA_TRAIN_PATH,
               D160_ARCH: D160_TRAIN_PATH}
TRAIN_LAYERS = {D160_ARCH: 4}
# internlm2-1.8b at full width under ModelConfig.mlp_lowp (every norm and
# its backward in bf16, as ref.rmsnorm_lowp): a few steps, launches as the
# unflagged run's, the first loss beside that run's.
LOWP_TRAIN_PATH = f"train {ARCH} mlp_lowp"
LOWP_TRAIN_STEPS = 3
LOWP_LOSS_TOL = 0.01        # of the unflagged run's first loss
# The rmsnorm backward's widest case: a row only the stream design takes.
RMS_WIDE_ROWS = (2, 20000)
TRAIN_SEQ, TRAIN_BATCH = 256, 8
TRAIN_STEPS, TRAIN_INT8_STEPS, TRAIN_SAVE_AT = 8, 3, 4
TRAIN_CKPT_DIR = "chiprun_train_ckpt"       # in the checkout, gitignored
TRAIN_FIRST_LOSS = {}       # arch -> its train phase's first loss
TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 128
SHARDED_STEPS, SHARDED_NEW = 3, 8
# The MoE, hybrid and int8 paths on the mesh: granite-moe trains
# and serves; jamba serves at full width, cut to its first five layers
# (Mamba, Mamba+MoE, Mamba, Mamba+MoE, attention: both mixers and both FFN
# kinds); internlm2 serves with weight-only int8.
SHARDED_TRAIN_ARCHS = (ARCH, MAMBA_ARCH, MOE_ARCH)
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_LAYERS = 5
PATH_KERNELS[HYBRID_ARCH] = ATTN_KERNELS + ("ssd_scan",)
SHARDED_PROMPTS = {ARCH: PROMPT_LENS[:SLOTS + 1],
                   MAMBA_ARCH: MAMBA_PROMPT_LENS[:SLOTS + 1],
                   MOE_ARCH: PROMPT_LENS[:SLOTS + 1],
                   # each <= the SSD chunk of 256 or a multiple of it, and
                   # within MAX_LEN for the attention layer's cache
                   HYBRID_ARCH: (512, 129, 256, 200, 101)}
SHARDED_SERVE_PATH = f"sharded serve {ARCH}"
SHARDED_TRAIN_TOL = 1e-4    # tests/test_torch_training.py::TRAINER_TOL
# The grouped MoE layer, card vs CPU: one granite-moe layer at full width
# in fp32, its tokens cut into 1, 2 and 4 groups (``moe._num_groups``
# patched: a mesh in a world of one has one data shard, so one group).
MOE_GROUPS = (1, 2, 4)
MOE_LAYER_TOKENS = (4, 256)     # (b, s): 1024 tokens
MOE_LAYER_TOL = 1e-4            # of the CPU output's max-abs
# One rank's slice of a sequence-sharded cache (half of the serve cache):
# slots of length 0, inside it and filling it.
PARTIAL_SLICE = MAX_LEN // 2
PARTIAL_LENGTHS = [0, 129, PARTIAL_SLICE, 301]


def train_launches(arch: str, layers: int) -> dict:
    """Launches of one training step at full remat: every layer's forward
    twice (once more in the backward's recompute), the final norm once,
    each backward once. A dense layer has two norms and one attention, a
    mamba2 layer one norm and one SSD scan."""
    if arch == MAMBA_ARCH:
        return {"rmsnorm": 2 * layers + 1, "rmsnorm_bwd": layers + 1,
                "ssd_scan": 2 * layers, "ssd_scan_bwd": layers}
    return {"rmsnorm": 4 * layers + 1, "rmsnorm_bwd": 2 * layers + 1,
            "flash_attention": 2 * layers, "flash_attention_bwd": layers}


def train_cfg(arch: str):
    """``arch``'s config as the train phase runs it: full width, its depth
    cut to ``TRAIN_LAYERS`` where one card cannot hold it whole."""
    cfg = get_config(arch)
    return cfg.replace(num_layers=TRAIN_LAYERS.get(arch, cfg.num_layers))


TRAIN_LAUNCHES = {arch: train_launches(arch, train_cfg(arch).num_layers)
                  for arch in (*SHARDED_TRAIN_ARCHS, *TRAIN_PATHS)}
# int8_matmul has no model call site: the kernels phase is its path, at
# the JAX benchmark's shape and an MLP up projection of a 333-token prefill.
KERNELS_PHASE = "kernels phase"
INT8_SHAPES = ((512, 1024, 512), (333, 2048, 8192))

# H100 SXM data sheet (dense): HBM rate and peak arithmetic rates by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12,   # tensor cores
            torch.float32: 67e12,     # fp32 outside the tensor cores
            torch.int8: 1979e12}      # int8 tensor cores

# Kernel vs plain version on the card. bf16: both compute in fp32 and round
# the output once, so they differ by about one bf16 ulp (2^-8 relative).
# fp32: the kernel sums in another order than the plain version's einsum
# (and on the CPU the tests hold the plain version to 2e-6).
KERNEL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# ssd_scan: the kernels' 64-step tiles against the plain version's chunk
# of 256 (chunk-invariant math, fp32 sums in another order; the bf16
# tensor-core design feeds operands with an fp32 factor as bf16 hi/lo
# pairs): fp32 y and the fp32 state at tests/test_kernels_ssd.py's 2e-4;
# bf16 y at one ulp.
SSD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
# ssd_scan_bwd against the closed-form plain backward: fp32 gradients, and
# bf16's fp32 gradients (ddt, dA, dD), at 2e-4 of their max-abs (sums over
# 64-step tiles against the plain version's chunk of 256, and over the
# heads, batches and tiles in another order); bf16 dx, dB, dC at
# KERNEL_TOL's one ulp (both sum in fp32 and round once).
SSD_BWD_TOL = 2e-4
SSD_BWD_LOWP = ("dx", "dB", "dC")    # gradients in the inputs' dtype
# rmsnorm_bwd's dw against the plain backward: fp32 sums over the rows in
# another order, within this fraction of 1 + its max-abs (as the gpu
# tests hold it).
RMS_BWD_DW_TOL = 1e-5
# int8_matmul: exact int32 sums and the same fp32 epilogue: bit for bit.
INT8_TOL = 0.0
# Logits of the fp32 model, card (kernels, cuBLAS) vs CPU (plain versions):
# 2048- and 8192-long fp32 sums in other orders, through two layers.
PARITY_TOL = 1e-3
# A routing flip, card vs CPU, is noise only where the k-th and the next
# expert's probabilities lie closer than fp32 rounding can move them.
FLIP_GAP = 1e-4

SOURCES = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:22"),
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:22"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:78"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:69"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:73"),
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu",
                     "src/repro/kernels/ssd_scan.py:73"),
    "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                    "src/repro/kernels/int8_matmul.py:43"),
}
# Flash attention's tensor-core column tiles above a head dim of 256 (the
# "wgmma_wide" and "wgmma_wide_staged" designs, forward and backward; the
# latter's copy is flash_attention.cu's) live in a source of their own,
# and so does decode attention's tensor-core kernel (route "mma", bf16 at
# D 256).
WGMMA_WIDE_SOURCE = "src/repro_torch/csrc/flash_attention_wide.cu"
# Its CUDA-core column tiles above 256 (route "wide": fp32, and bf16 above
# 768) in a third, and route "wide" at one tile (fp32 at d 33-256) in a
# fourth, each compiled in parallel with the others.
SIMT_WIDE_SOURCE = "src/repro_torch/csrc/flash_attention_simt_wide.cu"
SIMT_TILE_SOURCE = "src/repro_torch/csrc/flash_attention_simt_tile.cu"
DECODE_MMA_SOURCE = "src/repro_torch/csrc/decode_attention_tc.cu"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing and bounds.
# ---------------------------------------------------------------------------
def _events_ms(run, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call: CUDA events around replays of a CUDA graph
    that holds ``iters`` calls, after a warm-up, so the host's launch cost
    is not in it. Inputs stay in the 50 MB L2 where they fit, as they do in
    the model (each input was just written by the op before)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def replay():
        for _ in range(reps):
            graph.replay()
    return _events_ms(replay, reps * iters)


def eager_ms(fn, iters: int = 50) -> float:
    """Time of one call launched from Python, back to back: where the host
    is slower than the device, this is the host's cost per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run, iters)


def bound(nbytes: float, nops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out: torch.Tensor, want: torch.Tensor, dtype,
            tol: float | None = None) -> float:
    """Max abs error; raises past atol = rtol = ``tol`` (default
    KERNEL_TOL[dtype])."""
    out, want = out.float(), want.float()
    err = (out - want).abs()
    tol = KERNEL_TOL[dtype] if tol is None else tol
    if not torch.isfinite(out).all() or bool((err > tol + tol * want.abs())
                                             .any()):
        raise AssertionError(f"kernel disagrees with plain version: max abs "
                             f"err {err.max().item()} (tol {tol})")
    return err.max().item()


def device_us(fn, iters: int = 10) -> dict:
    """Device time of each CUDA kernel ``fn`` launches, in microseconds a
    call, from torch.profiler over ``iters`` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"^(void )?(repro::)?(\(anonymous namespace\)::)?",
                          "", e.name).split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / iters
    return out


# SDPA's backends, by a word in the names of the CUDA kernels each launches
# (first match wins: the math backend runs cuBLAS and elementwise
# kernels, none of these).
SDPA_BACKENDS = (("cudnn", "cudnn"), ("flash", "flash"),
                 ("efficient", "fmha|mem_eff|efficient|cutlassF|cutlassB"))


def sdpa_backend(fn) -> dict:
    """The backend SDPA picked for ``fn``, named from the CUDA kernels one
    call launches (torch.profiler): ``backend`` and those kernels."""
    kernels = sorted(device_us(fn, iters=1))
    for name, pat in SDPA_BACKENDS:
        if any(re.search(pat, k, re.IGNORECASE) for k in kernels):
            return {"backend": name, "kernels": kernels}
    return {"backend": "math", "kernels": kernels}


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------
def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = h100_sxm()
    info = {"phase": "device", "nvidia_smi": nvidia_smi(),
            "power_draw": nvidia_smi("power.draw"),
            "h100_sxm_assumed_idle_w": spec.unit.p_idle * spec.n_units,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "total_memory": torch.cuda.get_device_properties(0).total_memory,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return info


def _ptxas_summary(lines):
    """ptxas's 'Compiling entry function', spill and 'Used' lines of each
    kernel -> one short label per instantiation."""
    out, name, spill = [], None, None
    for ln in lines:
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            name, spill = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
            continue
        used = re.search(r"Used (\d+) registers", ln)
        if used and name:
            kern = re.search(r"(rmsnorm_kernel|rmsnorm_bwd_kernel|"
                             r"rmsnorm_bwd_ring_kernel|"
                             r"rmsnorm_bwd_stream_kernel|"
                             r"rmsnorm_dw_kernel|flash_fwd_wgmma_kernel|"
                             r"flash_fwd_wgmma_wide_kernel|"
                             r"flash_fwd_simt_kernel|flash_fwd_wide_kernel|"
                             r"flash_bwd_\w+_kernel|"
                             r"flash_stage_rows(?:_group)?_kernel|"
                             r"decode_split_kernel|decode_wide_kernel|"
                             r"decode_mma_kernel|"
                             r"ssd_tc_states_kernel|ssd_tc_pass_kernel|"
                             r"ssd_tc_outputs_kernel|ssd_scan_simt_kernel|"
                             r"ssd_bwd_(?:states|pass|local|reduce)_kernel|"
                             r"ssd_bwd_tc_(?:states|local|reduce)_kernel|"
                             r"int8_wgmma_kernel)", name)
            # the flash wgmma kernel is bf16 only and has no dtype parameter
            dt = "bf16" if "bfloat16" in name or "flash_fwd_wgmma" in name \
                else "f32"
            args = ",".join([dt, *re.findall(r"L[ib](\d+)E", name)])
            out.append(f"{kern.group(1) if kern else name}<{args}>: "
                       f"{used.group(1)} regs, {spill or '?'} B spill")
            name = None
    return out


def _main_path_patterns() -> list:
    """Patterns of the ptxas labels of the instantiations the main paths
    launch: rmsnorm at each path's width in bf16, int8_matmul at the
    kernels phase's shapes (16-byte loads), flash and decode at each
    attention path's head dim in bf16 (decode at the bucket of its group),
    each of ssd_scan's three
    tensor-core kernels (the bf16 path) and its CUDA-core kernel (the fp32
    parity path), the rmsnorm backward's ring kernel at each training
    width in bf16 and fp32 (the train and train_parity paths; and every
    other instantiation of it and of block_rows, the widest rows' among
    them, and the stream design's, which the kernels phase runs at a row
    of 20000; each with and without lowp in bf16, the ring at internlm2's
    width under lowp its ``mlp_lowp`` training path) and block_rows' dw
    kernel (the kernels phase times it), the
    training paths' flash backward kernels at internlm2's and
    stablelm-12b's head dims (128, 160) in bf16 (the wgmma design), the
    flash forward and backward of route ``wide`` at one tile in fp32 at
    those head dims (widths 128 and 192: the parity and train_parity
    paths) with delta's pass and the parts' sum, the SSD backward's three
    tensor-core kernels in
    bf16 (mamba2's
    training path) and its four CUDA-core kernels in fp32 (its
    train_parity path) and in bf16 (the shapes the tensor-core design
    does not take; the kernels phase holds them to the plain backward).
    And the tensor-core column tiles above a head dim of 256 at both
    widths (forward, dK/dV and dQ), on the callers' rows and on staged
    copies (``kStaged``), the copy above 256 (``flash_stage_rows_kernel``,
    each load width), the backward's staged wgmma kernels at
    every padded D with their staging copies (each load width), and the
    tensor-core decode (``decode_mma_kernel``), which the contract phase
    runs, the staged forward (``flash_fwd_wgmma_kernel`` in its kStaged
    instantiation at every padded D), and every instantiation of route
    ``wide`` (``SIMT_WIDE_KERNELS``: fp32 at one tile of 64-256, which the
    contract models' parity paths run at 64, 96 and 256, and the column
    tiles above 256; forward, dK/dV and dQ, with 16-byte and element
    copies), and route ``simt`` (d up to 32: ``flash_fwd_simt_kernel``,
    ``flash_bwd_dkdv_kernel`` and ``flash_bwd_dq_kernel`` at D 16 and 32,
    both dtypes, unpadded and padded; the contract phase runs d 32 and
    17): no other model path reaches them, but they are held to no spill
    all the same."""
    pats = [r"ssd_tc_states_kernel<bf16>", r"ssd_tc_pass_kernel<bf16>",
            r"ssd_tc_outputs_kernel<bf16>", r"ssd_scan_simt_kernel<\w+>",
            r"rmsnorm_dw_kernel<f32>",
            r"rmsnorm_bwd_kernel<\w+,\d+,\d+,[01]>",
            r"rmsnorm_bwd_ring_kernel<\w+,\d+,\d+,[01]>",
            r"rmsnorm_bwd_stream_kernel<\w+,\d+,[01]>",
            r"ssd_bwd_pass_kernel<f32>",
            r"ssd_bwd_tc_states_kernel<bf16>",
            r"ssd_bwd_tc_local_kernel<bf16>",
            r"ssd_bwd_tc_reduce_kernel<bf16>"]
    pats += [rf"ssd_bwd_{k}_kernel<{dt}>" for k in ("states", "reduce")
             for dt in ("bf16", "f32")]
    pats += [rf"ssd_bwd_local_kernel<{dt},0>" for dt in ("bf16", "f32")]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for arch in TRAIN_PATHS:
        for es, dt in ((2, "bf16"), (4, "f32")):
            p = krms.bwd_plan(TRAIN_BATCH * TRAIN_SEQ,
                              get_config(arch).d_model, es, True, sms)
            pats.append(rf"rmsnorm_bwd_ring_kernel<{dt},{p.nv},{p.wpr},0>")
    # internlm2's norms under mlp_lowp (LOWP_TRAIN_PATH), bf16
    p = krms.bwd_plan(TRAIN_BATCH * TRAIN_SEQ, get_config(ARCH).d_model, 2,
                      True, sms)
    pats.append(rf"rmsnorm_bwd_ring_kernel<bf16,{p.nv},{p.wpr},1>")
    for arch in (ARCH, D160_ARCH):
        hd = get_config(arch).resolved_head_dim
        pats += [rf"flash_bwd_preprocess_kernel<bf16,{hd}>"]
        pats += [rf"flash_bwd_{k}_kernel<bf16,{hd},0>"
                 for k in ("dkdv_wgmma", "dq_wgmma")]
        tw = kflash.simt_wide_plan(hd)["width"]
        pats += [rf"flash_{k}_wide_kernel<f32,4,{tw},{kflash.ONE_TILE}>"
                 for k in ("fwd", "bwd_dkdv", "bwd_dq")]
    pats += [r"flash_bwd_preprocess_rows_kernel<f32>",
             r"flash_bwd_parts_sum_kernel<f32>"]
    for arch in PATH_KERNELS:
        cfg = get_config(arch)
        vec, nv, wpr, _ = krms.plan(1, cfg.d_model, 2, True)
        pats.append(rf"rmsnorm_kernel<bf16,{8 if vec else 1},{nv},{wpr}>")
        if "flash_attention" in PATH_KERNELS[arch]:
            hd, g = cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads
            gm = kdec.group_bucket(g)
            pats += [rf"flash_fwd_wgmma_kernel<bf16,{hd},0>",
                     rf"decode_split_kernel<bf16,{hd},{gm},{int(g == gm)},0>"]
    for m, k, n in INT8_SHAPES:
        bm, bn = kint8.TILES[kint8.plan(m, k, n, 0, 0, sms)[1]]
        pats.append(rf"int8_wgmma_kernel<\w+,{bm // 64},{bn},\d+,1>")
    pats += [rf"flash_{k}_wgmma_wide_kernel<bf16,{n},{staged}>"
             for k in ("fwd", "bwd_dkdv", "bwd_dq")
             for n in kflash.TC_WIDE_WIDTHS for staged in (0, 1)]
    pats += [rf"flash_stage_rows_kernel<bf16,{w}>" for w in (1, 2, 4)]
    pats += [rf"flash_bwd_{k}_wgmma_kernel<bf16,{n},1>"
             for k in ("dkdv", "dq") for n in (64, 128, 160, 256)]
    pats += [rf"flash_stage_rows_group_kernel<bf16,{w}>" for w in (1, 2, 4)]
    pats += [rf"flash_fwd_wgmma_kernel<bf16,{n},2>"
             for n in (64, 128, 160, 256)]
    pats.append(r"decode_mma_kernel<bf16>")
    label = {torch.float32: "f32", torch.bfloat16: "bf16"}
    pats += [rf"flash_{k}_wide_kernel<{label[dt]},{vec},{tw},{mode}>"
             for k in ("fwd", "bwd_dkdv", "bwd_dq")
             for dt, vec, tw, mode in kflash.SIMT_WIDE_KERNELS]
    pats.append(r"flash_bwd_parts_sum_kernel<bf16>")
    pats += [rf"flash_{k}_kernel<{dt},{n},{pad}>"
             for k in ("fwd_simt", "bwd_dkdv", "bwd_dq")
             for dt in ("bf16", "f32") for n in (16, 32) for pad in (0, 1)]
    return pats


def phase_build() -> None:
    """Build, then report each kernel's registers and spills; a kernel the
    main paths launch must have been reported, and must not spill."""
    info = _build.build()
    ptxas = _ptxas_summary(info.ptxas)
    spills = [p for p in ptxas if not p.endswith(", 0 B spill")]
    pats = _main_path_patterns()
    main = [p for p in ptxas
            if any(re.fullmatch(pat, p.split(":")[0]) for pat in pats)]
    missing = [pat for pat in pats
               if not any(re.fullmatch(pat, p.split(":")[0]) for p in main)]
    emit({"phase": "build", "seconds": info.seconds, "cached": info.cached,
          "library": os.path.relpath(info.path), "entries": len(ptxas),
          "spills": spills, "main_path": main})
    if missing:
        raise AssertionError(f"ptxas reported no instantiation of {missing}")
    main_spills = [p for p in main if not p.endswith(", 0 B spill")]
    if main_spills:
        raise AssertionError(f"main-path kernels spill: {main_spills}")


def _rmsnorm_case(path, rows, d, dtype, lowp, seed=0):
    x, w = randn((rows, d), dtype, seed), randn((d,), torch.float32, seed + 1)
    out = krms.rmsnorm(x, w, 1e-5, lowp=lowp)
    torch.cuda.synchronize()
    err = max_err(out, krms.plain(x, w, 1e-5, lowp), dtype)
    wl = w.to(dtype)
    b_ms, by = bound(*kernel_cost.rmsnorm(rows, d, x.element_size()))
    return {"kernel": "rmsnorm", "path": path, "shape": [rows, d],
            "dtype": str(dtype),
            "lowp": lowp, "max_abs_err": err,
            "ms": time_ms(lambda: krms.rmsnorm(x, w, 1e-5, lowp=lowp)),
            "eager_ms": eager_ms(lambda: krms.rmsnorm(x, w, 1e-5, lowp=lowp)),
            "plain_ms": time_ms(lambda: krms.plain(x, w, 1e-5, lowp)),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), wl, 1e-5)),
            "bound_ms": b_ms, "bound_by": by}


def _rmsnorm_bwd_check(call, want, dtype, design, lowp=False) -> float:
    """Two calls of one rmsnorm backward design, each one ``rmsnorm_bwd``
    launch and bitwise equal; a CUDA graph of three calls, replayed twice,
    bitwise equal to them; dx at ``KERNEL_TOL``, dw at fp32's
    ``KERNEL_TOL`` and within ``RMS_BWD_DW_TOL`` x (1 + its max-abs) of
    the plain backward (under bf16 lowp, where dw is rounded to bf16 once,
    both at bf16's ``KERNEL_TOL``). Returns the max abs error."""
    lowp = lowp and dtype == torch.bfloat16
    dw_tol = KERNEL_TOL[torch.bfloat16] if lowp else RMS_BWD_DW_TOL
    dw_kind = torch.bfloat16 if lowp else torch.float32
    before = krms.KERNEL_BWD.launches
    (dx, dw), (dx2, dw2) = call(), call()
    torch.cuda.synchronize()
    launches = krms.KERNEL_BWD.launches - before
    if launches != 2:
        raise AssertionError(f"rmsnorm_bwd {design} counted {launches} "
                             f"launches")
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        raise AssertionError(f"rmsnorm_bwd {design}: two calls differ")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call() for _ in range(3)]
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(a, dx) and torch.equal(b, dw) for a, b in outs):
        raise AssertionError(f"rmsnorm_bwd {design}: graph replays differ "
                             f"from an eager call")
    want_dx, want_dw = want
    dw_err = (dw - want_dw).abs().max().item()
    scale = 1 + want_dw.abs().max().item()
    if not torch.isfinite(dw).all() or dw_err > dw_tol * scale:
        raise AssertionError(f"rmsnorm_bwd {design} dw: max abs err "
                             f"{dw_err} > {dw_tol} x {scale}")
    return max(max_err(dx, want_dx, dtype), max_err(dw, want_dw, dw_kind))


def _rmsnorm_bwd_case(rows, d, dtype, seed=0, path=TRAIN_PATH, lowp=False):
    """The backward of one norm of a training step: ``rows`` = b x s, on
    the design training takes (``krms.bwd_design``), held to
    ``_rmsnorm_bwd_check`` (``lowp``: against ``ref.rmsnorm_lowp_bwd_ref``,
    dw then rounded to bf16). Every other design that takes the row is
    held to the same checks on the same inputs and timed in turns with it:
    each design twice, in the order a, b, b, a; ``ms`` is the mean of the
    chosen design's two."""
    x, w = randn((rows, d), dtype, seed), randn((d,), torch.float32, seed + 1)
    dy = randn((rows, d), dtype, seed + 2)
    want = krms.plain_bwd(x, w, dy, 1e-5, lowp)
    e = x.element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    design = krms.bwd_design(d, e, True)

    def takes(o):       # block_rows takes rows of up to 1024 chunks
        try:
            krms.bwd_plan(rows, d, e, True, sms, o)
        except ValueError:
            return False
        return True
    designs = [design] + [o for o in krms.BWD_DESIGNS
                          if o != design and takes(o)]
    calls = {o: (lambda o=o: krms._kernel_backward(x, w, dy, 1e-5, o,
                                                   lowp=lowp))
             for o in designs}
    errs = {krms.BWD_DESIGNS[o]: _rmsnorm_bwd_check(
        calls[o], want, dtype, krms.BWD_DESIGNS[o], lowp) for o in designs}
    runs = {}
    for o in designs + designs[::-1]:
        runs.setdefault(krms.BWD_DESIGNS[o], []).append(time_ms(calls[o]))
    by_design = {k: sum(v) / len(v) for k, v in runs.items()}
    name = krms.BWD_DESIGNS[design]
    # F.rms_norm's backward through autograd (its weight in x's dtype):
    # forward and backward replayed, less the forward alone.
    xl = x.clone().requires_grad_(True)
    wl = w.to(dtype, copy=True).requires_grad_(True)
    lib_fwd = lambda: F.rms_norm(xl, (d,), wl, 1e-5)
    lib_both = lambda: torch.autograd.grad(lib_fwd(), (xl, wl), dy)
    b_ms, by = bound(*kernel_cost.rmsnorm_bwd(rows, d, e))
    return {"kernel": "rmsnorm_bwd", "path": path, "shape": [rows, d],
            "dtype": str(dtype), "lowp": lowp, "design": name,
            "checked_launches": 2 * len(designs),
            "plan": krms.bwd_plan(rows, d, e, True, sms)._asdict(),
            "max_abs_err": errs[name], "max_abs_err_by_design": errs,
            "bitwise_repeat": True, "graph_replay_bitwise": True,
            "ms": by_design[name], "ms_by_design": by_design,
            "runs_ms_by_design": runs,
            "kernel_us": device_us(calls[design]),
            "eager_ms": eager_ms(calls[design]),
            "plain_ms": time_ms(lambda: krms.plain_bwd(x, w, dy, 1e-5,
                                                       lowp)),
            "library_ms": time_ms(lib_both) - time_ms(lib_fwd),
            "library_call": "F.rms_norm backward (autograd): forward and "
                            "backward less the forward, each replayed",
            "bound_ms": b_ms, "bound_by": by}


def _flash_bwd_case(arch, b, s, dtype, seed=0, path=TRAIN_PATH):
    """The backward of one layer's causal self-attention in training, at
    ``arch``'s heads; ``design`` names the route the call takes."""
    hq, hkv, d = _heads(arch)
    q = randn((b, s, hq, d), dtype, seed)
    k = randn((b, s, hkv, d), dtype, seed + 1)
    v = randn((b, s, hkv, d), dtype, seed + 2)
    dout = randn((b, s, hq, d), dtype, seed + 3)
    scale = d ** -0.5
    out, lse = kflash._kernel_forward(q, k, v, True, scale, with_lse=True)
    got = kflash._kernel_backward(q, k, v, out, dout, lse, True, scale)
    torch.cuda.synchronize()
    want = kflash.plain_bwd(q, k, v, out, dout, lse, causal=True,
                            scale=scale)
    err = max(max_err(g, w_, dtype) for g, w_ in zip(got, want))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dt_ = dout.transpose(1, 2)
    lib_fwd = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_both = lambda: torch.autograd.grad(lib_fwd(), (qt, kt, vt), dt_)
    b_ms, by = bound(*kernel_cost.flash_bwd(b, s, s, hq, hkv, d, dtype))
    return {"kernel": "flash_attention_bwd", "path": path,
            "heads_of": arch, "shape": [b, s, hq, hkv, d],
            "dtype": str(dtype), "design": kflash.bwd_design(dtype, d),
            "max_abs_err": err,
            "kernel_us": device_us(lambda: kflash._kernel_backward(
                q, k, v, out, dout, lse, True, scale)),
            "ms": time_ms(lambda: kflash._kernel_backward(
                q, k, v, out, dout, lse, True, scale), 5),
            "eager_ms": eager_ms(lambda: kflash._kernel_backward(
                q, k, v, out, dout, lse, True, scale), 10),
            "plain_ms": time_ms(lambda: kflash.plain_bwd(
                q, k, v, out, dout, lse, causal=True, scale=scale), 3),
            "library_ms": time_ms(lib_both, 5) - time_ms(lib_fwd, 5),
            "library_call": "F.scaled_dot_product_attention(is_causal, "
                            "enable_gqa) backward (autograd): forward and "
                            "backward less the forward, each replayed",
            "bound_ms": b_ms, "bound_by": by}


def _heads(arch):
    cfg = get_config(arch)
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


def _flash_case(arch, sq, dtype, seed=0, b=1, path=None):
    """One layer's prefill of ``sq`` tokens at ``arch``'s heads (or, with
    ``b``, one layer's training forward)."""
    hq, hkv, d = _heads(arch)
    q = randn((b, sq, hq, d), dtype, seed)
    k = randn((b, sq, hkv, d), dtype, seed + 1)
    v = randn((b, sq, hkv, d), dtype, seed + 2)
    out = kflash.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = max_err(out, kflash.plain(q, k, v, causal=True), dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b_ms, by = bound(*kernel_cost.flash(b, sq, sq, hq, hkv, d, dtype))
    return {"kernel": "flash_attention", "path": path or arch,
            "shape": [b, sq, hq, hkv, d],
            "dtype": str(dtype), "max_abs_err": err,
            "ms": time_ms(lambda: kflash.flash_attention(q, k, v)),
            "eager_ms": eager_ms(lambda: kflash.flash_attention(q, k, v)),
            "plain_ms": time_ms(lambda: kflash.plain(q, k, v), 5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": by}


def _decode_case(arch, dtype, skv, lengths, seed=0, path=None):
    """One layer's decode tick of SLOTS slots against a cache of ``skv`` at
    ``arch``'s heads (``path``, where no serve run of ``arch`` gives the
    row its launches: the kernels phase, which counts its checked call)."""
    b, (hq, hkv, d) = SLOTS, _heads(arch)
    q = randn((b, hq, d), dtype, seed)
    k = randn((b, skv, hkv, d), dtype, seed + 1)
    v = randn((b, skv, hkv, d), dtype, seed + 2)
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = kdec.KERNEL.launches
    out = kdec.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    launches = kdec.KERNEL.launches - before
    err = max_err(out, kdec.plain(q, k, v, length), dtype)
    mask = (torch.arange(skv, device="cuda")[None, :] < length[:, None])
    mask = mask[:, None, None, :]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    b_ms, by = bound(*kernel_cost.decode(b, hq, hkv, d, sum(lengths), dtype))
    return {"kernel": "decode_attention", "path": path or arch,
            "heads_of": arch, "shape": [b, skv, hq, hkv, d],
            "group_bucket": kdec.group_bucket(hq // hkv),
            "checked_launches": launches,
            "splits": kdec.num_splits(skv), "lengths": lengths,
            "dtype": str(dtype), "max_abs_err": err,
            "ms": time_ms(lambda: kdec.decode_attention(q, k, v, length)),
            "eager_ms": eager_ms(
                lambda: kdec.decode_attention(q, k, v, length)),
            "plain_ms": time_ms(lambda: kdec.plain(q, k, v, length), 10),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": by}


def _decode_partial_case(arch, dtype, skv, lengths, seed=0):
    """Partial mode (``return_lse``) on one rank's slice of ``skv`` rows of
    a sequence-sharded cache at ``arch``'s heads, with local lengths of 0,
    inside the slice and the whole slice: out and lse against the plain
    partial version (lse -inf exactly where the length is 0, finite lse
    within the fp32 tolerance), out equal to the kernel's without the lse,
    which is timed beside it (``lse_off_ms``)."""
    b, (hq, hkv, d) = SLOTS, _heads(arch)
    q = randn((b, hq, d), dtype, seed)
    k = randn((b, skv, hkv, d), dtype, seed + 1)
    v = randn((b, skv, hkv, d), dtype, seed + 2)
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    call = lambda: kdec.decode_attention(q, k, v, length, return_lse=True)
    before = kdec.KERNEL.launches
    out, lse = call()
    torch.cuda.synchronize()
    launches = kdec.KERNEL.launches - before
    want, want_lse = kdec.plain(q, k, v, length, return_lse=True)
    err = max_err(out, want, dtype)
    empty = torch.isneginf(want_lse)
    if not torch.equal(torch.isneginf(lse), empty) or \
            not torch.equal(empty.any(1), length == 0):
        raise AssertionError("decode partial: lse is -inf off the empty "
                             "slots")
    lse_err = max_err(lse[~empty], want_lse[~empty], torch.float32)
    if not torch.equal(out, kdec.decode_attention(q, k, v, length)) or \
            bool(out[length == 0].any()):
        raise AssertionError("decode partial: out differs from the plain "
                             "mode's or is nonzero at length 0")
    mask = (torch.arange(skv, device="cuda")[None, :] < length[:, None])
    mask = mask[:, None, None, :]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    b_ms, by = bound(*kernel_cost.decode(b, hq, hkv, d, sum(lengths), dtype,
                                         lse=True))
    return {"kernel": "decode_attention", "path": SHARDED_SERVE_PATH,
            "mode": "partial (return_lse)", "heads_of": arch,
            "shape": [b, skv, hq, hkv, d], "lengths": lengths,
            "checked_launches": launches, "dtype": str(dtype),
            "max_abs_err": max(err, lse_err), "out_max_abs_err": err,
            "lse_max_abs_err": lse_err,
            "ms": time_ms(call), "eager_ms": eager_ms(call),
            "lse_off_ms": time_ms(lambda: kdec.decode_attention(
                q, k, v, length)),
            "plain_ms": time_ms(lambda: kdec.plain(
                q, k, v, length, return_lse=True), 10),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)),
            "library_note": "SDPA gives out, not the lse (a slot of "
                            "length 0 is masked out whole there)",
            "bound_ms": b_ms, "bound_by": by}


def _ssd_inputs(b, s, h, p, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device="cuda").to(dtype)
    dt = 0.01 + 0.29 * torch.rand((b, s, h), generator=g, device="cuda")
    A = -(0.3 + 1.7 * torch.rand((h,), generator=g, device="cuda"))
    B = torch.randn((b, s, n), generator=g, device="cuda").to(dtype)
    C = torch.randn((b, s, n), generator=g, device="cuda").to(dtype)
    D = torch.randn((h,), generator=g, device="cuda")
    return x, dt, A, B, C, D


def _ssd_case(s, dtype, seed=0, b=1, path=MAMBA_ARCH):
    """One SSD layer of mamba2-130m at batch ``b`` (1 in serving) and
    ``s`` steps."""
    h, p, n, chunk = 24, 64, 128, 256
    args = _ssd_inputs(b, s, h, p, n, dtype, seed)
    x = args[0]
    y, st = kssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    want_y, want_st = kssd.plain(*args, chunk=chunk)
    err = max(max_err(y, want_y, dtype, SSD_TOL[dtype]),
              max_err(st, want_st, torch.float32, SSD_TOL[torch.float32]))
    b_ms, by = bound(*kernel_cost.ssd(b, s, h, p, n, dtype, chunk))
    return {"kernel": "ssd_scan", "path": path,
            "shape": [b, s, h, p, n], "chunk": chunk,
            "design": kssd.DESIGNS[kssd.plan(dtype, n, p)],
            "dtype": str(dtype), "max_abs_err": err,
            "kernel_us": device_us(lambda: kssd.ssd_scan(*args,
                                                          chunk=chunk)),
            "ms": time_ms(lambda: kssd.ssd_scan(*args, chunk=chunk)),
            "eager_ms": eager_ms(lambda: kssd.ssd_scan(*args, chunk=chunk)),
            "plain_ms": time_ms(lambda: kssd.plain(*args, chunk=chunk), 5),
            "library_ms": None,
            "library_note": "no single PyTorch call computes the SSD scan",
            "bound_ms": b_ms, "bound_by": by}


def _ssd_bwd_check(call, want, dtype, design) -> tuple:
    """Two calls of one backward design, each one ``ssd_scan_bwd`` launch
    and bitwise equal; each gradient against the closed form ``want``:
    bf16 dx, dB, dC at one ulp, the rest at ``SSD_BWD_TOL`` of max-abs.
    Returns (abs errors, errors over max-abs)."""
    before = kssd.KERNEL_BWD.launches
    got, again = call(), call()
    torch.cuda.synchronize()
    launches = kssd.KERNEL_BWD.launches - before
    if launches != 2:
        raise AssertionError(f"ssd_scan_bwd {design} counted {launches} "
                             f"launches")
    errs, rel = {}, {}
    for name, gk, w, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got,
                              want, again):
        if not torch.equal(gk, r):
            raise AssertionError(f"ssd_scan_bwd {design} {name}: two calls "
                                 f"differ")
        if dtype == torch.bfloat16 and name in SSD_BWD_LOWP:
            errs[name] = max_err(gk, w, dtype)
        else:
            err = (gk.float() - w.float()).abs().max().item()
            scale = w.float().abs().max().item()
            if not torch.isfinite(gk).all() or err > SSD_BWD_TOL * scale:
                raise AssertionError(f"ssd_scan_bwd {design} {name}: max abs "
                                     f"err {err} > {SSD_BWD_TOL} x {scale}")
            errs[name] = err
            rel[name] = err / scale
    return errs, rel


def _ssd_bwd_case(dtype, p=64, with_state=False, seed=0):
    """The backward of one SSD layer of mamba2-130m's training step (b 8,
    s 256, 24 heads, n 128, chunk 256; p 128 at jamba's head dim), the
    final state's gradient zero (None, as training gives it) or not, on
    the design training takes (``kssd.bwd_design``): each gradient against
    the closed form, two calls bitwise equal. Where that is the tensor-core
    design, the CUDA-core one is held to the same checks on the same
    inputs, and timed beside it."""
    b, s, h, n, chunk = TRAIN_BATCH, TRAIN_SEQ, 24, 128, 256
    args = _ssd_inputs(b, s, h, p, n, dtype, seed)
    dy = randn((b, s, h, p), dtype, seed + 1)
    ds = randn((b, h, p, n), torch.float32, seed + 2) if with_state else None
    want = kssd.plain_bwd(*args, dy, ds, chunk=chunk)
    design = kssd.bwd_design(dtype, n, p)
    call = lambda: kssd._kernel_backward(*args, dy, ds)
    errs, rel = _ssd_bwd_check(call, want, dtype, kssd.DESIGNS[design])
    side = {}
    if design == kssd.TENSOR_CORES:     # the CUDA-core design, same inputs
        simt = lambda: kssd._kernel_backward(*args, dy, ds, kssd.SIMT)
        s_errs, s_rel = _ssd_bwd_check(simt, want, dtype,
                                       kssd.DESIGNS[kssd.SIMT])
        side = {"simt_max_abs_err": max(s_errs.values()),
                "simt_abs_err": s_errs, "simt_err_over_maxabs": s_rel,
                "simt_ms": time_ms(simt, 5),
                "simt_kernel_us": device_us(simt)}
    b_ms, by = bound(*kernel_cost.ssd_bwd(b, s, h, p, n, dtype, chunk,
                                         with_state))
    return {"kernel": "ssd_scan_bwd", "path": MAMBA_TRAIN_PATH,
            "shape": [b, s, h, p, n], "chunk": chunk, "dtype": str(dtype),
            "design": kssd.DESIGNS[design],
            "dstate": "nonzero" if with_state else "zero (None)",
            "max_abs_err": max(errs.values()), "abs_err": errs,
            "err_over_maxabs": rel, "bitwise_repeat": True,
            "kernel_us": device_us(call),
            "ms": time_ms(call, 5), **side, "eager_ms": eager_ms(call, 10),
            "plain_ms": time_ms(lambda: kssd.plain_bwd(
                *args, dy, ds, chunk=chunk), 2, 3),
            "library_ms": None,
            "library_note": "no single PyTorch call computes the SSD scan "
                            "or its backward",
            "bound_ms": b_ms, "bound_by": by}


def _int8_case(m, k, n, out_dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                       dtype=torch.int8)
    sx = torch.rand((m,), generator=g, device="cuda") / 127
    sw = torch.rand((n,), generator=g, device="cuda") / 127
    before = kint8.KERNEL.launches
    out = kint8.int8_matmul(xq, sx, wq, sw, out_dtype)
    torch.cuda.synchronize()
    launches = kint8.KERNEL.launches - before
    err = max_err(out, kint8.plain(xq, sx, wq, sw, out_dtype), out_dtype,
                  INT8_TOL)

    def library():      # timed only: the port never calls torch._int_mm
        acc = torch._int_mm(xq, wq)
        return (acc.float() * sx[:, None] * sw[None, :]).to(out_dtype)
    vec, tile = kint8.plan(m, k, n, xq.data_ptr(), wq.data_ptr(),
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    b_ms, by = bound(*kernel_cost.int8_matmul(m, k, n, out_dtype))
    return {"kernel": "int8_matmul", "path": KERNELS_PHASE,
            "shape": [m, k, n], "vec": vec, "tile": kint8.TILES[tile],
            "dtype": str(out_dtype), "max_abs_err": err,
            "checked_launches": launches,
            "ms": time_ms(lambda: kint8.int8_matmul(xq, sx, wq, sw,
                                                    out_dtype)),
            "eager_ms": eager_ms(lambda: kint8.int8_matmul(xq, sx, wq, sw,
                                                           out_dtype)),
            "plain_ms": time_ms(lambda: kint8.plain(xq, sx, wq, sw,
                                                    out_dtype), 5),
            "library_ms": time_ms(library),
            "library_call": "torch._int_mm, then the scales",
            "int_mm_ms": time_ms(lambda: torch._int_mm(xq, wq)),
            "bound_ms": b_ms, "bound_by": by}


def phase_kernels() -> dict:
    """Returns, for each (kernel, path), the first bf16 case: the shape
    that path gives the kernel (int8_matmul: the JAX benchmark's shape, in
    fp32 as the JAX kernel's default output). The ``launches`` of a case
    whose path is the kernels phase (int8_matmul; decode at
    llama4-maverick's heads) are its checked calls here: no model path
    runs it at full width."""
    d_model = {a: get_config(a).d_model for a in PATH_KERNELS}
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        # rmsnorm at each path's width: one prefill (internlm2 and
        # granite-moe: 333 tokens, mamba2: 512) and one decode tick of
        # SLOTS rows, lowp off first as the configs run it.
        for arch, rows in ((ARCH, PROMPT_LENS[0]), (MAMBA_ARCH, 512),
                           (MOE_ARCH, PROMPT_LENS[0])):
            for r in (rows, SLOTS):
                for lowp in (False, True):
                    cases.append(_rmsnorm_case(arch, r, d_model[arch],
                                               dtype, lowp))
        # flash at the first prompt, then 512 and the serve run's shortest
        # and longest prompts; decode at the serve cache, then at a cache
        # of 4096 with lengths spread to 4000. granite-moe's heads (d 64)
        # at the first prompt and the serve cache.
        for sq in (PROMPT_LENS[0], 512, min(PROMPT_LENS), max(PROMPT_LENS)):
            cases.append(_flash_case(ARCH, sq, dtype))
        for skv, lengths in DECODE_CASES:
            cases.append(_decode_case(ARCH, dtype, skv, lengths))
        # partial mode on one rank's slice of a sequence-sharded cache
        cases.append(_decode_partial_case(ARCH, dtype, PARTIAL_SLICE,
                                          PARTIAL_LENGTHS))
        cases.append(_flash_case(MOE_ARCH, PROMPT_LENS[0], dtype))
        cases.append(_decode_case(MOE_ARCH, dtype, *DECODE_CASES[0]))
        # NEW_ARCHS: rmsnorm at each width (5120, 896, 2048, 768), flash at
        # the first prompt and decode at the serve cache at each arch's
        # heads; stablelm-12b's d 160 also at a cache of 4096, and
        # llama4-maverick's group of 5 (no full-width path).
        for arch in NEW_ARCHS:
            for r in (PROMPT_LENS[0], SLOTS):
                cases.append(_rmsnorm_case(arch, r, d_model[arch], dtype,
                                           False))
            cases.append(_flash_case(arch, PROMPT_LENS[0], dtype))
            cases.append(_decode_case(arch, dtype, *DECODE_CASES[0]))
        cases.append(_decode_case("stablelm-12b", dtype, *DECODE_CASES[1]))
        cases.append(_decode_case(GROUP5_ARCH, dtype, *DECODE_CASES[0],
                                  path=KERNELS_PHASE))
        for s in SSD_LENS[dtype]:
            cases.append(_ssd_case(s, dtype))
        # The training path: one norm and one attention of a step, forward
        # and backward, at b 8 x s 256.
        rows = TRAIN_BATCH * TRAIN_SEQ
        cases.append(_rmsnorm_case(TRAIN_PATH, rows, d_model[ARCH], dtype,
                                   False))
        cases.append(_rmsnorm_bwd_case(rows, d_model[ARCH], dtype))
        cases.append(_flash_case(ARCH, TRAIN_SEQ, dtype, b=TRAIN_BATCH,
                                 path=TRAIN_PATH))
        cases.append(_flash_bwd_case(ARCH, TRAIN_BATCH, TRAIN_SEQ, dtype))
        # its norms under mlp_lowp (in fp32 the flag changes nothing), and
        # the rmsnorm backward at a row only the stream design takes
        cases.append(_rmsnorm_case(LOWP_TRAIN_PATH, rows, d_model[ARCH],
                                   dtype, True))
        cases.append(_rmsnorm_bwd_case(rows, d_model[ARCH], dtype,
                                       path=LOWP_TRAIN_PATH, lowp=True))
        for lowp in (False, True):
            cases.append(_rmsnorm_bwd_case(*RMS_WIDE_ROWS, dtype,
                                           path=KERNELS_PHASE, lowp=lowp))
        if dtype == torch.bfloat16:     # the wgmma design at d 64 too
            cases.append(_flash_bwd_case(MOE_ARCH, TRAIN_BATCH, TRAIN_SEQ,
                                         dtype))
        # stablelm-12b's training path (d 160, 32/8 heads): its norm at d
        # 5120 and one attention, forward and backward.
        d160 = get_config(D160_ARCH)
        cases.append(_rmsnorm_case(D160_TRAIN_PATH, rows, d160.d_model,
                                   dtype, False))
        cases.append(_rmsnorm_bwd_case(rows, d160.d_model, dtype,
                                       path=D160_TRAIN_PATH))
        cases.append(_flash_case(D160_ARCH, TRAIN_SEQ, dtype, b=TRAIN_BATCH,
                                 path=D160_TRAIN_PATH))
        cases.append(_flash_bwd_case(D160_ARCH, TRAIN_BATCH, TRAIN_SEQ,
                                     dtype, path=D160_TRAIN_PATH))
        # mamba2's training path: its norm, one SSD layer forward and
        # backward (the final state's gradient zero, as training gives it,
        # and not), and in fp32 the backward at jamba's head dim of 128.
        cases.append(_rmsnorm_case(MAMBA_TRAIN_PATH, rows,
                                   d_model[MAMBA_ARCH], dtype, False))
        cases.append(_rmsnorm_bwd_case(rows, d_model[MAMBA_ARCH], dtype,
                                       path=MAMBA_TRAIN_PATH))
        cases.append(_ssd_case(TRAIN_SEQ, dtype, b=TRAIN_BATCH,
                               path=MAMBA_TRAIN_PATH))
        for with_state in (False, True):
            cases.append(_ssd_bwd_case(dtype, with_state=with_state))
        if dtype == torch.float32:
            cases.append(_ssd_bwd_case(dtype, p=128))
    for m, k, n in INT8_SHAPES:
        for out_dtype in (torch.float32, torch.bfloat16):
            cases.append(_int8_case(m, k, n, out_dtype))
    emit({"phase": "kernels", "tolerance": {
        "bfloat16": KERNEL_TOL[torch.bfloat16],
        "float32": KERNEL_TOL[torch.float32],
        "ssd_scan": {"bfloat16": SSD_TOL[torch.bfloat16],
                     "float32": SSD_TOL[torch.float32]},
        "ssd_scan_bwd": {"over_maxabs": SSD_BWD_TOL,
                         "bfloat16 " + "/".join(SSD_BWD_LOWP):
                         KERNEL_TOL[torch.bfloat16]},
        "int8_matmul": INT8_TOL}, "cases": cases})
    # bf16 is the serving dtype; the first bf16 case of each (kernel, path)
    # is the shape that path gives it (one prompt of PROMPT_LENS[0] tokens
    # or one 512-token mamba2 prefill, lowp off as in the configs; decode
    # at SLOTS slots and MAX_LEN).
    head = {}
    for c in cases:
        head.setdefault((c["kernel"], c["path"]), c)
    for (name, path), c in head.items():
        if path == KERNELS_PHASE:
            c["launches"] = sum(x["checked_launches"] for x in cases
                                if (x["kernel"], x["path"]) == (name, path))
    return head


# ---------------------------------------------------------------------------
# The contract phase: shapes the Pallas kernels compute and no model path
# above runs. Head dims off the instantiated set (phi-3-mini's 96, phi-2's
# 80, gemma-2b's 256, and 100 and 99, whose bf16 rows are not whole 16-byte
# chunks: the staged route, at an even and an odd d), the CUDA-core route
# "simt" at d 32 and 17 (its only head dims, both dtypes: d == D and
# padded), falcon-7b's group of 71 q heads on one kv head, d_state 512.
# ---------------------------------------------------------------------------
CONTRACT_PATH = "contract phase"
# Above 256 (the column-tile kernels): d 257 (rows not whole 16-byte
# chunks, two tiles; bf16 on the tensor cores through staged rows), 288
# with a group of 4, 512
# and 576 on one kv head (three tiles of 192; in bf16 these three on the
# tensor cores); decode at a group of 16 at d 512 and the absorbed MLA
# decode of DeepSeek-V2/V3 (128 q heads on one latent head of 512 + 64).
CONTRACT_FLASH = ((32, 32, 96), (32, 32, 80), (8, 1, 256), (8, 8, 100),
                  (8, 2, 99), (8, 2, 32), (8, 2, 17), (8, 8, 257),
                  (8, 2, 288), (8, 8, 512), (8, 1, 576))
CONTRACT_DECODE = ((71, 1, 64), (8, 1, 256), (32, 32, 96), (16, 1, 512),
                   (128, 1, 576))
CONTRACT_SSD = (1, 512, 8, 64, 512)        # b, s, h, p, n
# internlm2-1.8b at PARITY_LAYERS layers with three attention layouts of
# ModelConfig.replace: gemma-2b's, a group of 32, and phi-3-mini's.
CONTRACT_MODELS = {"gemma-2b heads": dict(num_heads=8, num_kv_heads=1,
                                          head_dim=256),
                   "group 32": dict(num_heads=32, num_kv_heads=1,
                                    head_dim=64),
                   "phi-3-mini heads": dict(num_heads=32, num_kv_heads=32,
                                            head_dim=96)}


@contextlib.contextmanager
def _no_plain(*mods):
    """Inside, a call of any of ``mods``' plain versions raises: every
    call on the card must launch its kernel."""
    def refuse(*_, **__):
        raise AssertionError("a CUDA call went to the plain version")
    saved = [(m, n, getattr(m, n)) for m in mods
             for n in ("plain", "plain_bwd") if hasattr(m, n)]
    for m, n, _ in saved:
        setattr(m, n, refuse)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _launched(kernels, calls, want):
    """Run ``calls`` with the plain versions refused; each of ``kernels``
    must have launched ``want[i]`` times. Returns the calls' results."""
    before = [k.launches for k in kernels]
    with _no_plain(kflash, kdec, kssd):
        out = calls()
        torch.cuda.synchronize()
    got = [k.launches - b for k, b in zip(kernels, before)]
    if got != list(want):
        raise AssertionError(f"launches {got} != {list(want)} of "
                             f"{[k.name for k in kernels]}")
    return out, dict(zip((k.name for k in kernels), got))


def _contract_flash_case(hq, hkv, d, dtype, seed=0):
    """Flash forward and backward at b 8, s 256, causal: the wrapper
    (no grad), the forward with its log-sum-exp and the backward, and one
    autograd step through the wrapper, each a launch; against the plain
    forward and backward; SDPA's forward and backward timed beside."""
    b, s = TRAIN_BATCH, TRAIN_SEQ
    q = randn((b, s, hq, d), dtype, seed)
    k = randn((b, s, hkv, d), dtype, seed + 1)
    v = randn((b, s, hkv, d), dtype, seed + 2)
    dout = randn((b, s, hq, d), dtype, seed + 3)
    scale = kflash._scale(q, None)      # the wrapper's, bit for bit
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def calls():
        out = kflash.flash_attention(q, k, v)
        out2, lse = kflash._kernel_forward(q, k, v, True, scale,
                                           with_lse=True)
        grads = kflash._kernel_backward(q, k, v, out2, dout, lse, True,
                                        scale)
        auto = torch.autograd.grad(kflash.flash_attention(*leaves), leaves,
                                   dout)
        return out, out2, lse, grads, auto
    (out, out2, lse, grads, auto), launches = _launched(
        (kflash.KERNEL, kflash.KERNEL_BWD), calls, (3, 2))
    err = max_err(out, kflash.plain(q, k, v, causal=True), dtype)
    want = kflash.plain_bwd(q, k, v, out2, dout, lse, causal=True,
                            scale=scale)
    bwd_err = max(max_err(g, w, dtype) for g, w in zip(grads, want))
    if not torch.equal(out, out2) or \
            not all(torch.equal(a, g) for a, g in zip(auto, grads)):
        raise AssertionError(f"flash d {d}: the wrapper's and autograd's "
                             f"calls differ from the kernel's")
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    lib_fwd = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_both = lambda: torch.autograd.grad(lib_fwd(), (qt, kt, vt),
                                           dout.transpose(1, 2))
    fwd = lambda: kflash._kernel_forward(q, k, v, True, scale)
    bwd = lambda: kflash._kernel_backward(q, k, v, out2, dout, lse, True,
                                          scale)
    lib_ms = time_ms(lib_fwd)
    b_ms, by = bound(*kernel_cost.flash(b, s, s, hq, hkv, d, dtype))
    bb_ms, bby = bound(*kernel_cost.flash_bwd(b, s, s, hq, hkv, d, dtype))
    return {"kernel": "flash_attention", "path": CONTRACT_PATH,
            "shape": [b, s, hq, hkv, d], "dtype": str(dtype),
            "padded_head_dim": kflash.padded_head_dim(d),
            "design": kflash.fwd_design(dtype, d), "max_abs_err": err,
            **({"plan": kflash.simt_wide_plan(d)}
               if kflash.fwd_design(dtype, d) == "wide" else {}),
            "checked_launches": launches["flash_attention"],
            "ms": time_ms(fwd), "plain_ms": time_ms(lambda: kflash.plain(
                q, k, v), 5),
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": by,
            "library_call": "F.scaled_dot_product_attention(is_causal, "
                            "enable_gqa)",
            "library_backend": sdpa_backend(lib_fwd),
            "bwd": {"kernel": "flash_attention_bwd",
                    "design": kflash.bwd_design(dtype, d),
                    "max_abs_err": bwd_err,
                    "checked_launches": launches["flash_attention_bwd"],
                    "ms": time_ms(bwd, 5),
                    "plain_ms": time_ms(lambda: kflash.plain_bwd(
                        q, k, v, out2, dout, lse, causal=True,
                        scale=scale), 3),
                    "library_ms": time_ms(lib_both, 5) - time_ms(lib_fwd, 5),
                    "library_call": "SDPA backward (autograd): forward and "
                                    "backward less the forward",
                    "library_backend": sdpa_backend(lib_both),
                    "bound_ms": bb_ms, "bound_by": bby}}


def _contract_decode_case(hq, hkv, d, dtype, lse, seed=0):
    """One decode tick of SLOTS slots against the serve cache (the
    kernels phase's internlm2 case: cache MAX_LEN, lengths 129 to 731),
    plain or partial mode, against the plain version; SDPA with the
    lengths as a mask timed beside."""
    skv, lengths = DECODE_CASES[0]
    b = SLOTS
    q = randn((b, hq, d), dtype, seed)
    k = randn((b, skv, hkv, d), dtype, seed + 1)
    v = randn((b, skv, hkv, d), dtype, seed + 2)
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    call = lambda: kdec.decode_attention(q, k, v, length, return_lse=lse)
    got, launches = _launched((kdec.KERNEL,), call, (1,))
    want = kdec.plain(q, k, v, length, return_lse=lse)
    if lse:
        err = max(max_err(got[0], want[0], dtype),
                  max_err(got[1], want[1], torch.float32))
    else:
        err = max_err(got, want, dtype)
    mask = (torch.arange(skv, device="cuda")[None, :] < length[:, None])
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    b_ms, by = bound(*kernel_cost.decode(b, hq, hkv, d, sum(lengths), dtype,
                                         lse))
    g = hq // hkv
    lib = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None, None, :], enable_gqa=True)
    return {"kernel": "decode_attention", "path": CONTRACT_PATH,
            "shape": [b, skv, hq, hkv, d], "lengths": lengths,
            "mode": "partial (return_lse)" if lse else "plain",
            "dtype": str(dtype), "padded_head_dim": kflash.padded_head_dim(d),
            "group_bucket": kdec.group_bucket(g, d),
            "group_slices": kdec.group_slices(g),
            "max_abs_err": err, "checked_launches": launches[
                "decode_attention"],
            "route": kdec.pv_layout(q.element_size(), d, g)["route"],
            "design": kdec.pv_layout(q.element_size(), d, g)["route"],
            "ms": time_ms(call), "plain_ms": time_ms(lambda: kdec.plain(
                q, k, v, length, return_lse=lse), 10),
            "library_ms": time_ms(lib),
            "library_call": "F.scaled_dot_product_attention(attn_mask of "
                            "the lengths, enable_gqa)",
            "library_backend": sdpa_backend(lib),
            "bound_ms": b_ms, "bound_by": by}


def _contract_ssd_case(dtype, seed=0):
    """ssd_scan forward and backward at d_state 512 (b 1, s 512, 8 heads,
    p 64, chunk 256): the forward against the plain version, the backward
    (the final state's gradient zero, as training gives it, and not)
    against the closed form, two calls bitwise equal."""
    b, s, h, p, n = CONTRACT_SSD
    chunk = 256
    args = _ssd_inputs(b, s, h, p, n, dtype, seed)
    dy = randn((b, s, h, p), dtype, seed + 1)
    ds = randn((b, h, p, n), torch.float32, seed + 2)
    (y, st), launches = _launched((kssd.KERNEL,), lambda: kssd.ssd_scan(
        *args, chunk=chunk), (1,))
    want_y, want_st = kssd.plain(*args, chunk=chunk)
    err = max(max_err(y, want_y, dtype, SSD_TOL[dtype]),
              max_err(st, want_st, torch.float32, SSD_TOL[torch.float32]))
    bwd = {}
    for name, dstate in (("zero", None), ("nonzero", ds)):
        call = lambda dstate=dstate: kssd._kernel_backward(*args, dy, dstate)
        want = kssd.plain_bwd(*args, dy, dstate, chunk=chunk)
        with _no_plain(kssd):
            errs, rel = _ssd_bwd_check(call, want, dtype, "simt")
        bb_ms, bby = bound(*kernel_cost.ssd_bwd(b, s, h, p, n, dtype, chunk,
                                               dstate is not None))
        bwd[name] = {"max_abs_err": max(errs.values()), "abs_err": errs,
                     "err_over_maxabs": rel, "bitwise_repeat": True,
                     "checked_launches": 2,
                     "ms": time_ms(call, 5),
                     "plain_ms": time_ms(lambda dstate=dstate:
                                         kssd.plain_bwd(*args, dy, dstate,
                                                        chunk=chunk), 2, 3),
                     "bound_ms": bb_ms, "bound_by": bby}
    fwd = lambda: kssd.ssd_scan(*args, chunk=chunk)
    b_ms, by = bound(*kernel_cost.ssd(b, s, h, p, n, dtype, chunk))
    return {"kernel": "ssd_scan", "path": CONTRACT_PATH,
            "shape": [b, s, h, p, n], "chunk": chunk, "dtype": str(dtype),
            "design": kssd.DESIGNS[kssd.plan(dtype, n, p)],
            "bwd_design": kssd.DESIGNS[kssd.bwd_design(dtype, n, p)],
            "max_abs_err": err, "checked_launches": launches["ssd_scan"],
            "kernel_us": device_us(fwd), "ms": time_ms(fwd),
            "plain_ms": time_ms(lambda: kssd.plain(*args, chunk=chunk), 5),
            "library_ms": None,
            "library_note": "no single PyTorch call computes the SSD scan",
            "bound_ms": b_ms, "bound_by": by, "bwd": bwd}


def _contract_refusals() -> list:
    """What no kernel takes raises on the card, before any launch: head
    dim 0 (flash, its backward's design, decode); above 256 every d is
    taken."""
    out = []
    for d in (0,):
        q = randn((1, 8, 2, d), torch.bfloat16, 0)
        qd, ln = randn((1, 2, d), torch.bfloat16, 0), torch.ones(
            1, dtype=torch.int32, device="cuda")
        for name, call in (("flash_attention", lambda: kflash.flash_attention(
                               q, q, q)),
                           ("flash_attention_bwd", lambda: kflash.bwd_design(
                               torch.bfloat16, d)),
                           ("decode_attention", lambda: kdec.decode_attention(
                               qd, q, q, ln))):
            before = ops.launch_counts()
            try:
                call()
            except ValueError as e:
                out.append({"kernel": name, "head_dim": d,
                            "raised": str(e)})
            else:
                raise AssertionError(f"{name} at head_dim {d} did not raise")
            if ops.launch_counts() != before:
                raise AssertionError(f"{name} at head_dim {d} launched")
    return out


def _contract_rows(contract: dict) -> list:
    """Rows of the summary line for the contract phase's shapes, forward
    and backward kernels alike: launches are the phase's checked calls
    (no model path runs these shapes); route ``wide``'s rows carry its
    plan (``simt_wide_plan``: column tiles, clusters, slices of d)."""
    rows = []
    for c in contract.values():
        parts = [c]
        if c["kernel"] == "flash_attention":
            parts.append({**c["bwd"], "shape": c["shape"]})
        if c["kernel"] == "ssd_scan":
            parts += [{**b, "kernel": "ssd_scan_bwd", "shape": c["shape"],
                       "dstate": name, "design": c["bwd_design"],
                       "library_ms": None,
                       "library_note": c["library_note"]}
                      for name, b in c["bwd"].items()]
        for x in parts:
            source, replaces = SOURCES[x["kernel"]]
            if x.get("design") in ("wgmma_wide", "wgmma_wide_staged"):
                source = WGMMA_WIDE_SOURCE
            if x.get("design") == "wide" and \
                    x["kernel"].startswith("flash_attention"):
                source = SIMT_TILE_SOURCE if c["plan"]["tiles"] == 1 \
                    else SIMT_WIDE_SOURCE
            if x["kernel"] == "decode_attention" and x["design"] == "mma":
                source = DECODE_MMA_SOURCE
            rows.append({
                "name": x["kernel"], "path": CONTRACT_PATH, "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": x["checked_launches"],
                "launches_from": "contract phase (checked calls)",
                "shape": x["shape"], "dtype": c["dtype"],
                **{k: x[k] for k in ("design", "mode", "dstate")
                   if k in x},
                **({"plan": c["plan"]} if "plan" in c else {}),
                "max_abs_err": x["max_abs_err"], "ms": x["ms"],
                "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
                "bound_by": x["bound_by"], "library_ms": x["library_ms"]})
    return rows


def phase_contract(smi: str) -> dict:
    """The kernels at the shapes the Pallas kernels compute beyond the
    model paths, in bf16 and fp32 (each case's design, error against the
    plain version, launches that prove each call ran the kernel, time by
    graph replay, bound, plain version's and library's time); the
    refusals; then internlm2-1.8b at PARITY_LAYERS layers with each of
    CONTRACT_MODELS' heads, card against CPU (``phase_parity``,
    ``phase_train_parity``). Returns the first case of each new shape, by
    (kernel, shape, dtype)."""
    t0 = time.monotonic()
    cases = []

    def timed(case, *args):     # each case with its own host seconds
        t = time.monotonic()
        cases.append({**case(*args), "seconds": time.monotonic() - t})
    for dtype in (torch.bfloat16, torch.float32):
        for hq, hkv, d in CONTRACT_FLASH:
            timed(_contract_flash_case, hq, hkv, d, dtype)
        for hq, hkv, d in CONTRACT_DECODE:
            for lse in (False, True):
                timed(_contract_decode_case, hq, hkv, d, dtype, lse)
        timed(_contract_ssd_case, dtype)
    ptxas = [p for p in _ptxas_summary(_build.build().ptxas)
             if re.search(r"<\w+,256|,1>|flash_bwd_preprocess_rows|"
                          r"flash_stage_rows|decode_mma|"
                          r"ssd_scan_simt|ssd_bwd_local|wide|stream", p)]
    emit({"phase": "contract", "tolerance": {
        "bfloat16": KERNEL_TOL[torch.bfloat16],
        "float32": KERNEL_TOL[torch.float32],
        "ssd_scan": {"bfloat16": SSD_TOL[torch.bfloat16],
                     "float32": SSD_TOL[torch.float32]},
        "ssd_scan_bwd": {"over_maxabs": SSD_BWD_TOL}},
        "cases": cases, "refusals": _contract_refusals(),
        "padded_instantiations": ptxas,
        "kernels_s": time.monotonic() - t0, "nvidia_smi": smi})
    _free_card()
    for label, over in CONTRACT_MODELS.items():
        phase_parity(ARCH, (77, 45), overrides=over, label=label)
        phase_train_parity(ARCH, overrides=over, label=label)
        _free_card()
    emit({"phase": "contract", "seconds": time.monotonic() - t0,
          "nvidia_smi": smi})
    return {(c["kernel"], tuple(c["shape"]), c["dtype"],
             c.get("mode", "")): c for c in cases}


def phase_serve(smi: str, arch: str, prompt_lens) -> dict:
    """Serve ``prompt_lens`` through the launcher (and so the runtime); the
    path's own kernels must launch and the other model kernels must not,
    and the modelled telemetry must equal a CPU run's of the same
    counts."""
    cfg = get_config(arch)
    _free_card()                    # the previous model's weights
    # Warm-up (cuBLAS handles, allocator), then the measured run.
    serve(cfg, [prompt_lens[0]], max_new_tokens=2, slots=SLOTS, seed=0)
    _free_card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rep = serve(cfg, prompt_lens, max_new_tokens=NEW_TOKENS, slots=SLOTS,
                seed=0)
    launches = ops.launch_counts()
    if rep["served"] != len(prompt_lens):
        raise AssertionError(f"served {rep['served']} of {len(prompt_lens)}")
    if rep["tokens_generated"] != len(prompt_lens) * NEW_TOKENS:
        raise AssertionError(f"generated {rep['tokens_generated']} tokens")
    if not all(0 <= t < cfg.vocab_size for t in rep["sample_output"]):
        raise AssertionError(f"token ids out of range: {rep['sample_output']}")
    _check_path_launches(arch, launches)
    n_mamba = sum(k == "mamba" for k in cfg.layer_kinds())
    if launches["ssd_scan"] != len(prompt_lens) * n_mamba:
        raise AssertionError(f"ssd_scan launched {launches['ssd_scan']} "
                             f"times, not once per prefill and Mamba layer")
    # The telemetry is modelled per tick from counts (no EOS, one decode a
    # tick, utilisation from slot counts): the same counts on the CPU at
    # smoke size through the plain versions must give the same numbers.
    cpu = serve(smoke_config(cfg), [CPU_PROMPT_LEN] * len(prompt_lens),
                max_new_tokens=NEW_TOKENS, slots=SLOTS, device="cpu")
    for key in ("served", "ticks", "tokens_generated", "telemetry"):
        if cpu[key] != rep[key]:
            raise AssertionError(f"{arch}: {key} on the card {rep[key]} "
                                 f"!= CPU run {cpu[key]}")
    emit({"phase": "serve", "arch": arch, "dtype": cfg.dtype,
          "prompt_lens": list(prompt_lens), "new_tokens": NEW_TOKENS,
          "slots": SLOTS, "served": rep["served"], "ticks": rep["ticks"],
          "tokens_generated": rep["tokens_generated"],
          "tokens_per_s": rep["tokens_per_s"], "wall_s": rep["wall_s"],
          "throughput": THROUGHPUT,
          "telemetry": rep["telemetry"], "energy_model": ENERGY_MODEL,
          "telemetry_equals_cpu_run": True,
          "cpu_run": {"prompt_lens": [CPU_PROMPT_LEN] * len(prompt_lens),
                      "config": "smoke", "wall_s": cpu["wall_s"]},
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "kernel_launches": launches, "nvidia_smi": smi})
    return launches


def _free_card() -> None:
    """Collect what the last model left (engine, weights, caches) and give
    its memory back, so the next model loads into an empty card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _check_path_launches(arch: str, launches: dict) -> None:
    own = PATH_KERNELS[arch]
    missing = [k for k in own if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{arch}: kernels never launched on the path: "
                             f"{missing}")
    stray = [k for k, n in launches.items() if k not in own and n]
    if stray:
        raise AssertionError(f"{arch}: kernels of another path launched: "
                             f"{stray}")


def _device_busy_us(events):
    """Union of the CUDA kernel intervals of a profile, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def phase_profile(arch: str, prompt_lens, prefill_len: int,
                  ticks: int = 8) -> None:
    """Where the time of a serving path goes: one prefill of
    ``prefill_len`` tokens and ``ticks`` decode ticks of a full batch,
    timed without the profiler (host clock around work that ends in a
    synchronize), then again under torch.profiler for the kernels' device
    time and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(arch)
    max_len = max(prompt_lens) + NEW_TOKENS + 8
    eng = ServingEngine(cfg, ServeConfig(max_seq_len=max_len))
    eng.init_random(0)
    bat = ContinuousBatcher(eng, slots=SLOTS)
    rng = np.random.default_rng(0)
    for n in prompt_lens[:SLOTS]:
        bat.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=4 * ticks)
    bat.step()                      # admits SLOTS requests, first decode
    for _ in range(2):
        bat.step()
    torch.cuda.synchronize()
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, prefill_len)
                             [None], dtype=torch.long, device="cuda")

    def prefill():
        eng.prefill_fn(eng.params, {"tokens": prompt})

    def decode():
        for _ in range(ticks):
            bat.step()

    prefill()                       # warm this prompt length
    torch.cuda.synchronize()
    out = {"phase": "profile", "arch": arch, "dtype": cfg.dtype,
           "prefill_tokens": prefill_len, "slots": SLOTS, "ticks": ticks}
    for name, run, n in (("prefill", prefill, 1), ("decode", decode, ticks)):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / n
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
        busy_ms = _device_busy_us(kern) / 1e3 / n
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[name] = {
            "wall_ms": wall_ms, "traced_wall_ms": traced_ms,
            "device_busy_ms": busy_ms if kern else None,
            "device_idle_share": 1 - busy_ms / traced_ms if kern else None,
            "kernels_per_step": len(kern) / n,
            "top_device_us_per_step": [[k[:60], v / n] for k, v in top]}
    emit(out)
    del eng, bat


class RouterLog:
    """While active, records each MoE layer call's routing on the side
    ``side`` names: every token's top-k experts (as a sorted set) and the
    gap between the k-th and the next expert's probability."""

    def __init__(self):
        self.side = None
        self.calls = {side: [] for side in PARITY_SIDES}
        self.token_layers = 0
        self.min_gap = float("inf")
        self._orig = moe.moe_apply

    def __enter__(self):
        def recorded(params, cfg, x, **kw):
            k, e = cfg.moe.top_k, cfg.moe.num_experts
            xt = x.reshape(-1, x.shape[-1])
            probs = torch.softmax(xt.float() @ params["router"].float(), -1)
            top_p, top_i = torch.topk(probs, min(k + 1, e), dim=-1)
            gap = (top_p[:, k - 1] - top_p[:, k] if k < e
                   else torch.full_like(top_p[:, 0], float("inf")))
            self.calls[self.side].append(
                (top_i[:, :k].sort(-1).values.cpu(), gap.cpu(), x.shape[0]))
            return self._orig(params, cfg, x, **kw)
        moe.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        moe.moe_apply = self._orig

    def flips(self):
        """Since the last call: (batch row, CPU-side top-k gap) of each
        token-layer whose expert set differs between the sides."""
        card, cpu = self.calls["card"], self.calls["cpu"]
        if len(card) != len(cpu):
            raise AssertionError("the sides ran different MoE layers")
        out = []
        for (ci, _, b), (pi, gap, _) in zip(card, cpu):
            self.token_layers += len(gap)
            self.min_gap = min(self.min_gap, gap.min().item())
            for tok in (ci != pi).any(-1).nonzero()[:, 0].tolist():
                out.append((tok // (len(gap) // b), gap[tok].item()))
        for calls in self.calls.values():
            calls.clear()
        return out


def phase_parity(arch: str, prompt_lens, overrides: dict | None = None,
                 label: str | None = None) -> None:
    """fp32 logits on the card (kernels) vs the CPU (plain versions):
    prefill of two prompts at batch 1, their caches copied into a batch of
    two slots, then three per-slot decode steps, as the batcher runs them.
    Both sides are fed the CPU side's greedy tokens, and without MoE layers
    the card's greedy tokens must equal them. An arch with a frontend
    (internvl2-1b) prefills its ``frontend_tokens`` embeddings of
    ``frontend_dim``, drawn from a seeded generator, before each prompt.
    With MoE layers, a sequence whose routing differs between the sides in
    any layer is left out of the logit comparison from then on
    (``RouterLog``). ``overrides`` (the contract phase's heads) go to
    ``ModelConfig.replace``; the launches must then be exactly a dense
    model's: every layer's norms and attention once a forward, the final
    norm once."""
    cfg = get_config(arch).replace(dtype="float32",
                                   num_layers=PARITY_LAYERS,
                                   **(overrides or {}))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in prompt_lens]
    ft = cfg.frontend_tokens
    # (b, frontend_tokens, frontend_dim), as the JAX launcher's specs lay
    # the patch embeddings out; one row a prompt.
    frontend = torch.randn((len(prompts), ft, cfg.frontend_dim or
                            cfg.d_model), generator=torch.Generator()
                           .manual_seed(2)) if ft else None
    max_len = max(128, ft + max(prompt_lens) + 8)
    engines, caches = {}, {}
    for side, dev in PARITY_SIDES.items():
        engines[side] = ServingEngine(cfg, ServeConfig(max_seq_len=max_len),
                                      device=dev)
        engines[side].load(tree_map(lambda t, d=dev: t.to(d), params))
        caches[side] = lm.init_caches(cfg, len(prompts), max_len,
                                      torch.device(dev))
    errs, nxt, flips, flipped = [], [], [], set()
    greedy = {side: [] for side in PARITY_SIDES}

    def agreeing(step_flips, rows):
        flips.extend(step_flips)
        flipped.update(rows[r] for r, _ in step_flips)
        return [r for r in range(len(rows)) if rows[r] not in flipped]

    ops.reset_launches()
    with RouterLog() as log:
        for slot, p in enumerate(prompts):
            lg = {}
            for side, eng in engines.items():
                log.side = side
                batch = {"tokens": torch.as_tensor(p[None],
                                                   device=eng.device)}
                if frontend is not None:
                    batch["vision_embeds"] = frontend[slot:slot + 1].to(
                        eng.device)
                lg[side], c1 = eng.prefill_fn(eng.params, batch)
                for big, small in zip(caches[side], c1):
                    for name, leaf in big.items():
                        leaf[slot].copy_(small[name][0])
            errs.append(_logit_err(lg, agreeing(log.flips(), [slot])))
            for side in PARITY_SIDES:
                greedy[side].append([int(torch.argmax(lg[side][0]))])
            nxt.append(greedy["cpu"][-1][0])
        pos = np.array([ft + len(p) for p in prompts])
        for _ in range(3):
            lg = {}
            for side, eng in engines.items():
                log.side = side
                lg[side], _ = eng.decode_fn(
                    eng.params,
                    torch.as_tensor(nxt, device=eng.device)[:, None],
                    caches[side], torch.as_tensor(pos, dtype=torch.int32,
                                                  device=eng.device))
            errs.append(_logit_err(lg, agreeing(log.flips(),
                                                list(range(len(prompts))))))
            for side in PARITY_SIDES:
                greedy[side].append(torch.argmax(lg[side], dim=-1).tolist())
            nxt = greedy["cpu"][-1]
            pos = pos + 1
    launches = ops.launch_counts()
    _check_path_launches(arch, launches)
    if overrides:
        n, forwards = PARITY_LAYERS, len(prompts) + 3
        want = {"rmsnorm": (2 * n + 1) * forwards,
                "flash_attention": n * len(prompts), "decode_attention": 3 * n}
        if {k: v for k, v in launches.items() if v} != want:
            raise AssertionError(f"{label}: parity launches {launches} != "
                                 f"{want}")
    tokens_equal = greedy["card"] == greedy["cpu"]
    line = {"phase": "parity", "arch": arch, "dtype": "float32",
            **({"contract": label, "overrides": overrides}
               if overrides else {}),
            "layers": PARITY_LAYERS, "prompt_lens": list(prompt_lens),
            "frontend_tokens": ft, "decode_steps": 3,
            "tolerance": PARITY_TOL, "max_abs_err_per_step": errs,
            "greedy_tokens_equal": tokens_equal,
            "greedy_tokens_cpu": greedy["cpu"], "kernel_launches": launches}
    if cfg.moe is not None:
        line["routing"] = {
            "token_layers": log.token_layers, "flips": len(flips),
            "flip_topk_gaps": [g for _, g in flips],
            "min_topk_gap": log.min_gap, "flip_gap_limit": FLIP_GAP,
            "sequences_left_out": sorted(flipped),
            "held": ("every row" if not flipped else
                     "rows of sequences whose routing agreed in every "
                     "layer; a null step held none")}
    emit(line)
    if cfg.moe is None and not tokens_equal:
        raise AssertionError(f"{arch}: greedy tokens differ card vs CPU: "
                             f"{greedy['card']} != {greedy['cpu']}")
    bad = [g for _, g in flips if g > FLIP_GAP]
    if bad:
        raise AssertionError(f"{arch}: routing differs card vs CPU at top-k "
                             f"gaps {bad} > {FLIP_GAP}")


def _logit_err(lg, rows=None):
    """Max abs error of the card's logits against the CPU's over ``rows``
    (all by default); raises past PARITY_TOL. None if no row is held."""
    gpu, cpu = lg["card"].float().cpu(), lg["cpu"].float()
    if gpu.shape != cpu.shape or not torch.isfinite(gpu).all():
        raise AssertionError("card logits not finite or misshapen")
    if rows is not None:
        if not rows:
            return None
        gpu, cpu = gpu[rows], cpu[rows]
    err = (gpu - cpu).abs()
    if bool((err > PARITY_TOL + PARITY_TOL * cpu.abs()).any()):
        raise AssertionError(f"card and CPU logits differ: max abs err "
                             f"{err.max().item()} (tol {PARITY_TOL})")
    return err.max().item()


def _check_train_launches(arch: str, launches: dict, steps: int) -> dict:
    """Launches a step of ``arch``'s training path, each exactly as
    counted in TRAIN_LAUNCHES[arch]; no other kernel launched."""
    per_step = {k: n / steps for k, n in launches.items()}
    want = {k: TRAIN_LAUNCHES[arch].get(k, 0) for k in launches}
    if per_step != want:
        raise AssertionError(f"train launches a step {per_step} != {want}")
    return per_step


def _train_run(trainer, loader, steps, **kw):
    hist = trainer.run(loader, steps=steps, log_every=10 ** 9, **kw)
    if not all(np.isfinite(hist["loss"])):
        raise AssertionError(f"non-finite training loss: {hist['loss']}")
    return hist


def _profile_train_step(trainer, params, opt_state, batch) -> dict:
    """Where a training step's time goes: one step timed on the host clock
    (ending in a synchronize), then one under torch.profiler for the
    kernels' device time and the device's idle share; then the AdamW
    update alone (the step's last part) under the profiler, on gradients
    of 1e-3, so its share of the step is measured, not inferred."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = trainer._place(batch)

    def step():
        nonlocal params, opt_state
        params, opt_state, m = trainer.step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        return m

    t0 = time.perf_counter()
    step()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = _device_busy_us(kern) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    flash_bwd_ms = sum(v for k, v in by_name.items()
                       if "flash_bwd" in k) / 1e3
    ssd_bwd_ms = sum(v for k, v in by_name.items() if "ssd_bwd" in k) / 1e3
    rms_bwd_ms = sum(v for k, v in by_name.items()
                     if "rmsnorm_bwd" in k or "rmsnorm_dw" in k) / 1e3

    grads = [torch.full_like(p, 1e-3) for p in tree_leaves(params)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as uprof:
        t0 = time.perf_counter()
        adamw_update(grads, opt_state, params, trainer.tcfg)
        torch.cuda.synchronize()
        update_ms = (time.perf_counter() - t0) * 1e3
    ukern = [e for e in uprof.events() if e.device_type == DeviceType.CUDA]
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / traced_ms,
            "kernels_per_step": len(kern),
            "top_device_ms": [[k[:60], v / 1e3] for k, v in top],
            "flash_bwd_device_ms": flash_bwd_ms,
            "ssd_bwd_device_ms": ssd_bwd_ms,
            "rmsnorm_bwd_device_ms": rms_bwd_ms,
            "adamw_update": {"traced_wall_ms": update_ms,
                             "device_busy_ms": _device_busy_us(ukern) / 1e3,
                             "kernels": len(ukern)}}


def phase_train(smi: str, arch: str) -> dict:
    """``arch`` at full width through the port's Trainer: 8 steps with fp32
    moments (launches checked), the same 8 resumed from a checkpoint at
    step 4 (losses bit for bit), then 3 with int8 moments. Returns the
    8-step run's launches."""
    import shutil
    cfg = train_cfg(arch)
    loader = lambda: PrefetchingLoader(data_config(cfg, TRAIN_SEQ,
                                                   TRAIN_BATCH))
    tcfg = train_config(cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    trainer = Trainer(cfg, tcfg)
    full = _train_run(trainer, loader(), TRAIN_STEPS)
    launches = ops.launch_counts()
    per_step = _check_train_launches(arch, launches, TRAIN_STEPS)
    TRAIN_FIRST_LOSS[arch] = full["loss"][0]
    peak = torch.cuda.max_memory_allocated()
    prof = _profile_train_step(trainer, full.pop("params"),
                               full.pop("opt_state"),
                               loader().get(TRAIN_STEPS))
    del trainer
    torch.cuda.empty_cache()

    # Save at step 4, restore into a fresh Trainer, continue to step 8.
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    t_save = time.monotonic()
    first = _train_run(Trainer(cfg, tcfg, ckpt_dir=TRAIN_CKPT_DIR,
                               ckpt_every=TRAIN_SAVE_AT), loader(),
                       TRAIN_SAVE_AT)
    del first["params"], first["opt_state"]
    save_s = time.monotonic() - t_save - sum(first["step_time_s"])
    torch.cuda.empty_cache()
    if ckpt.latest_step(TRAIN_CKPT_DIR) != TRAIN_SAVE_AT:
        raise AssertionError("no checkpoint at the save step")
    t_res = time.monotonic()
    resumed = _train_run(Trainer(cfg, tcfg, ckpt_dir=TRAIN_CKPT_DIR,
                                 ckpt_every=10 ** 9), loader(), TRAIN_STEPS)
    restore_s = time.monotonic() - t_res - sum(resumed["step_time_s"])
    del resumed["params"], resumed["opt_state"]
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    if resumed["step"] != list(range(TRAIN_SAVE_AT, TRAIN_STEPS)) or \
            first["loss"] + resumed["loss"] != full["loss"]:
        raise AssertionError(f"resume is not bitwise: {first['loss']} + "
                             f"{resumed['loss']} != {full['loss']}")

    int8 = _train_run(Trainer(cfg, train_config(
        cfg, TRAIN_INT8_STEPS, opt_state_dtype="int8")), loader(),
        TRAIN_INT8_STEPS)
    del int8["params"], int8["opt_state"]
    torch.cuda.empty_cache()
    emit({"phase": "train", "arch": arch, "dtype": cfg.dtype,
          "layers": cfg.num_layers, "params": cfg.num_params,
          "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
          "train_config": {k: getattr(tcfg, k) for k in (
              "remat", "opt_state_dtype", "microbatches", "learning_rate",
              "warmup_steps", "total_steps", "loss_chunk")},
          "fp32_moments": {"loss": full["loss"],
                           "grad_norm": full["grad_norm"],
                           "step_ms": [1e3 * t for t in full["step_time_s"]]},
          "resume": {"saved_at": TRAIN_SAVE_AT, "bitwise": True,
                     "losses_after": resumed["loss"],
                     "save_s": save_s, "restore_s": restore_s},
          "int8_moments": {"loss": int8["loss"],
                           "grad_norm": int8["grad_norm"],
                           "step_ms": [1e3 * t for t in int8["step_time_s"]]},
          "max_memory_allocated": peak, "profile": prof,
          "kernel_launches": launches, "launches_per_step": per_step,
          "nvidia_smi": smi})
    return launches


def phase_train_lowp(smi: str) -> dict:
    """internlm2-1.8b at full width under ``mlp_lowp``, through the port's
    Trainer on the ``train`` phase's config, weights (seed 0) and batches:
    LOWP_TRAIN_STEPS steps, each loss finite, launches a step exactly the
    unflagged path's (every norm's forward and backward on its kernels,
    with the flag); the first loss within LOWP_LOSS_TOL of the unflagged
    run's first loss, printed beside it. Returns the run's launches."""
    cfg = train_cfg(ARCH).replace(mlp_lowp=True)
    loader = PrefetchingLoader(data_config(cfg, TRAIN_SEQ, TRAIN_BATCH))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    run = _train_run(Trainer(cfg, train_config(cfg, LOWP_TRAIN_STEPS)),
                     loader, LOWP_TRAIN_STEPS)
    launches = ops.launch_counts()
    per_step = _check_train_launches(ARCH, launches, LOWP_TRAIN_STEPS)
    del run["params"], run["opt_state"]
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    ref = TRAIN_FIRST_LOSS[ARCH]
    rel = abs(run["loss"][0] - ref) / abs(ref)
    emit({"phase": "train", "arch": ARCH, "path": LOWP_TRAIN_PATH,
          "mlp_lowp": True, "dtype": cfg.dtype, "layers": cfg.num_layers,
          "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
          "loss": run["loss"], "grad_norm": run["grad_norm"],
          "step_ms": [1e3 * t for t in run["step_time_s"]],
          "first_loss": run["loss"][0], "first_loss_without_lowp": ref,
          "first_loss_rel_diff": rel, "tolerance": LOWP_LOSS_TOL,
          "max_memory_allocated": peak, "kernel_launches": launches,
          "launches_per_step": per_step, "nvidia_smi": smi})
    if rel > LOWP_LOSS_TOL:
        raise AssertionError(f"mlp_lowp first loss {run['loss'][0]} vs "
                             f"{ref} without it: {rel} > {LOWP_LOSS_TOL}")
    return launches


def phase_train_parity(arch: str, overrides: dict | None = None,
                       label: str | None = None) -> None:
    """One loss and its gradient, fp32 ``arch`` at full width with
    PARITY_LAYERS layers, full remat: on the card (kernels and their
    backward kernels) against the CPU (plain versions). ``overrides`` as
    ``phase_parity``'s."""
    cfg = get_config(arch).replace(dtype="float32", num_layers=PARITY_LAYERS,
                                   **(overrides or {}))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    batch = _gen_batch(data_config(cfg, TRAIN_PARITY_SEQ,
                                   TRAIN_PARITY_BATCH), 0)
    out = {}
    for side, dev in PARITY_SIDES.items():
        p = tree_map(lambda t, d=dev: t.to(d, copy=True).requires_grad_(True),
                     params)
        leaves = tree_leaves(p)
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        ops.reset_launches()
        loss, metrics = lm.loss_fn(p, cfg, b, remat="full")
        grads = torch.autograd.grad(loss, leaves)
        out[side] = (loss.item(), [g.cpu() for g in grads],
                     ops.launch_counts())
    (l_card, g_card, launches), (l_cpu, g_cpu, _) = out["card"], out["cpu"]
    n = PARITY_LAYERS
    want = train_launches(arch, n)
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"train parity launches {launches} != {want}")
    rel = [((a - c).abs().max() / c.abs().max().clamp_min(1e-30)).item()
           for a, c in zip(g_card, g_cpu)]
    finite = all(torch.isfinite(g).all() for g in g_card)
    norm = {side: sum(g.double().square().sum() for g in gs).sqrt().item()
            for side, gs in (("card", g_card), ("cpu", g_cpu))}
    norm_err = abs(norm["card"] - norm["cpu"]) / norm["cpu"]
    emit({"phase": "train_parity", "arch": arch, "dtype": "float32",
          **({"contract": label, "overrides": overrides}
             if overrides else {}), "layers": n, "batch": TRAIN_PARITY_BATCH, "seq": TRAIN_PARITY_SEQ,
          "remat": "full", "tolerance": PARITY_TOL, "loss_card": l_card,
          "loss_cpu": l_cpu, "loss_abs_err": abs(l_card - l_cpu),
          "grad_leaves": len(rel), "max_grad_err_over_maxabs": max(rel),
          "grad_norm_card": norm["card"], "grad_norm_cpu": norm["cpu"],
          "grad_norm_rel_err": norm_err, "kernel_launches": launches})
    if not finite or abs(l_card - l_cpu) > PARITY_TOL * max(1, abs(l_cpu)) \
            or max(rel) > PARITY_TOL or norm_err > PARITY_TOL:
        raise AssertionError(f"train parity: loss {l_card} vs {l_cpu}, "
                             f"grad err {max(rel)} (tol {PARITY_TOL})")


# ---------------------------------------------------------------------------
# The fleet engine: Fleet(backend="torch") and sweep(), which run no
# kernel of their own (their path launches none of the counted wrappers).
# ---------------------------------------------------------------------------
# fig16's fleet constants (benchmarks/fig16_fleet.py:87-90)
SOC_UNIT_RATE, CPU_UNIT_RATE, FLEET_DT_S, RPS_PER_USER = 30.0, 9.0, 60.0, 0.02
# the JAX engine's tolerance contract, tests/test_jax_parity.py:42-51
FLEET_RTOL = {"served": 1e-12, "energy_j": 1e-12, "power_w": 1e-9,
              "queued": 1e-9, "p50_latency_s": 1e-9, "p95_latency_s": 1e-9,
              "p99_latency_s": 1e-9, "max_temp_c": 1e-9,
              "fan_power_w": 1e-9}
FLEET_ATOL = 1e-9
FLEET_EXACT = ("ticks", "drained", "active_units", "queued", "hedged",
               "scale_events", "throttled_units")
# fig16's batched sweep (benchmarks/fig16_fleet.py:96-97, :211-259): 64
# configs x 100 racks x 24 h at 300 s ticks, rows held to dedicated
# vector runs at its JAX_RTOL; 8 of them, every 9th, so all three routers
SWEEP_CONFIGS, SWEEP_RACKS, SWEEP_DT_S, SWEEP_RTOL = 64, 100, 300.0, 1e-9
SWEEP_CHECKED = tuple(range(0, SWEEP_CONFIGS, 9))


def _fleet_policy(**kw):
    return ScalePolicy(cooldown_s=300.0, min_units=1, **kw)


def _mixed_racks(n_soc: int, n_cpu: int, policy=None):
    """fig16's mixed fleet: SD865 SoC racks and Xeon racks."""
    policy = policy or _fleet_policy()
    return (homogeneous_fleet(soc_cluster(), n_soc, SOC_UNIT_RATE,
                              policy=policy)
            + homogeneous_fleet(edge_server_cpu(), n_cpu, CPU_UNIT_RATE,
                                policy=_fleet_policy()))


def _dvfs_racks(n: int, dvfs: bool = True):
    """fig16's SoC fleet, with schedutil over the SD865 table and the RC
    thermal network on every rack (``dvfs``), or binary gating alone."""
    policy = _fleet_policy(freq_governor=SchedutilGovernor() if dvfs
                           else None)
    return homogeneous_fleet(
        soc_cluster(), n, SOC_UNIT_RATE, policy=policy,
        opp_table=sd865_opp_table() if dvfs else None,
        thermal=ThermalParams() if dvfs else None)


def _capacity(racks) -> float:
    return float(sum(rc.spec.n_units * rc.unit_rate for rc in racks))


def _fleet_scenarios():
    """fig16's parity set (benchmarks/fig16_fleet.py:180-193, traces as
    its run() builds them): the mixed 8 + 2 fleet under each router on
    the short diurnal trace and under round-robin on the flash crowd,
    the 6-rack schedutil + thermal fleet, and an under-provisioned
    hedging fleet at 95 % of capacity."""
    users = 0.5 * _capacity(_mixed_racks(100, 20)) / RPS_PER_USER
    short = scale_to_users(
        diurnal_trace(peak_rps=1.0, hours=2, dt_s=FLEET_DT_S, seed=7),
        users=users / 10, rps_per_user=RPS_PER_USER)
    crowd = flash_crowd_trace(
        base_rps=0.08 * _capacity(_mixed_racks(10, 10)), spike_mult=8.0,
        hours=2.0, dt_s=FLEET_DT_S, seed=16)
    dvfs_short = 0.5 * _capacity(_dvfs_racks(100, dvfs=False)) \
        * diurnal_trace(peak_rps=1.0, hours=24, dt_s=FLEET_DT_S,
                        seed=16)[:120] / 10.0
    hedge = _fleet_policy(headroom=0.8, hedge_after_s=120.0)
    hedge_racks = lambda: homogeneous_fleet(  # noqa: E731
        soc_cluster(), 8, SOC_UNIT_RATE, policy=hedge)
    hedge_trace = 0.95 * _capacity(hedge_racks()) * diurnal_trace(
        peak_rps=1.0, hours=2, dt_s=FLEET_DT_S, seed=3)
    out = [(f"mixed_{name}", lambda: _mixed_racks(8, 2), cls, short)
           for name, cls in ROUTERS.items()]
    out.append(("flash_round-robin", lambda: _mixed_racks(8, 2),
                RoundRobinRouter, crowd))
    out.append(("dvfs_join-shortest-queue", lambda: _dvfs_racks(6),
                JoinShortestQueueRouter, dvfs_short))
    out.append(("hedging_power-aware", hedge_racks, PowerAwareRouter,
                hedge_trace))
    return out


def _fleet_series(tel) -> dict:
    out = {k: np.asarray(getattr(tel, k), float) for k in (
        "ticks", "drained", "active_units", "queued", "power_w", "served",
        "energy_j", "p50_latency_s", "p95_latency_s", "p99_latency_s")}
    out["hedged"] = np.array([r.hedged for r in tel.per_rack], float)
    out["scale_events"] = np.array([r.scale_events for r in tel.per_rack],
                                   float)
    for k in ("max_temp_c", "throttled_units", "fan_power_w"):
        out[k] = np.concatenate([np.asarray(getattr(r, k), float)
                                 for r in tel.per_rack])
    return out


def _maxrel(a, b) -> float:
    """fig16's relative error: max |a - b| / max(|a|, 1e-9)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-9)))


def _no_launches(what: str) -> dict:
    launches = ops.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"{what} launched hand-written kernels: "
                             f"{launches}")
    return launches


def phase_fleet_parity(smi: str) -> None:
    """Each fig16 scenario through ``Fleet(backend="torch")`` on the card
    and ``Fleet(backend="vector")`` on the host, series by series: integer
    series equal, the rest within the JAX engine's RTOL/ATOL."""
    t_phase = time.monotonic()
    ops.reset_launches()
    worst = {k: 0.0 for k in FLEET_RTOL}
    rows, bad = [], []
    for label, make, router, trace in _fleet_scenarios():
        tv = Fleet(make(), router=router(), dt_s=FLEET_DT_S,
                   backend="vector").play_trace(trace)
        tt = Fleet(make(), router=router(), dt_s=FLEET_DT_S,
                   backend="torch").play_trace(trace)
        sv, st = _fleet_series(tv), _fleet_series(tt)
        errs = {}
        for k in FLEET_EXACT:
            if not np.array_equal(sv[k], st[k]):
                bad.append(f"{label}/{k} differs")
        for k, rtol in FLEET_RTOL.items():
            if k in FLEET_EXACT:
                continue
            errs[k] = _maxrel(sv[k], st[k])
            worst[k] = max(worst[k], errs[k])
            if not (sv[k].shape == st[k].shape and np.allclose(
                    st[k], sv[k], rtol=rtol, atol=FLEET_ATOL)):
                bad.append(f"{label}/{k} max rel err {errs[k]:.3e}")
        rows.append({"scenario": label, "racks": len(tt.rack_names),
                     "ticks": tt.ticks, "drained": tt.drained,
                     "hedged": int(sv["hedged"].sum()),
                     "throttled_unit_ticks": int(
                         sv["throttled_units"].sum()),
                     "torch_wall_s": tt.wall_s, "vector_wall_s": tv.wall_s,
                     "max_rel_err": errs})
    launches = _no_launches("fleet_parity")
    emit({"phase": "fleet_parity", "backend": "torch", "device": "cuda",
          "oracle": "Fleet(backend='vector') on the host",
          "rtol": FLEET_RTOL, "atol": FLEET_ATOL,
          "exact": list(FLEET_EXACT), "max_rel_err": worst,
          "scenarios": rows, "kernel_launches": launches,
          "seconds": time.monotonic() - t_phase, "nvidia_smi": smi})
    if bad:
        raise AssertionError(f"fleet parity: {bad}")


def _sweep_inputs():
    racks = homogeneous_fleet(soc_cluster(), SWEEP_RACKS, SOC_UNIT_RATE,
                              policy=_fleet_policy())
    trace = 0.5 * _capacity(racks) * diurnal_trace(
        peak_rps=1.0, hours=24, dt_s=SWEEP_DT_S, seed=16)
    grid = itertools.product(tuple(ROUTERS), (0.85, 1.0, 1.15, 1.3),
                             (0.7, 0.85, 1.0, 1.15, 1.3, 1.45))
    cfgs = [SweepConfig(router=rt, headroom_scale=hr, trace_scale=ts,
                        name=f"c{i}")
            for i, (rt, hr, ts) in enumerate(
                itertools.islice(grid, SWEEP_CONFIGS))]
    return racks, trace, cfgs


def _traced(fn) -> dict:
    """Host wall and device busy (union of CUDA kernel intervals) of one
    call under torch.profiler, tracing the device alone (a sweep runs
    some 200k kernels; host op events would cost more to collect than
    the sweep)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _device_busy_us(kern) / 1e6 if kern else None
    return {"traced_wall_s": wall, "kernels": len(kern),
            "device_busy_s": busy,
            "device_busy_share": busy / wall if kern else None}


def phase_fleet_sweep(smi: str) -> None:
    """fig16's batched sweep on the card: 64 configs x 100 racks x 24 h
    as one batched step, replayed as a CUDA graph and run eagerly; 8 rows
    held to dedicated vector runs, a repeat held bit for bit, the times
    of both beside the vector loop's (measured over those 8 configs and
    extrapolated to 64, as fig16 does), peak memory, and a traced sweep's
    device-busy share."""
    t_phase = time.monotonic()
    racks, trace, cfgs = _sweep_inputs()
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run(graph=True):
        return sweep(racks, cfgs, trace, dt_s=SWEEP_DT_S, graph=graph)

    def timed(graph=True):
        t0 = time.perf_counter()
        rows = run(graph)
        return rows, time.perf_counter() - t0

    _, first_s = timed()                       # first run (cold)
    rows, graph_s = timed()
    again, _ = timed()
    mem = torch.cuda.max_memory_allocated()
    run(graph=False)                           # eager warm-up
    eager_rows, eager_s = timed(graph=False)
    launches = _no_launches("fleet_sweep")
    if rows != again or eager_rows != rows:
        raise AssertionError("a repeated sweep, or the eager one, differs "
                             "from the first graph-replayed sweep")
    t0 = time.perf_counter()
    traced = _traced(run)
    trace_s = time.perf_counter() - t0
    ticks_run = -(-(2 * len(trace) + 100) // tte._BLOCK) * tte._BLOCK
    t0 = time.perf_counter()
    checked, worst = [], 0.0
    for ci in SWEEP_CHECKED:
        cfg, row = cfgs[ci], rows[ci]
        fleet = Fleet(
            homogeneous_fleet(soc_cluster(), SWEEP_RACKS, SOC_UNIT_RATE,
                              policy=_fleet_policy(
                                  headroom=ScalePolicy().headroom
                                  * cfg.headroom_scale)),
            router=ROUTERS[cfg.router](), dt_s=SWEEP_DT_S, backend="vector")
        summ = fleet.play_trace(cfg.trace_scale * trace).summary()
        errs = {k: _maxrel(summ[k], row[k])
                for k in ("served", "energy_kwh", "p95_latency_s")}
        worst = max(worst, *errs.values())
        checked.append({"config": cfg.name, "router": cfg.router,
                        "drained": bool(summ["drained"]) and row["drained"],
                        "max_rel_err": errs})
    t_vec = (time.perf_counter() - t0) / len(SWEEP_CHECKED) * SWEEP_CONFIGS
    emit({"phase": "fleet_sweep", "configs": SWEEP_CONFIGS,
          "racks": SWEEP_RACKS, "socs": SWEEP_RACKS * soc_cluster().n_units,
          "trace_ticks": len(trace), "dt_s": SWEEP_DT_S,
          "ticks_stepped": ticks_run,
          "first_sweep_s": first_s, "graph_sweep_s": graph_s,
          "eager_sweep_s": eager_s,
          "graph_scenarios_per_s": SWEEP_CONFIGS / graph_s,
          "eager_scenarios_per_s": SWEEP_CONFIGS / eager_s,
          "vector_loop_scenarios_per_s": SWEEP_CONFIGS / t_vec,
          "vector_loop_est_s": t_vec,
          "speedup_graph_over_vector_loop": t_vec / graph_s,
          "repeat_bitwise_equal": True,
          "eager_bitwise_equal_graph": True,
          "max_memory_allocated": mem,
          "kernels_per_tick": traced["kernels"] / ticks_run,
          "traced_graph_sweep": traced, "trace_collect_s": trace_s,
          "checked_against_vector": checked, "rtol": SWEEP_RTOL,
          "max_rel_err": worst, "kernel_launches": launches,
          "seconds": time.monotonic() - t_phase, "nvidia_smi": smi})
    if worst > SWEEP_RTOL or not all(c["drained"] for c in checked):
        raise AssertionError(f"fleet sweep rows off the vector runs: "
                             f"{checked}")


# fig16's fault and degradation studies (benchmarks/fig16_fleet.py:269-488)
FLEET_JAX_RTOL = 1e-9              # fig16_fleet.py:96, its JAX_RTOL
# the fields of each overlay run that must agree, by tolerance: integer
# series and counts exactly; served/energy and power/queued/latency at
# FLEET_RTOL; the degrade costs and the rest at FLEET_JAX_RTOL
OVERLAY_EXACT = ("ticks", "drained", "active_units", "respilled_requests",
                 "dropped_requests", "breaker_opens", "breaker_state_t",
                 "reconvergence_ticks", "responses")
OVERLAY_RTOL = {k: FLEET_RTOL[k] for k in (
    "served", "energy_j", "power_w", "queued", "p50_latency_s",
    "p95_latency_s", "p99_latency_s")}
OVERLAY_JAX = ("shed_cost", "shed_by_tier", "shed_cost_t", "expired_cost",
               "retried_cost", "retry_dropped_cost", "offered_rps",
               "tier_percentiles", "respilled_cost", "dropped_cost",
               "p99_blowup")
TIER_QS = (50.0, 95.0, 99.0)


def _chaos_racks(hedge=None):
    """fig16's chaos and degrade fleet: 16 SoC racks and 4 Xeon racks."""
    pol = _fleet_policy(hedge_after_s=hedge)
    return (homogeneous_fleet(soc_cluster(), 16, SOC_UNIT_RATE, policy=pol)
            + homogeneous_fleet(edge_server_cpu(), 4, CPU_UNIT_RATE,
                                policy=pol))


def _kill_at(tick: int, end: int) -> ChaosSchedule:
    """fig16's kill: racks 0 and 1 over ticks [tick, end), respilled."""
    sched = ChaosSchedule(on_kill="respill")
    for rack in (0, 1):
        sched.kill_rack(rack, start_s=tick * FLEET_DT_S,
                        end_s=end * FLEET_DT_S)
    return sched


def _crowd():
    """fig16's flash crowd on the chaos fleet and the tick of its peak."""
    crowd = flash_crowd_trace(base_rps=0.3 * _capacity(_chaos_racks()),
                              spike_mult=4.0, hours=2.0, dt_s=FLEET_DT_S,
                              seed=16)
    return crowd, int(np.argmax(crowd))


def _full_schedule() -> ChaosSchedule:
    """Every fault kind (tests/test_chaos.py::_full_schedule)."""
    sched = ChaosSchedule(on_kill="respill")
    sched.kill_rack(1, start_s=4 * 3600.0, end_s=8 * 3600.0)
    sched.kill_units(2, 20, start_s=5 * 3600.0, end_s=9 * 3600.0)
    sched.fail_fan(0, start_s=3 * 3600.0, end_s=10 * 3600.0)
    sched.power_cap(3, start_s=6 * 3600.0, end_s=11 * 3600.0)
    return sched


def _thermal_racks(**thermal):
    """tests/test_chaos.py's parity fleet: 4 schedutil + SD865 + RC
    thermal racks, hedging at 240 s."""
    pol = _fleet_policy(headroom=1.25, hedge_after_s=240.0,
                        freq_governor=SchedutilGovernor())
    return homogeneous_fleet(soc_cluster(), 4, SOC_UNIT_RATE, policy=pol,
                             opp_table=sd865_opp_table(),
                             thermal=ThermalParams(**thermal))


def _day():
    """fig16's full fleet (100 SoC + 20 Xeon racks, 7200 units) and its
    24 h diurnal at 60 s ticks scaled as its run() scales it."""
    users = 0.5 * _capacity(_mixed_racks(100, 20)) / RPS_PER_USER
    return scale_to_users(
        diurnal_trace(peak_rps=1.0, hours=24, dt_s=FLEET_DT_S, seed=16),
        users=users, rps_per_user=RPS_PER_USER)


def _day_chaos() -> ChaosSchedule:
    """A random schedule on 10 % of fig16's 120 racks over its day."""
    return ChaosSchedule.random(120, 86400.0, seed=16, n_events=12)


def _degrade_policy() -> DegradePolicy:
    """fig16 §7's policy (benchmarks/fig16_fleet.py:384-395)."""
    return DegradePolicy(
        tiers=(TierSpec("gold", 0.2, 600.0), TierSpec("silver", 0.3, 300.0),
               TierSpec("bulk", 0.5, 120.0)),
        queue_deadline_s=600.0,
        breaker=BreakerConfig(open_after_s=300.0, close_below_s=120.0,
                              cooldown_s=600.0, probe_fraction=0.25,
                              fail_timeout_s=120.0),
        retry=RetryPolicy(max_attempts=3, backoff_s=120.0, jitter=0.5),
        seed=16)


class _GraphWatch:
    """Counts the torch engine's blocks, its captures, and the blocks that
    ran eagerly rather than as replays of a captured CUDA graph."""

    def __init__(self):
        self.blocks = self.eager = self.captures = 0

    def __enter__(self):
        self._run, self._cap = tte._Runner.run_block, tte._Runner._capture
        watch, run, cap = self, self._run, self._cap

        def run_block(runner, rows):
            out = run(runner, rows)
            watch.blocks += 1
            watch.eager += runner._graph is None
            return out

        def capture(runner):
            watch.captures += 1
            return cap(runner)

        tte._Runner.run_block, tte._Runner._capture = run_block, capture
        return self

    def __exit__(self, *exc):
        tte._Runner.run_block, tte._Runner._capture = self._run, self._cap


def _overlay_series(tel) -> dict:
    out = {k: np.asarray(getattr(tel, k), float) for k in (
        "ticks", "drained", "active_units", "respilled_requests",
        "dropped_requests", "breaker_opens", "breaker_state_t", "served",
        "energy_j", "power_w", "queued", "p50_latency_s", "p95_latency_s",
        "p99_latency_s", "shed_cost", "shed_cost_t", "expired_cost",
        "retried_cost", "retry_dropped_cost", "offered_rps",
        "respilled_cost", "dropped_cost")}
    rec = tel.recovery
    out["reconvergence_ticks"] = np.asarray(
        -1.0 if rec is None or rec.reconvergence_ticks is None
        else rec.reconvergence_ticks)
    out["p99_blowup"] = np.asarray(0.0 if rec is None else rec.p99_blowup)
    out["responses"] = np.array([len(r.responses) for r in tel.per_rack],
                                float)
    tiers = sorted(tel.shed_by_tier)
    out["shed_by_tier"] = np.array([tel.shed_by_tier[t] for t in tiers])
    out["tier_percentiles"] = np.array(
        [list(tier_latency_percentiles(tel, t, TIER_QS).values())
         for t in tiers])
    return out


def _overlay_compare(label, tv, tt, bad) -> dict:
    """Every OVERLAY_* field of the torch run against the vector run: the
    relative errors, with each miss appended to ``bad``."""
    sv, st = _overlay_series(tv), _overlay_series(tt)
    errs = {}
    for k in OVERLAY_EXACT:
        if not (sv[k].shape == st[k].shape and np.array_equal(sv[k], st[k])):
            bad.append(f"{label}/{k} differs")
    tols = {**OVERLAY_RTOL, **{k: FLEET_JAX_RTOL for k in OVERLAY_JAX}}
    for k, rtol in tols.items():
        errs[k] = _maxrel(sv[k], st[k])
        if not (sv[k].shape == st[k].shape and np.allclose(
                st[k], sv[k], rtol=rtol, atol=FLEET_ATOL)):
            bad.append(f"{label}/{k} max rel err {errs[k]:.3e}")
    return errs


def _overlay_runs(label, make, trace, bad, rows, router, dt_s=FLEET_DT_S,
                  chaos=None, degrade=None, sanitize=False):
    """One scenario through the vector engine on the host and the torch
    engine on the card, compared; ``chaos`` and ``degrade`` make a fresh
    schedule and policy for each. Appends the scenario's row and returns
    the torch telemetry."""
    tels = {b: Fleet(make(), router=router(), dt_s=dt_s, backend=b,
                     chaos=chaos() if chaos else None,
                     degrade=degrade() if degrade else None,
                     sanitize=sanitize).play_trace(trace)
            for b in ("vector", "torch")}
    tv, tt = tels["vector"], tels["torch"]
    errs = _overlay_compare(label, tv, tt, bad)
    rec = tt.recovery
    rows.append({"scenario": label, "racks": len(tt.rack_names),
                 "ticks": tt.ticks, "drained": tt.drained,
                 "respilled_requests": tt.respilled_requests,
                 "breaker_opens": tt.breaker_opens,
                 "reconvergence_ticks": None if rec is None
                 else rec.reconvergence_ticks,
                 "torch_wall_s": tt.wall_s, "vector_wall_s": tv.wall_s,
                 "max_rel_err": errs})
    return tt


def _kernels_per_tick(make_fleet, trace) -> float:
    """Device events of one traced block of 128 ticks (no drain) over the
    ticks stepped, as fleet_sweep counts them."""
    fleet = make_fleet()
    with _GraphWatch() as watch:
        traced = _traced(lambda: fleet.play_trace(trace[:tte._BLOCK],
                                                  drain=False))
    return traced["kernels"] / (watch.blocks * tte._BLOCK)


def _fleet_phase_line(phase, t_phase, rows, checks, bad, watch, smi,
                      **extra) -> None:
    if watch.eager or not watch.blocks:
        bad.append(f"{watch.eager} of {watch.blocks} blocks ran eagerly")
    launches = _no_launches(phase)
    emit({"phase": phase, "backend": "torch", "device": "cuda",
          "oracle": "Fleet(backend='vector') on the host",
          "exact": list(OVERLAY_EXACT), "rtol": OVERLAY_RTOL,
          "jax_rtol": FLEET_JAX_RTOL, "jax_rtol_fields": list(OVERLAY_JAX),
          "atol": FLEET_ATOL, "scenarios": rows, "fig16_asserts": checks,
          "graph_blocks": watch.blocks, "eager_blocks": watch.eager,
          "captures": watch.captures,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          **extra, "kernel_launches": launches,
          "seconds": time.monotonic() - t_phase, "nvidia_smi": smi})
    failed = [name for name, ok in checks.items() if not ok]
    if bad or failed:
        raise AssertionError(f"{phase}: {bad} fig16 asserts failed: "
                             f"{failed}")


def phase_fleet_chaos(smi: str) -> None:
    """fig16's fault study and a fig16-scale day under chaos, on the card
    against the vector engine, with fig16's asserts on the torch runs."""
    t_phase = time.monotonic()
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bad, rows, rec = [], [], {}
    with _GraphWatch() as watch:
        # (a) JSQ vs round-robin through a 2-rack kill on the plateau
        plateau = np.full(360, 1700.0)
        for cls in (JoinShortestQueueRouter, RoundRobinRouter):
            tel = _overlay_runs(f"6a_{cls.name}", _chaos_racks,
                                plateau, bad, rows, router=cls,
                                chaos=lambda: _kill_at(120, 180),
                                sanitize=True)
            rec[cls.name] = tel.recovery
            rec[cls.name + "_drained"] = tel.drained
        # (b) the kill at the flash crowd's peak, with hedging
        crowd, peak = _crowd()
        hedged = lambda: _chaos_racks(hedge=180.0)  # noqa: E731
        crowd_tel = _overlay_runs(
            "6b_crowd_peak_kill", hedged, crowd, bad, rows,
            router=JoinShortestQueueRouter,
            chaos=lambda: _kill_at(peak, peak + 30), sanitize=True)
        deltas, walls = {}, {}
        for backend in ("vector", "torch"):
            t0 = time.perf_counter()
            deltas[backend] = hedging_delta(
                hedged(), crowd, _kill_at(peak, peak + 30), dt_s=FLEET_DT_S,
                router=JoinShortestQueueRouter(), backend=backend)
            walls[backend] = time.perf_counter() - t0
        hedge_err = {k: _maxrel(deltas["vector"][k], v)
                     for k, v in deltas["torch"].items()}
        if max(hedge_err.values()) > FLEET_JAX_RTOL:
            bad.append(f"hedging_delta off the vector one: {hedge_err}")
        # every fault kind, with thermal, over 24 h at 120 s ticks
        full_trace = 0.7 * _capacity(_thermal_racks()) * diurnal_trace(
            peak_rps=1.0, hours=24, dt_s=120.0)
        _overlay_runs("full_schedule_thermal", _thermal_racks, full_trace,
                      bad, rows, router=JoinShortestQueueRouter, dt_s=120.0,
                      chaos=_full_schedule, sanitize=True)
        # at ThermalParams()'s setpoints those fans never spin: a fan
        # curve at 27-35 C runs them at full power, so a failure shows
        fan = _overlay_runs(
            "fan_failure_spinning", lambda: _thermal_racks(fan_t_low_c=27.0,
                                                           fan_t_high_c=35.0),
            np.full(80, 0.7 * _capacity(_thermal_racks())), bad, rows,
            router=JoinShortestQueueRouter,
            chaos=lambda: ChaosSchedule().fail_fan(0, 20 * FLEET_DT_S,
                                                   60 * FLEET_DT_S),
            sanitize=True)
        # fig16's full fleet for a day, 12 of its racks faulted
        day = _day()
        _overlay_runs("fig16_day_chaos", lambda: _mixed_racks(100, 20), day,
                      bad, rows, router=JoinShortestQueueRouter,
                      chaos=_day_chaos)
    jsq, rr = rec["join-shortest-queue"], rec["round-robin"]
    checks = {
        "6a_drained_with_recovery": bool(
            rec["join-shortest-queue_drained"] and rec["round-robin_drained"]
            and jsq is not None and rr is not None),
        "6a_kill_degrades_round_robin": bool(
            rr is not None and rr.reconvergence_ticks is not None
            and rr.reconvergence_ticks > 0 and rr.p99_blowup > 1.0),
        "6a_jsq_reconverges_faster": bool(
            jsq is not None and rr is not None
            and jsq.reconvergence_ticks is not None
            and jsq.reconvergence_ticks < rr.reconvergence_ticks),
        "6b_kill_evacuates_a_queue": crowd_tel.respilled_requests > 0,
        "6b_hedging_benefit_positive":
            deltas["torch"]["hedging_benefit_s"] > 0.0,
        "failed_fan_stops": bool(
            np.all(fan.per_rack[0].fan_power_w[20:60] == 0.0)
            and fan.per_rack[0].fan_power_w[10:20].min() > 0.0),
    }
    kpt = {
        "overlays_off": _kernels_per_tick(
            lambda: Fleet(_mixed_racks(100, 20), backend="torch"), day),
        "chaos": _kernels_per_tick(
            lambda: Fleet(_mixed_racks(100, 20), backend="torch",
                          chaos=_day_chaos()), day)}
    _fleet_phase_line(
        "fleet_chaos", t_phase, rows, checks, bad, watch, smi,
        hedging_delta={"torch": deltas["torch"], "vector": deltas["vector"],
                       "max_rel_err": hedge_err, "torch_wall_s":
                       walls["torch"], "vector_wall_s": walls["vector"]},
        kernels_per_tick=kpt)


def phase_fleet_degrade(smi: str) -> None:
    """fig16's degradation study (three arms) and a fig16-scale day with
    its policy, on the card against the vector engine, with fig16's
    asserts on the torch runs."""
    t_phase = time.monotonic()
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bad, rows = [], []
    crowd, peak = _crowd()
    with _GraphWatch() as watch:
        arms = {}
        for arm, degrade, chaos in (
                ("pre_fault", _degrade_policy, None),
                ("degraded", _degrade_policy, lambda: _kill_at(peak,
                                                               peak + 30)),
                ("accept_everything", None, lambda: _kill_at(peak,
                                                             peak + 30))):
            arms[arm] = _overlay_runs(
                f"7_{arm}", _chaos_racks, crowd, bad, rows,
                router=JoinShortestQueueRouter, degrade=degrade,
                chaos=chaos, sanitize=True)
        _overlay_runs("fig16_day_chaos_degrade", lambda: _mixed_racks(100, 20),
                      _day(), bad, rows, router=JoinShortestQueueRouter,
                      chaos=_day_chaos, degrade=_degrade_policy)
    base, deg, raw = (arms[a] for a in ("pre_fault", "degraded",
                                        "accept_everything"))
    gold_base = tier_latency_percentiles(base, "gold")[99.0]
    gold_deg = tier_latency_percentiles(deg, "gold")[99.0]
    injected = float(np.sum(crowd)) * FLEET_DT_S
    loss = deg.expired_cost + deg.retry_dropped_cost + deg.dropped_cost
    dr, rr = deg.recovery, raw.recovery
    checks = {
        "all_arms_drained": base.drained and deg.drained and raw.drained,
        "gold_completed": gold_base > 0.0 and gold_deg > 0.0,
        "gold_p99_within_1.5x_pre_fault": gold_deg <= 1.5 * gold_base,
        "gold_p99_below_accept_everything": gold_deg < raw.p99_latency_s,
        "gold_sheds_nothing_bulk_sheds":
            deg.shed_by_tier["gold"] == 0.0 and deg.shed_by_tier["bulk"] > 0,
        "kill_degrades_both_arms": bool(
            dr is not None and rr is not None and rr.p99_blowup > 1.0
            and dr.p99_blowup > 1.0),
        "degraded_reconverges_faster": bool(
            dr is not None and rr is not None
            and dr.reconvergence_ticks is not None
            and rr.reconvergence_ticks is not None
            and dr.reconvergence_ticks < rr.reconvergence_ticks),
        "mechanisms_fired": deg.shed_cost > 0.0 and deg.breaker_opens > 0
        and deg.retried_cost > 0.0,
        "terminal_loss_at_most_10pct": loss / injected <= 0.10,
        "conservation_closes_1e-6": all(
            abs(t.served + t.dropped_cost + t.expired_cost
                + t.retry_dropped_cost - injected) <= 1e-6 * injected
            for t in (base, deg)),
    }
    kpt = {"chaos_degrade": _kernels_per_tick(
        lambda: Fleet(_mixed_racks(100, 20), backend="torch",
                      chaos=_day_chaos(), degrade=_degrade_policy()),
        _day())}
    _fleet_phase_line(
        "fleet_degrade", t_phase, rows, checks, bad, watch, smi,
        gold_p99_s={"pre_fault": gold_base, "degraded": gold_deg},
        accept_everything_p99_s=raw.p99_latency_s,
        reconvergence_ticks={"degraded": dr.reconvergence_ticks,
                             "accept_everything": rr.reconvergence_ticks},
        shed_frac=deg.shed_cost / injected, loss_frac=loss / injected,
        kernels_per_tick=kpt)


# ---------------------------------------------------------------------------
# The vision models (fig11's DL inference) and the example twins.
# ---------------------------------------------------------------------------
# (model, image, batch): batch 1 is the paper's SoC serving points, batch
# 64 its A40/A100 ones (workloads/dlserving.py:48-51); yolov5x at its 640
# and at fig11's 320.
DL_CASES = (("resnet-50", 224, 1), ("resnet-50", 224, 64),
            ("resnet-152", 224, 1), ("resnet-152", 224, 64),
            ("yolov5x", 640, 1), ("yolov5x", 320, 1))
DL_PARITY_IMAGE = {"resnet-50": 224, "resnet-152": 224, "yolov5x": 640}
# Card (cuDNN, TF32 off) vs CPU, as a share of the CPU output's max-abs:
# every convolution summed in another order (or by Winograd or FFT, where
# cuDNN's autotuner takes them) through 50 to 150 layers, as PARITY_TOL.
DL_PARITY_TOL = 1e-3
TF32_PEAK_OPS = 495e12      # H100 SXM data sheet, dense TF32


def _set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _dl_model(model: str):
    """(weights made on the CPU from seed 0, the forward)."""
    gen = torch.Generator().manual_seed(0)
    if model == "yolov5x":
        return yolo_init(gen, device="cpu"), yolo_apply
    return (resnet_init(gen, model, device="cpu"),
            lambda p, x: resnet_apply(p, x, model))


def _dl_parity(model: str, cpu_params, params, apply) -> dict:
    """One image at full input size on the card, fp32 and then TF32,
    against the CPU; fp32 must hold ``DL_PARITY_TOL`` (and a ResNet's top
    class), TF32's error is reported."""
    n = DL_PARITY_IMAGE[model]
    x = torch.randn((1, n, n, 3), generator=torch.Generator().manual_seed(1))
    want = apply(cpu_params, x)
    scale = want.abs().max().item()
    out = {"phase": "dl_parity", "model": model, "image": n, "batch": 1,
           "cpu_max_abs": scale, "tol": DL_PARITY_TOL}
    for key, tf32 in (("fp32", False), ("tf32", True)):
        _set_tf32(tf32)
        got = apply(params, x.cuda()).cpu()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{model}: bad card output {got.shape}")
        err = (got - want).abs().max().item()
        out[f"{key}_max_abs_err"] = err
        out[f"{key}_rel_err"] = err / scale
        if model != "yolov5x":
            out[f"{key}_argmax_equal"] = bool(
                torch.equal(got.argmax(-1), want.argmax(-1)))
    _set_tf32(False)
    if out["fp32_rel_err"] > DL_PARITY_TOL or not out.get(
            "fp32_argmax_equal", True):
        raise AssertionError(f"{model}: card vs CPU {out}")
    return out


def _dl_case(model: str, params, apply, image: int, batch: int) -> dict:
    from torch.utils.flop_counter import FlopCounterMode
    x = randn((batch, image, image, 3), torch.float32, seed=2)
    fwd = lambda: apply(params, x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    y = fwd()                       # cuDNN autotunes this shape
    want = (batch, 1000) if model != "yolov5x" else \
        (batch, -(-image // 32), -(-image // 32), 255)
    if tuple(y.shape) != want or not torch.isfinite(y).all():
        raise AssertionError(f"{model} {image} x {batch}: output {y.shape}")
    ms = eager_ms(fwd, iters=20)
    mem = torch.cuda.max_memory_allocated()
    with FlopCounterMode(display=False) as fc:
        fwd()
    flops = fc.get_total_flops()
    out = {"phase": "dl", "model": model, "image": image, "batch": batch,
           "dtype": "float32", "tf32": False,
           "ms": ms, "images_per_s": batch / ms * 1e3,
           "device_ms": time_ms(fwd, iters=5, reps=3),
           "max_memory_allocated": mem,
           "flops": flops, "flops_from": "FlopCounterMode",
           "tflops_per_s": flops / ms / 1e9,
           "fp32_peak_share": flops / ms * 1e3 / PEAK_OPS[torch.float32]}
    if model != "yolov5x":
        out["resnet_flops_reference"] = resnet_flops(model) * batch
    traced = _traced(fwd)
    out.update({"kernels_per_forward": traced["kernels"],
                "traced_wall_ms": traced["traced_wall_s"] * 1e3,
                "device_busy_ms": traced["device_busy_s"] * 1e3,
                "device_busy_share": traced["device_busy_share"]})
    # The same forward on NCHW-contiguous weights and input (the layout
    # question of PERF.md §7); its output must agree with channels_last's.
    p_nchw = tree_map(lambda t: t.contiguous(), params)
    x_nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    f_nchw = lambda: apply(p_nchw, x_nchw)
    err = (f_nchw() - y).abs().max().item() / y.abs().max().item()
    if err > DL_PARITY_TOL:
        raise AssertionError(f"{model}: NCHW vs channels_last {err}")
    out.update({"nchw_ms": eager_ms(f_nchw, iters=20),
                "nchw_device_ms": time_ms(f_nchw, iters=5, reps=3)})
    _set_tf32(True)                 # cuDNN autotunes again in each layout
    tf32_ms = eager_ms(fwd, iters=20)
    out.update({"tf32_ms": tf32_ms,
                "tf32_images_per_s": batch / tf32_ms * 1e3,
                "tf32_device_ms": time_ms(fwd, iters=5, reps=3),
                "tf32_peak_share": flops / tf32_ms * 1e3 / TF32_PEAK_OPS,
                "nchw_tf32_device_ms": time_ms(f_nchw, iters=5, reps=3)})
    _set_tf32(False)
    return out


def phase_dl(smi: str) -> None:
    """ResNet-50, ResNet-152 and YOLOv5x (``repro_torch.models``) in fp32
    at full input size: for each of ``DL_CASES`` ms a batch (CUDA events
    around back-to-back forwards, after warm-up) and images/s, device ms
    (graph-replayed), peak memory, kernels a forward and the device-busy
    share of a traced forward, FLOPs (``FlopCounterMode``) and the share
    of the fp32 peak; the same on NCHW-contiguous storage under
    ``nchw_*`` keys, and with TF32 allowed under ``tf32_*`` keys (in
    either layout).
    One image at full input size per model is held card vs CPU
    (``dl_parity``). cuDNN autotunes each shape (``cudnn.benchmark``)
    inside the phase; the flags are put back after it. No hand-written
    kernel lies on this path."""
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.benchmark = True
    ops.reset_launches()
    try:
        with torch.no_grad():
            for model in DL_PARITY_IMAGE:
                _free_card()
                cpu_params, apply = _dl_model(model)
                params = tree_map(lambda t: t.to("cuda"), cpu_params)
                emit({**_dl_parity(model, cpu_params, params, apply),
                      "nvidia_smi": smi})
                del cpu_params
                for m, image, batch in DL_CASES:
                    if m == model:
                        emit({**_dl_case(model, params, apply, image, batch),
                              "nvidia_smi": smi})
                del params
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    _no_launches("dl")
    _free_card()


def _run_example(name: str, argv: list):
    """``examples/torch_<name>.py``'s ``main(argv)`` on the card: its
    result, its printed lines, host seconds and kernel launches."""
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}",
        os.path.join(REPO, "examples", f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    ops.reset_launches()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        result = mod.main(argv)
    torch.cuda.synchronize()
    return (result, buf.getvalue().splitlines(), time.monotonic() - t0,
            ops.launch_counts())


def phase_examples(smi: str) -> None:
    """The example twins on the card: ``torch_quickstart`` at
    internlm2-1.8b's smoke config for 5 steps (trains, then serves 8
    tokens) and ``torch_serve_lm`` with its defaults."""
    steps = 5
    argv = ["--arch", ARCH, "--steps", str(steps)]
    res, lines, wall, launches = _run_example("quickstart", argv)
    vocab = smoke_config(get_config(ARCH)).vocab_size
    if len(res["loss"]) != steps or not np.isfinite(res["loss"]).all() or \
            len(res["tokens"]) != 8 or \
            not all(0 <= t < vocab for t in res["tokens"]):
        raise AssertionError(f"torch_quickstart: {res}")
    missing = [k for k in (*ATTN_KERNELS, "rmsnorm_bwd",
                           "flash_attention_bwd") if not launches[k]]
    if missing:
        raise AssertionError(f"torch_quickstart: {missing} never launched")
    emit({"phase": "examples", "example": "examples/torch_quickstart.py",
          "argv": argv, "lines": lines, "wall_s": wall,
          "kernel_launches": launches, "nvidia_smi": smi})
    tel, lines, wall, launches = _run_example("serve_lm", [])
    if tel.served != 6 or any(len(r.output) != 12 for r in tel.responses):
        raise AssertionError(f"torch_serve_lm: served {tel.served}")
    _check_path_launches(ARCH, launches)
    emit({"phase": "examples", "example": "examples/torch_serve_lm.py",
          "argv": [], "lines": lines, "wall_s": wall, "ticks": tel.ticks,
          "kernel_launches": launches, "nvidia_smi": smi})
    _free_card()


# ---------------------------------------------------------------------------
# The distributed layer: NCCL in a world of one.
# ---------------------------------------------------------------------------
DIST_MM = (16, 64, 32)          # tests/test_multidevice.py's ring shapes
TP_BLOCK = (64, 512, 2048)      # examples/collaborative_inference.py:49
PSUM_N = 1 << 20
PIPE = (4, 8, 512)              # microbatches, rows a microbatch, width
DIST_TOL = 1e-5                 # of the output's max-abs
DIST_BATCH = (8, 256)           # internlm2-1.8b training batch, seq


def _rel_err(out: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error over the reference's max-abs; raises past
    ``DIST_TOL``."""
    err = ((out.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    if not err <= DIST_TOL:
        raise AssertionError(f"distributed: error {err} of the max-abs "
                             f"(tol {DIST_TOL})")
    return err


def _dist_matmuls(mesh) -> dict:
    group = mesh.get_group("model")
    m, k, n = DIST_MM
    x, w = randn((m, k), torch.float32, 31), randn((k, n), torch.float32, 32)
    want = x @ w
    return {
        "ring_ag_matmul": _rel_err(coll.ring_ag_matmul(x, w, group), want),
        "ring_matmul_rs": _rel_err(coll.ring_matmul_rs(x, w, group), want),
        "naive_ag_matmul": _rel_err(coll.naive_ag_matmul(x, w, group), want),
        "naive_matmul_rs": _rel_err(coll.naive_matmul_rs(x, w, group), want),
        "tp_matmul_overlapped": _rel_err(
            coll.tp_matmul_overlapped(x, w, mesh).to_local(), want)}


def _dist_tp_block(mesh) -> dict:
    m, d, f = TP_BLOCK
    x = randn((m, d), torch.float32, 33)
    w1 = randn((d, f), torch.float32, 34) * 0.05
    w2 = randn((f, d), torch.float32, 35) * 0.05
    want = torch.relu(x @ w1) @ w2
    group = mesh.get_group("model")
    # the block's parts on local tensors, outside local_map and DTensor
    out = {"shape": {"m": m, "d": d, "f": f}, "dtype": "float32",
           "plain_ms": eager_ms(lambda: torch.relu(x @ w1) @ w2),
           "ring_ag_matmul_ms": eager_ms(
               lambda: coll.ring_ag_matmul(x, w1, group)),
           "naive_ag_matmul_ms": eager_ms(
               lambda: coll.naive_ag_matmul(x, w1, group))}
    for name, overlap in (("blocking", False), ("ring", True)):
        fn = make_tp_block(mesh, d, f, overlap=overlap)
        args = (coll.as_dtensor(x, mesh, (None, "model")),
                coll.as_dtensor(w1, mesh, (None, "model")),
                coll.as_dtensor(w2, mesh, ("model",)))
        out[name] = {"max_rel_err": _rel_err(fn(*args).to_local(), want),
                     "ms": eager_ms(lambda: fn(*args))}
    return out


def _dist_psum(group) -> dict:
    x = randn((PSUM_N,), torch.float32, 36)
    out = compressed_psum_mean(x, group)
    # A world of one: the mean is x, quantized twice; each rounding is at
    # most half a step (amax / 127) of its block, and the second block's
    # amax is at most the first's.
    amax = x.reshape(-1, 256).abs().amax(dim=1, keepdim=True)
    bound = (amax / 127.0 * (1 + 1e-6)).expand(-1, 256).reshape(-1)
    err = (out - x).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"compressed_psum_mean: error {err.max()} past "
                             "its quantization bound")
    q, sc, pad = quantize_blockwise(x)
    q_cpu, sc_cpu, pad_cpu = quantize_blockwise(x.cpu())
    if not (torch.equal(q.cpu(), q_cpu) and torch.equal(sc.cpu(), sc_cpu)
            and pad == pad_cpu):
        raise AssertionError(
            f"quantize_blockwise: card codes differ from the CPU's: "
            f"{int((q.cpu() != q_cpu).sum())} codes, "
            f"{int((sc.cpu() != sc_cpu).sum())} scales")
    return {"elements": PSUM_N, "max_abs_err": err.max().item(),
            "max_bound": bound.max().item(),
            "codes_equal_cpu": True,
            "ms": eager_ms(lambda: compressed_psum_mean(x, group), 20)}


def _dist_pipeline(stages) -> float:
    m, rows, width = PIPE
    w = randn((1, width, width), torch.float32, 37) * 0.05
    x_mb = randn((m, rows, width), torch.float32, 38)
    fn = make_pipelined_fn(lambda p, v: torch.tanh(v @ p["w"]), stages, 1)
    return _rel_err(fn({"w": w}, x_mb).to_local(), torch.tanh(x_mb @ w[0]))


def _dist_place(mesh2) -> dict:
    from torch.distributed.tensor import DTensor
    b, seq = DIST_BATCH
    batch = _gen_batch(data_config(get_config(ARCH), seq, b), 0)
    placed = place_on_mesh(mesh2, train_rules())(batch)
    for k, t in placed.items():
        want = torch.as_tensor(batch[k])
        if not (isinstance(t, DTensor) and t.device.type == "cuda"
                and torch.equal(t.full_tensor().cpu(), want)
                and t.to_local().shape == want.shape):
            raise AssertionError(f"place_on_mesh: {k} is not the batch")
    return {k: {"shape": list(t.shape), "placements":
                [str(pl) for pl in t.placements]} for k, t in placed.items()}


def phase_distributed(smi: str) -> None:
    """The port's distributed layer over NCCL in a world of one: a
    ``FileStore`` in a temporary directory opens the group (no port), the
    meshes come from ``make_mesh``, every result is held against its plain
    PyTorch computation on the card. One card exchanges nothing: each
    collective runs over NCCL, but no byte crosses a link. No fallback to
    gloo or the CPU: if NCCL does not come up, the phase fails."""
    import tempfile

    import torch.distributed as dist
    t0 = time.monotonic()
    ops.reset_launches()
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"backend {dist.get_backend()}")
            mesh = make_mesh((1,), ("model",))
            line = {"phase": "distributed", "backend": dist.get_backend(),
                    "world_size": dist.get_world_size(),
                    "links": "none: a world of one on one card, so no "
                             "byte crossed a link",
                    "mesh_device": mesh.device_type,
                    "matmul_max_rel_err": _dist_matmuls(mesh),
                    "tp_block": _dist_tp_block(mesh),
                    "compressed_psum_mean": _dist_psum(
                        mesh.get_group("model")),
                    "pipeline_max_rel_err": _dist_pipeline(
                        make_mesh((1,), ("stage",))),
                    "place_on_mesh": _dist_place(
                        make_mesh((1, 1), ("data", "model")))}
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    _no_launches("distributed")
    emit({**line, "seconds": time.monotonic() - t0, "nvidia_smi": smi})
    _free_card()


def _sharded_train(arch: str, mesh) -> dict:
    """``arch`` at full width: SHARDED_STEPS steps of ``Trainer(mesh=...)``
    against ``Trainer(mesh=None)`` from the same seed on the same card;
    losses within SHARDED_TRAIN_TOL, launches equal."""
    cfg = get_config(arch)
    tcfg = train_config(cfg, SHARDED_STEPS)
    runs = {}
    for side, m in (("unsharded", None), ("sharded", mesh)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        hist = _train_run(Trainer(cfg, tcfg, mesh=m), PrefetchingLoader(
            data_config(cfg, TRAIN_SEQ, TRAIN_BATCH)), SHARDED_STEPS)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        del hist["params"], hist["opt_state"]
        _free_card()
        runs[side] = {"loss": hist["loss"],
                      "host_ms_per_step": [1e3 * t for t in
                                           hist["step_time_s"]],
                      "max_memory_allocated_gb":
                          torch.cuda.max_memory_allocated() / 1e9,
                      "launches_per_step": {
                          k: v / SHARDED_STEPS for k, v in launches.items()
                          if v}}
    a, b = runs["unsharded"], runs["sharded"]
    if not np.allclose(b["loss"], a["loss"], rtol=SHARDED_TRAIN_TOL,
                       atol=SHARDED_TRAIN_TOL):
        raise AssertionError(f"sharded {arch} losses {b['loss']} vs "
                             f"{a['loss']}")
    want = TRAIN_LAUNCHES[arch]
    if b["launches_per_step"] != a["launches_per_step"] or \
            a["launches_per_step"] != want:
        raise AssertionError(f"sharded {arch} launches a step "
                             f"{b['launches_per_step']}, unsharded "
                             f"{a['launches_per_step']}, want {want}")
    return {**runs, "losses_bitwise_equal": a["loss"] == b["loss"],
            "max_loss_diff": max(abs(x - y) for x, y in
                                 zip(a["loss"], b["loss"]))}


def _hybrid_config():
    """jamba-1.5-large-398b at full width, its first HYBRID_LAYERS layers."""
    cfg = get_config(HYBRID_ARCH)
    return cfg.replace(num_layers=HYBRID_LAYERS,
                       layer_pattern=cfg.layer_kinds()[:HYBRID_LAYERS])


def _sharded_serve(arch: str, mesh, cfg=None, int8: bool = False) -> tuple:
    """SHARDED_PROMPTS through a ContinuousBatcher of SLOTS slots over
    ``ServingEngine(mesh=...)`` and over the unsharded engine, one draw of
    random weights (seed 0) loaded into each in turn, with weight-only int8
    if ``int8`` (each engine quantizes on the card): greedy tokens equal,
    launches equal. Returns (the line's part, the sharded run's
    launches)."""
    cfg = cfg or get_config(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in SHARDED_PROMPTS[arch]]
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            torch.device("cuda"))
    runs, launched = {}, {}
    for side, m in (("unsharded", None), ("sharded", mesh)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(cfg, ServeConfig(max_seq_len=MAX_LEN,
                                             quantize_weights=int8), mesh=m)
        eng.load(params)
        batcher = ContinuousBatcher(eng, SLOTS)
        for p in prompts:
            batcher.submit(p, SHARDED_NEW)
        torch.cuda.synchronize()
        ops.reset_launches()
        tick_ms = []
        while batcher.queue or any(a is not None for a in batcher.active):
            t0 = time.perf_counter()
            batcher.step()
            tick_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        launched[side] = ops.launch_counts()
        tokens = {r.rid: r.generated for r in batcher.finished}
        del eng, batcher
        _free_card()
        runs[side] = {"tokens": tokens, "ticks": len(tick_ms),
                      "host_ms_per_tick": tick_ms,
                      "max_memory_allocated_gb":
                          torch.cuda.max_memory_allocated() / 1e9,
                      "launches": {k: v for k, v in launched[side].items()
                                   if v}}
    del params
    _free_card()
    a, b = runs["unsharded"], runs["sharded"]
    if b["tokens"] != a["tokens"] or len(a["tokens"]) != len(prompts):
        raise AssertionError(f"sharded {arch} tokens {b['tokens']} vs "
                             f"{a['tokens']}")
    if b["launches"] != a["launches"] or b["ticks"] != a["ticks"] or \
            set(a["launches"]) != set(PATH_KERNELS[arch]):
        raise AssertionError(f"sharded {arch} launches {b['launches']} "
                             f"in {b['ticks']} ticks, unsharded "
                             f"{a['launches']} in {a['ticks']}")
    return {"layers": cfg.num_layers, "int8_weights": int8,
            "prompts": list(SHARDED_PROMPTS[arch]),
            "new_tokens": SHARDED_NEW, "tokens_equal": True,
            **{side: {k: v for k, v in r.items() if k != "tokens"}
               for side, r in runs.items()}}, launched["sharded"]


def _moe_groups_layer() -> dict:
    """One granite-moe MoE layer at full width in fp32, its tokens cut into
    g = 1, 2, 4 groups (``moe._num_groups`` patched to g), on the card and
    on the CPU from the same inputs. Where the routing agrees, each
    assignment's destination (and so its keep mask) must be equal and the
    output within MOE_LAYER_TOL of the CPU's max-abs; a token whose expert
    set differs must sit at a top-k gap of at most FLIP_GAP (the ``parity``
    phase's rule), and its group is left out of the comparison (a flip
    moves the positions after it)."""
    cfg = get_config(MOE_ARCH).replace(dtype="float32")
    m = cfg.moe
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_init(gen, cfg, torch.float32, torch.device("cpu"))
    b, s = MOE_LAYER_TOKENS
    x = torch.randn((b, s, cfg.d_model), generator=gen)
    sides = {"cpu": (params, x),
             "card": (tree_map(lambda t: t.cuda(), params), x.cuda())}
    orig, out = moe._num_groups, {}
    try:
        for g in MOE_GROUPS:
            moe._num_groups = lambda g=g: g
            tpg = b * s // g
            cap = moe.expert_capacity(tpg, m)
            got = {}
            for side, (p, xs) in sides.items():
                xg = xs.reshape(g, tpg, -1)
                _, _, dest = moe.route(xg, p["router"], None, m, cap, False)
                y, aux = moe.moe_apply(p, cfg, xs, aux_loss=True)
                top_p, top_i = torch.topk(torch.softmax(
                    xg @ p["router"], -1), m.top_k + 1, dim=-1)
                # the k choices in order (the positions count them k-major)
                # and the least gap between neighbours of the top k + 1
                got[side] = {"dest": dest.cpu(), "aux": float(aux),
                             "y": y.cpu().reshape(g, tpg, -1),
                             "experts": top_i[..., :m.top_k].cpu(),
                             "gap": (top_p[..., :-1] - top_p[..., 1:]
                                     ).min(-1).values.cpu()}
            card, cpu = got["card"], got["cpu"]
            flipped = (card["experts"] != cpu["experts"]).any(-1)   # (g, t)
            gaps = cpu["gap"][flipped].tolist()
            if any(gap > FLIP_GAP for gap in gaps):
                raise AssertionError(f"MoE layer at {g} groups: routing "
                                     f"differs card vs CPU at gaps {gaps}")
            held = [i for i in range(g) if not flipped[i].any()]
            if not held:
                raise AssertionError(f"MoE layer at {g} groups: every group "
                                     "flipped")
            rows = m.num_experts * cap
            dest_eq = torch.equal(card["dest"][held], cpu["dest"][held])
            keep_eq = torch.equal(card["dest"][held] < rows,
                                  cpu["dest"][held] < rows)
            keep = cpu["dest"] < rows
            scale = cpu["y"].abs().max().item()
            err = (card["y"][held] - cpu["y"][held]).abs().max().item()
            if not (dest_eq and keep_eq) or err > MOE_LAYER_TOL * scale or \
                    abs(card["aux"] - cpu["aux"]) > 1e-6:
                raise AssertionError(f"MoE layer at {g} groups: dest equal "
                                     f"{dest_eq}, err {err} of {scale}, aux "
                                     f"{card['aux']} vs {cpu['aux']}")
            out[g] = {"tokens_a_group": tpg, "capacity": cap,
                      "destinations_equal": dest_eq,
                      "keep_masks_equal": keep_eq,
                      "kept_assignments": int(keep.sum()),
                      "dropped_assignments": int((~keep).sum()),
                      "max_abs_err": err, "max_abs": scale,
                      "aux_card": card["aux"], "aux_cpu": cpu["aux"],
                      "flips": len(gaps), "flip_topk_gaps": gaps,
                      "min_topk_gap": cpu["gap"].min().item(),
                      "groups_held": len(held)}
    finally:
        moe._num_groups = orig
    return {"arch": MOE_ARCH, "dtype": "float32", "tokens": [b, s],
            "tolerance": MOE_LAYER_TOL, "flip_gap_limit": FLIP_GAP,
            "groups": out}


def phase_sharded(smi: str) -> dict:
    """The model steps on a mesh over NCCL in a world of one (a
    ``FileStore`` in a temporary directory): ``make_mesh((1, 1), ("data",
    "model"))``, at full width in bf16, training (``Trainer(mesh=...)``
    against ``Trainer(mesh=None)``: internlm2-1.8b, mamba2-130m,
    granite-moe-1b-a400m) and serving (``ServingEngine(mesh=...)`` and its
    batcher against the unsharded engine's: the same three, jamba at
    HYBRID_LAYERS layers, and internlm2 with weight-only int8). Every
    kernel runs on local shards through ``local_map``, decode attention
    in partial mode, and the MoE stages on local groups; the launches must
    equal the unsharded path's, so no op fell back to a plain version.
    Then the grouped MoE layer card vs CPU (``_moe_groups_layer``). One
    card moves no byte across a link. Returns the sharded internlm2 serve
    run's launches."""
    import tempfile

    import torch.distributed as dist
    t0 = time.monotonic()
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            backend = dist.get_backend()
            if backend != "nccl":
                raise AssertionError(f"backend {backend}")
            mesh = make_mesh((1, 1), ("data", "model"))
            train = {arch: _sharded_train(arch, mesh)
                     for arch in SHARDED_TRAIN_ARCHS}
            serve_lines, launched = {}, {}
            for arch in (ARCH, MAMBA_ARCH, MOE_ARCH):
                serve_lines[arch], launched[arch] = _sharded_serve(arch,
                                                                   mesh)
            serve_lines[f"{ARCH} int8"], _ = _sharded_serve(ARCH, mesh,
                                                            int8=True)
            serve_lines[HYBRID_ARCH], _ = _sharded_serve(
                HYBRID_ARCH, mesh, cfg=_hybrid_config())
        finally:
            dist.destroy_process_group()
    groups = _moe_groups_layer()
    emit({"phase": "sharded", "mesh": {"shape": [1, 1],
                                       "axes": ["data", "model"]},
          "backend": backend, "world_size": 1,
          "links": "none: a world of one on one card",
          "train": train, "serve": serve_lines, "moe_groups": groups,
          "train_tolerance": SHARDED_TRAIN_TOL,
          "seconds": time.monotonic() - t0, "nvidia_smi": smi})
    return launched[ARCH]


# The dry run's production cells (arch, shape, multi-pod[, opts]), each
# traced in a process of its own on a fake world of 256 (512) ranks over a
# CUDA mesh, DRYRUN_JOBS at once (the host's cores), the longest trace
# (stablelm-12b's, ~90 s) first; qwen2-72b at train_4k (80 layers x 8
# microbatches) takes longer than the phase may and runs from the CLI, as
# the rest of the matrix does (``--all --both-meshes``). The train_4k cells
# of mamba2-130m and internvl2-1b have heads that the model axis of 16
# does not divide (24 Mamba heads, 14 q heads; phi3-medium's 40 fail the
# same way and take 150 s to trace, so they run with the matrix), and
# stablelm-12b's runs the flash backward's fake path at d 160.
DRYRUN_CELLS = (("stablelm-12b", "train_4k", False),
                ("internlm2-1.8b", "train_4k", False),
                ("internlm2-1.8b", "prefill_32k", False),
                ("internlm2-1.8b", "decode_32k", False),
                ("granite-moe-1b-a400m", "train_4k", False),
                ("mamba2-130m", "long_500k", False),
                ("internlm2-1.8b", "decode_32k", True),
                ("mamba2-130m", "train_4k", False),
                ("internvl2-1b", "train_4k", False),
                # ModelConfig.replace through --opts model_overrides: a
                # group of 32 q heads on one kv head, and gemma-2b's heads
                # (8/1 at d 256) in training
                ("internlm2-1.8b", "decode_32k", False,
                 {"model_overrides": {"num_heads": 32, "num_kv_heads": 1,
                                      "head_dim": 64}}),
                ("internlm2-1.8b", "train_4k", False,
                 {"model_overrides": {"num_heads": 8, "num_kv_heads": 1,
                                      "head_dim": 256}}),
                # every norm and its backward under mlp_lowp in training
                ("internlm2-1.8b", "train_4k", False,
                 {"model_overrides": {"mlp_lowp": True}}))
# Cells whose GiB a device must fit the card: all but internvl2-1b's
# train_4k, whose loss holds fp32 logits of 16 rows x 3840 x its vocab of
# 151655 a device, in the reference's own dry run too (117.24 GiB; ROADMAP
# Queue 3). granite-moe's tied table (vocab
# 49155, whole over the model axis) is unembedded on each rank's own rows.
DRYRUN_FIT = tuple(c for c in DRYRUN_CELLS
                   if c != ("internvl2-1b", "train_4k", False))
DRYRUN_TAG = "chip_smoke"
DRYRUN_JOBS = dryrun.JOBS
DRYRUN_TIMEOUT_S = 300
# The traced peak (arguments + temp) against max_memory_allocated of the
# real step: the caching allocator rounds each block up, and cuBLAS keeps
# a workspace; 10 % is the most either should take.
DRYRUN_MEMORY_TOL = 0.10


def _dryrun_cells(smi: str) -> dict:
    """Each production cell through ``dryrun.run_cells`` (``python -m
    repro_torch.launch.dryrun --device cuda`` in a process of its own: a
    fake world cannot share one with an NCCL group), all started
    together; one line a cell from its result file."""
    lines, failed = {}, []
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    for cell, rc, out in dryrun.run_cells(
            DRYRUN_CELLS, device="cuda", probes=False, tag=DRYRUN_TAG,
            jobs=DRYRUN_JOBS, timeout=DRYRUN_TIMEOUT_S):
        arch, shape, multi = cell[:3]
        opts = cell[3] if len(cell) > 3 else None
        if rc != 0:
            print(out[-6000:], file=sys.stderr, flush=True)
            failed.append((arch, shape, multi, opts, rc))
            continue
        with open(dryrun.result_path(arch, shape, multi, dryrun.cell_tag(
                DRYRUN_TAG, opts))) as f:
            res = json.load(f)
        r, mem = res["roofline"], res["memory_analysis"]
        line = {"phase": "dryrun", "arch": arch, "shape": shape,
                **({"opts": opts} if opts else {}),
                "mesh": res["mesh"], "chips": res["chips"],
                "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                "collective_s": r["collective_s"], "bound": r["bound"],
                "roofline_fraction": r["roofline_fraction"],
                "flops_per_chip": r["flops_per_chip"],
                "hbm_bytes_per_chip": r["hbm_bytes_per_chip"],
                "gib_per_device": mem["total_nonalias_bytes"] / 2 ** 30,
                "argument_gib": mem["argument_size_in_bytes"] / 2 ** 30,
                "temp_gib": mem["temp_size_in_bytes"] / 2 ** 30,
                "wire_bytes": res["collectives"]["wire_bytes"],
                "collective_counts": res["collectives"]["counts"],
                "kernel_calls": res["cost_analysis"]["kernel_calls"],
                "trace_s": res["lower_s"], "nvidia_smi": smi}
        emit(line)
        lines[f"{arch} {shape} {res['mesh']}"
              f"{' ' + json.dumps(opts) if opts else ''}"] = line
        if cell in DRYRUN_FIT and \
                mem["total_nonalias_bytes"] > card_bytes:
            failed.append((arch, shape, multi, opts,
                           f"{line['gib_per_device']:.2f} GiB a device > "
                           f"total_memory {card_bytes} B"))
    if failed:
        raise AssertionError(f"dryrun cells failed: {failed}")
    return lines


def _dryrun_grounding(smi: str) -> dict:
    """The dry run's counts against one real step. On a (1, 1) mesh over
    NCCL in a world of one, internlm2-1.8b at full width is traced at the
    ``train`` phase's shape and config, then one step of the same
    ``Trainer`` runs: the traced kernel calls must equal the step's
    launches, the traced aten FLOPs ``FlopCounterMode``'s over the step
    (which cannot see a ctypes launch either), and the traced peak
    (arguments + temp) ``max_memory_allocated`` within
    ``DRYRUN_MEMORY_TOL``. The terms are printed beside the step's device
    busy ms, ungated."""
    import gc
    import tempfile

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config(ARCH)
    tcfg = train_config(cfg, TRAIN_STEPS)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    opts = {k: getattr(tcfg, k) for k in ("remat", "opt_state_dtype",
                                          "microbatches", "loss_chunk")}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            ops.reset_launches()
            t0 = time.monotonic()
            traced, _, tokens = dryrun._lower_cell(cfg, shape, mesh,
                                                   opts=opts, scan=True)
            trace_s = time.monotonic() - t0
            if any(ops.launch_counts().values()):
                raise AssertionError(f"the trace launched kernels: "
                                     f"{ops.launch_counts()}")
            mem = dryrun._memory_analysis_dict(traced)
            cost, coll = dryrun._cost_and_collectives(traced)
            rec = traced.recorder
            terms = roofline_from_artifacts(
                arch=ARCH, shape=shape.name, mesh_name="1x1",
                step_kind="train", chips=1, cost=cost, collectives=coll,
                model_flops_total=dryrun.model_flops(
                    cfg.num_active_params, tokens, "train"),
                memory_analysis=mem, chip=H100_SXM)
            calls, aten_flops = rec.kernel_calls(), rec.flops
            del traced, rec
            _free_card()

            trainer = Trainer(cfg, tcfg, mesh=mesh)
            params, opt_state, _ = trainer.init_state(0)
            batch = trainer._place(_gen_batch(data_config(
                cfg, TRAIN_SEQ, TRAIN_BATCH), 0))
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            with FlopCounterMode(display=False) as fc:
                params, opt_state, _ = trainer.step_fn(params, opt_state,
                                                       batch)
                torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            step_flops = fc.get_total_flops()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                params, opt_state, _ = trainer.step_fn(params, opt_state,
                                                       batch)
                torch.cuda.synchronize()
            busy_ms = _device_busy_us([e for e in prof.events()
                                       if e.device_type == DeviceType.CUDA
                                       ]) / 1e3
            del trainer, params, opt_state, batch
        finally:
            dist.destroy_process_group()
    _free_card()
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    line = {"phase": "dryrun_grounding", "arch": ARCH,
            "shape": [TRAIN_BATCH, TRAIN_SEQ], "mesh": [1, 1],
            "trace_s": trace_s, "kernel_calls": calls,
            "step_launches": launches, "aten_flops": aten_flops,
            "step_flop_counter": step_flops,
            "kernel_flops": cost["kernel_flops"],
            "predicted_peak_bytes": predicted,
            "argument_bytes": mem["argument_size_in_bytes"],
            "temp_bytes": mem["temp_size_in_bytes"],
            "allocated_before_step": before,
            "max_memory_allocated": peak,
            "peak_error": predicted / peak - 1,
            "compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "device_busy_ms": busy_ms, "nvidia_smi": smi}
    emit(line)
    if calls != launches:
        raise AssertionError(f"traced kernel calls {calls} != the step's "
                             f"launches {launches}")
    if aten_flops != step_flops:
        raise AssertionError(f"traced aten FLOPs {aten_flops} != "
                             f"FlopCounterMode's {step_flops}")
    if abs(predicted - peak) > DRYRUN_MEMORY_TOL * peak:
        raise AssertionError(f"traced peak {predicted} vs "
                             f"max_memory_allocated {peak}: more than "
                             f"{DRYRUN_MEMORY_TOL:.0%} apart")
    return line


def phase_dryrun(smi: str) -> None:
    """The production cells of ``repro_torch.launch.dryrun``, then its
    grounding against a real step."""
    t0 = time.monotonic()
    _dryrun_cells(smi)
    cells_s = time.monotonic() - t0
    _dryrun_grounding(smi)
    emit({"phase": "dryrun", "cells_s": cells_s,
          "seconds": time.monotonic() - t0, "nvidia_smi": smi})


def main() -> None:
    t0 = time.monotonic()
    laps, last = {}, [t0]

    def lap(name: str) -> None:     # host seconds since the previous lap
        now = time.monotonic()
        laps[name] = now - last[0]
        last[0] = now
    dev = phase_device()
    phase_build()
    lap("build")
    head = phase_kernels()
    lap("kernels")
    contract = phase_contract(dev["nvidia_smi"])
    lap("contract")
    served = {arch: phase_serve(dev["nvidia_smi"], arch, lens)
              for arch, lens in ((ARCH, PROMPT_LENS),
                                 (MAMBA_ARCH, MAMBA_PROMPT_LENS),
                                 (MOE_ARCH, PROMPT_LENS),
                                 *((a, PROMPT_LENS) for a in NEW_ARCHS))}
    _free_card()
    lap("serve")
    phase_profile(ARCH, PROMPT_LENS, PROMPT_LENS[SLOTS])
    phase_profile(MAMBA_ARCH, MAMBA_PROMPT_LENS, 512)
    phase_profile(MOE_ARCH, PROMPT_LENS, PROMPT_LENS[SLOTS])
    lap("profile")
    phase_dl(dev["nvidia_smi"])
    lap("dl")
    phase_examples(dev["nvidia_smi"])
    lap("examples")
    phase_distributed(dev["nvidia_smi"])
    lap("distributed")
    served[SHARDED_SERVE_PATH] = phase_sharded(dev["nvidia_smi"])
    lap("sharded")
    _free_card()
    phase_dryrun(dev["nvidia_smi"])
    lap("dryrun")
    phase_parity(ARCH, (77, 45))
    phase_parity(MAMBA_ARCH, MAMBA_PARITY_PROMPTS)
    phase_parity(MOE_ARCH, (77, 45))
    for arch in NEW_PARITY_ARCHS:
        phase_parity(arch, (77, 45))
        _free_card()
    lap("parity")
    for arch, path in TRAIN_PATHS.items():
        served[path] = phase_train(dev["nvidia_smi"], arch)
        lap(f"train {arch}")
    served[LOWP_TRAIN_PATH] = phase_train_lowp(dev["nvidia_smi"])
    lap("train mlp_lowp")
    for arch in TRAIN_PATHS:
        phase_train_parity(arch)
        lap(f"train_parity {arch}")
    _free_card()
    phase_fleet_parity(dev["nvidia_smi"])
    lap("fleet_parity")
    phase_fleet_sweep(dev["nvidia_smi"])
    lap("fleet_sweep")
    phase_fleet_chaos(dev["nvidia_smi"])
    lap("fleet_chaos")
    phase_fleet_degrade(dev["nvidia_smi"])
    lap("fleet_degrade")
    # One row per kernel and path: its launches from that path's own serve
    # run (reset to 0 just before it), next to its case at that path's shape.
    kernels = []
    for (name, path), c in head.items():
        source, replaces = SOURCES[name]
        if path == SHARDED_SERVE_PATH:
            launches = served[path][name]
            origin = f"{path}: {SLOTS} slots, every tick's decode"
        elif path == KERNELS_PHASE:
            launches = c["launches"]
            origin = "kernels phase (no model path)"
        else:
            launches, origin = served[path][name], f"serve {path}"
        per_step = {}
        if path in TRAIN_PATHS.values() or path == LOWP_TRAIN_PATH:
            steps = LOWP_TRAIN_STEPS if path == LOWP_TRAIN_PATH \
                else TRAIN_STEPS
            origin = f"{path}, {steps} steps"
            per_step = {"launches_per_step": launches / steps}
        kernels.append({
            "name": name, "path": path, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_from": origin, **per_step,
            **({"heads_of": c["heads_of"]} if "heads_of" in c else {}),
            **({"design": c["design"]} if "design" in c else {}),
            **({"mode": c["mode"]} if "mode" in c else {}),
            **({"lowp": c["lowp"]} if c.get("lowp") else {}),
            "shape": c["shape"],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            **({"library_note": c["library_note"]}
               if "library_note" in c else {})})
    kernels += _contract_rows(contract)
    emit({"kernels": kernels, "seconds": time.monotonic() - t0,
          "phase_seconds": laps})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})


if __name__ == "__main__":
    main()
