"""Train-step builder and fault-tolerant training loop: the JAX package's
``training/train_loop.py``, on one device or on a mesh.

``make_train_step`` closes over (model cfg, train cfg) and returns a
(params, opt_state, batch) -> (params, opt_state, metrics) function. The
gradient is ``torch.autograd.grad`` of ``models.model.loss_fn``, whose
rmsnorm, attention and SSD scan run their backward kernels on the card; with
``microbatches`` > 1 the per-microbatch gradients are summed in fp32 and
divided by their count, as the JAX scan does. The update is in place (see
``training/optimizer.py``).

On a mesh (``jit_train_step``, ``Trainer(mesh=...)``) the same step runs
under ``use_sharding(mesh, rules)`` on DTensor params, optimizer state and
batches, as the JAX package traces its step under the sharding context:
the models' ``shard()`` calls lay out the activations, the kernels run on
local shards, and the update redistributes each gradient to its
parameter's placements (``training/optimizer.py``).

``Trainer`` runs it with async checkpoints and bitwise resume. Its
checkpoints are written in the JAX package's layout and keypaths
(``convert.to_jax_params``/``to_jax_opt_state``), so either package's
``Trainer`` resumes from the other's. Two differences from the JAX loop:
the history also records each step's ``grad_norm``, and the save forced
at the end of a run is skipped where the run just saved that step (JAX
writes the same checkpoint twice; at full width one is 19 GB).
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from torch.distributed.tensor import DTensor

from repro_torch import convert
from repro_torch.config import ModelConfig, TrainConfig, resolve_device
from repro_torch.distributed.sharding import (RuleSet, check_mesh_device,
                                              distribute_tree, map_shardings,
                                              place, train_rules,
                                              use_sharding)
from repro_torch.launch.specs import opt_shardings, params_shardings
from repro_torch.models import model as lm
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import place_on_device, place_on_mesh
from repro_torch.training.optimizer import (OptState, adamw_update,
                                            init_opt_state)
from repro_torch.tree import tree_leaves, tree_map

log = logging.getLogger(__name__)
Params = Any


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig
                    ) -> Callable[[Params, OptState, Dict[str, Any]],
                                  Tuple[Params, OptState, Dict[str, Any]]]:
    def grads_of(leaves, params, batch):
        loss, metrics = lm.loss_fn(params, cfg, batch, remat=tcfg.remat,
                                   loss_chunk=tcfg.loss_chunk)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if tcfg.microbatches > 1:
            mb = tcfg.microbatches

            def split(x, i):
                n = x.shape[0] // mb
                return x[i * n:(i + 1) * n]

            g_acc = [torch.zeros_like(p, dtype=torch.float32,
                                      memory_format=torch.contiguous_format)
                     for p in leaves]
            l_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            m_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for i in range(mb):
                loss, metrics, grads = grads_of(
                    leaves, params, {k: split(x, i) for k, x in batch.items()})
                g_acc = [a + g for a, g in zip(g_acc, grads)]
                l_acc = l_acc + loss
                m_acc = m_acc + metrics["ce"]
            grads = [g / mb for g in g_acc]
            loss, metrics = l_acc / mb, {"ce": m_acc / mb}
        else:
            loss, metrics, grads = grads_of(leaves, params, batch)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, tcfg)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def jit_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                   rules: Optional[RuleSet] = None
                   ) -> Callable[[Params, OptState, Dict[str, Any]],
                                 Tuple[Params, OptState, Dict[str, Any]]]:
    """The JAX package's ``jit_train_step``: ``make_train_step`` run under
    ``use_sharding(mesh, rules)`` (default ``train_rules()``). It traces
    nothing; the shardings come with the inputs (DTensors laid out by
    ``launch/specs.py``), and the update is in place, so there is nothing
    to donate."""
    rules = rules or train_rules()
    step = make_train_step(cfg, tcfg)

    def sharded(params, opt_state, batch):
        with use_sharding(mesh, rules):
            return step(params, opt_state, batch)

    return sharded


def scalar(t: Any) -> float:
    """A metric as a Python float (a DTensor's whole value)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return float(t)


# ---------------------------------------------------------------------------
# The loop.
# ---------------------------------------------------------------------------
class Trainer:
    """Checkpointed, resumable training loop with async saves, on one
    device (``"cuda"`` unless the caller asks for the CPU), or on a
    ``mesh`` (a ``DeviceMesh`` of that device type) under ``rules``
    (default ``train_rules()``): params laid out by
    ``launch/specs.py::params_shardings``, the optimizer state by
    ``opt_shardings``, each batch by ``place_on_mesh``."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *,
                 mesh=None, rules: Optional[RuleSet] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 keep: int = 3, device: str | torch.device = "cuda"):
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self.mesh, self.rules = mesh, rules or train_rules()
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        if mesh is None:
            self.step_fn = make_train_step(cfg, tcfg)
            self._place = place_on_device(self.device)
        else:
            check_mesh_device(mesh, self.device, "a trainer")
            self.step_fn = jit_train_step(cfg, tcfg, mesh, self.rules)
            self._place = place_on_mesh(mesh, self.rules)
        self._pending_save = None
        self._saved_step: Optional[int] = None

    def init_state(self, seed: int = 0, params: Optional[Params] = None
                   ) -> Tuple[Params, OptState, int]:
        """Params from ``seed`` (the port's own init), or a copy of
        ``params`` (for example the JAX package's, converted), with fresh
        optimizer state; or, where ``ckpt_dir`` has a checkpoint, its
        params and state. A checkpoint is read into host memory against a
        template of shapes alone (meta tensors), then moved to the device
        layer by layer, so the device never holds a second copy."""
        start = ckpt.latest_step(self.ckpt_dir) if self.ckpt_dir else None
        if start is not None:
            meta = torch.device("meta")
            like = (lm.init_params(self.cfg, torch.Generator(), meta)
                    if params is None
                    else tree_map(lambda t: t.to(meta), params))
            shardings = None
            if self.mesh is not None:
                shardings = {
                    "params": convert.to_jax_shardings(self._shardings(),
                                                       self.cfg),
                    "opt": convert.to_jax_shardings(self._opt_shardings(),
                                                    self.cfg)}
            tree = ckpt.restore(self.ckpt_dir, self._jax_tree(
                like, init_opt_state(like, self.tcfg)), device="cpu",
                shardings=shardings)
            log.info("resumed from step %d", start)
            return (convert.from_jax_params(tree["params"], self.cfg,
                                            self.device),
                    convert.from_jax_opt_state(tree["opt"], self.cfg,
                                               self.device), start)
        if params is None:
            params = lm.init_params(
                self.cfg, torch.Generator(self.device).manual_seed(seed),
                self.device)
        else:
            params = tree_map(lambda t: t.detach().to(self.device,
                                                      copy=True), params)
        if self.mesh is None:
            return params, init_opt_state(params, self.tcfg), 0
        # Drawn whole from the same seed as on one device, then each leaf
        # replaced by its shard: at most one whole leaf beside the shards.
        params = distribute_tree(params, self._shardings())
        opt = map_shardings(place, init_opt_state(params, self.tcfg),
                            self._opt_shardings())
        return params, opt, 0

    def _shardings(self):
        return params_shardings(self.cfg, self.mesh, self.rules)

    def _opt_shardings(self):
        return opt_shardings(self.cfg, self.tcfg, self.mesh, self.rules)[0]

    def _jax_tree(self, params: Params, opt_state: OptState) -> Dict:
        return {"params": convert.to_jax_params(params, self.cfg),
                "opt": convert.to_jax_opt_state(opt_state, self.cfg)}

    def maybe_checkpoint(self, step: int, params: Params,
                         opt_state: OptState, force: bool = False) -> None:
        if not self.ckpt_dir:
            return
        if step == self._saved_step:
            return      # the end of a run that just saved this step
        if force or (step > 0 and step % self.ckpt_every == 0):
            if self._pending_save is not None:
                self._pending_save.wait()
            self._pending_save = ckpt.save_async(
                self.ckpt_dir, step, self._jax_tree(params, opt_state),
                keep=self.keep)
            self._saved_step = step

    def run(self, data_iter, steps: int, seed: int = 0,
            log_every: int = 10, params: Optional[Params] = None
            ) -> Dict[str, list]:
        params, opt_state, start = self.init_state(seed, params)
        history: Dict[str, list] = {"step": [], "loss": [], "ce": [],
                                    "grad_norm": [], "step_time_s": []}
        for step in range(start, steps):
            batch = self._place(data_iter.get(step) if hasattr(
                data_iter, "get") else next(data_iter))
            t0 = time.monotonic()
            params, opt_state, metrics = self.step_fn(
                params, opt_state, batch)
            loss = scalar(metrics["loss"])
            dt = time.monotonic() - t0
            history["step"].append(step)
            history["loss"].append(loss)
            history["ce"].append(scalar(metrics["ce"]))
            history["grad_norm"].append(scalar(metrics["grad_norm"]))
            history["step_time_s"].append(dt)
            if step % log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step, loss, dt)
            self.maybe_checkpoint(step + 1, params, opt_state)
        self.maybe_checkpoint(steps, params, opt_state, force=True)
        if self._pending_save is not None:
            self._pending_save.wait()
        history["params"] = params          # type: ignore[assignment]
        history["opt_state"] = opt_state    # type: ignore[assignment]
        return history
