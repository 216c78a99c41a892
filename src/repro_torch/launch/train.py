"""Training launcher of the port.

    python -m repro_torch.launch.train --arch internlm2-1.8b --steps 8

The JAX package's ``repro.launch.train`` flags, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain versions of the kernels, as the tests do).
``--smoke`` takes the reduced config, with remat off and one microbatch as
the JAX launcher sets them; otherwise ``default_train_config`` decides.
Prints the JAX launcher's JSON keys plus ``device`` and
``kernel_launches`` (the hand-written kernels launched over the run).
"""
from __future__ import annotations

import argparse
import json
import logging

from repro_torch.config import (ModelConfig, TrainConfig, get_config,
                                smoke_config)
from repro_torch.kernels import ops
from repro_torch.launch.specs import default_train_config
from repro_torch.training.data import DataConfig, PrefetchingLoader
from repro_torch.training.train_loop import Trainer


def train_config(cfg: ModelConfig, steps: int, *, lr: float = 1e-3,
                 opt_state_dtype: str = "fp32",
                 smoke: bool = False) -> TrainConfig:
    """The launcher's TrainConfig: ``default_train_config`` with the
    launcher's learning rate, schedule and moments; at smoke size remat
    off and one microbatch, as the JAX launcher sets them."""
    base = default_train_config(cfg)
    return TrainConfig(**{**base.__dict__,
                          "learning_rate": lr,
                          "total_steps": steps,
                          "warmup_steps": max(steps // 10, 1),
                          "opt_state_dtype": opt_state_dtype,
                          "microbatches": 1 if smoke else base.microbatches,
                          "remat": "none" if smoke else base.remat})


def data_config(cfg: ModelConfig, seq_len: int, batch: int) -> DataConfig:
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=batch,
                      frontend_tokens=cfg.frontend_tokens,
                      frontend_dim=cfg.frontend_dim or cfg.d_model)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--opt-state-dtype", default="fp32",
                    choices=["fp32", "int8"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    tcfg = train_config(cfg, args.steps, lr=args.lr,
                        opt_state_dtype=args.opt_state_dtype,
                        smoke=args.smoke)
    loader = PrefetchingLoader(data_config(cfg, args.seq_len, args.batch))
    trainer = Trainer(cfg, tcfg, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, device=args.device)
    ops.reset_launches()
    hist = trainer.run(loader, steps=args.steps, log_every=args.log_every)
    print(json.dumps({
        "arch": args.arch,
        "steps": len(hist["loss"]),
        "first_loss": hist["loss"][0],
        "last_loss": hist["loss"][-1],
        "mean_step_s": sum(hist["step_time_s"]) / len(hist["step_time_s"]),
        "hedged_batches": loader.hedge_count,
        "device": str(trainer.device),
        "kernel_launches": ops.launch_counts(),
    }, indent=1))


if __name__ == "__main__":
    main()
