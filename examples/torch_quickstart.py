"""Quickstart on the PyTorch port: pick an assigned architecture, build
its reduced config, train a few steps, then serve a few tokens. The twin
of ``examples/quickstart.py``, on ``repro_torch``'s ``Trainer``,
``PrefetchingLoader`` and ``ServingEngine``, on the card unless
``--device cpu`` asks for the plain PyTorch versions of the kernels.

    PYTHONPATH=src python examples/torch_quickstart.py --arch internlm2-1.8b
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.config import (ServeConfig, TrainConfig, get_config,
                                list_configs, smoke_config)
from repro_torch.serving.engine import ServingEngine
from repro_torch.training.data import DataConfig, PrefetchingLoader
from repro_torch.training.train_loop import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=list_configs())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    full = get_config(args.arch)
    cfg = smoke_config(full)
    print(f"arch={args.arch} family={cfg.family} "
          f"full-size={full.num_params/1e9:.2f}B "
          f"(smoke: {cfg.num_params/1e6:.1f}M)")

    # --- train a few steps ---
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2,
                       total_steps=args.steps, remat="none")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                      frontend_tokens=cfg.frontend_tokens,
                      frontend_dim=cfg.frontend_dim or cfg.d_model)
    hist = Trainer(cfg, tcfg, device=args.device).run(
        PrefetchingLoader(dcfg), steps=args.steps, log_every=5)
    print(f"loss: {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f} "
          f"over {args.steps} steps")

    # --- serve ---
    engine = ServingEngine(cfg, ServeConfig(max_seq_len=64),
                           device=args.device)
    engine.load(hist["params"])
    prompt = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8)))
    ve = None
    if cfg.frontend_tokens:
        ve = torch.zeros((1, cfg.frontend_tokens,
                          cfg.frontend_dim or cfg.d_model))
    out = engine.generate(prompt, 8, vision_embeds=ve)
    tokens = out[0].tolist()
    print("generated token ids:", tokens)
    return {"loss": hist["loss"], "tokens": tokens}


if __name__ == "__main__":
    main()
