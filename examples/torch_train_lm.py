"""End-to-end training run on the PyTorch port: a ~100M-class LM for a
few hundred steps with checkpointing, resume, straggler-hedged data
loading, and a loss curve written to results/train_lm_history_torch.json.
The twin of ``examples/train_lm.py``, on the card unless ``--device cpu``
asks for the plain PyTorch versions of the kernels.

Default model: mamba2-130m at width 256, 12 layers, vocab 8192 (7.7M
params); pass --full-width for the real 130M config. Checkpoints go to
/tmp/repro_torch_train_lm by default, apart from the reference's
/tmp/repro_train_lm; they are written in the reference's layout, so either
package resumes the other's.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
"""
import argparse
import json
import os

from repro_torch.config import TrainConfig, get_config
from repro_torch.training.data import DataConfig, PrefetchingLoader
from repro_torch.training.train_loop import Trainer

HISTORY = "results/train_lm_history_torch.json"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
    ap.add_argument("--int8-adam", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("mamba2-130m")
    if not args.full_width:
        cfg = cfg.replace(d_model=256, num_layers=12, vocab_size=8192)
    print(f"model: {cfg.num_params/1e6:.1f}M params "
          f"({'full' if args.full_width else 'reduced width'})")

    tcfg = TrainConfig(
        learning_rate=3e-3, warmup_steps=max(args.steps // 20, 5),
        total_steps=args.steps, remat="none", scan_layers=True,
        opt_state_dtype="int8" if args.int8_adam else "fp32")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.batch)
    loader = PrefetchingLoader(dcfg, fetch_deadline_s=10.0)
    trainer = Trainer(cfg, tcfg, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                      device=args.device)
    hist = trainer.run(loader, steps=args.steps, log_every=10)

    out = {
        "arch": "mamba2-130m(reduced)" if not args.full_width
        else "mamba2-130m",
        "params_m": cfg.num_params / 1e6,
        "steps": hist["step"],
        "loss": hist["loss"],
        "mean_step_s": sum(hist["step_time_s"]) / len(hist["step_time_s"]),
        "hedged_batches": loader.hedge_count,
    }
    os.makedirs("results", exist_ok=True)
    with open(HISTORY, "w") as f:
        json.dump(out, f, indent=1)
    print(f"loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}; "
          f"history -> {HISTORY}")
    return out


if __name__ == "__main__":
    main()
