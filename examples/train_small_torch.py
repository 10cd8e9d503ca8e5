"""Train a ~100M-parameter model for a few hundred steps on synthetic data
with the PyTorch port, the counterpart of ``examples/train_small.py``.

Exercises the port's training substrate: the model zoo config, the
synthetic data pipeline (with an induction-copy pattern the model can
learn), hand-rolled AdamW with warmup+cosine schedule, remat, and
checkpoints.  On a CUDA card attention runs K1's fp32 forward and
backward kernels.

Run:  python examples/train_small_torch.py [--steps 300] [--device cuda|cpu]
"""
import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.training import AdamWConfig, train  # noqa: E402
from repro_torch.training.data import SyntheticLM  # noqa: E402
from repro_torch.util.device import resolve_device  # noqa: E402

STEPS = 300
CHECKPOINT_DIR = str(ROOT / "build" / "train_small_torch")


def default_config():
    """~100M params: qwen-style dense, 8 layers, d_model 768."""
    return dataclasses.replace(
        get_smoke_config("qwen3-8b"),
        name="qwen3-100m", num_layers=8, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=50257)


def main(steps: int = STEPS, checkpoint_dir: str = CHECKPOINT_DIR,
         device="cuda", cfg=None, log_every: int = 20,
         log_fn=print) -> dict:
    """Train ``steps`` steps; returns ``train``'s result (params, opt
    state, history).  Raises unless the loss fell."""
    dev = resolve_device(device)
    cfg = default_config() if cfg is None else cfg
    print(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params, {dev}")

    data = SyntheticLM(cfg.vocab_size, seq_len=128, global_batch=4, seed=0)
    opt = AdamWConfig(lr=6e-4, warmup_steps=30, total_steps=steps)

    out = train(cfg, opt, iter(data), steps, dtype=torch.float32,
                device=dev, log_every=log_every,
                checkpoint_dir=checkpoint_dir, checkpoint_every=100,
                log_fn=log_fn)

    first, last = out["history"][0], out["history"][-1]
    print(f"\nloss {first['loss']:.3f} -> {last['loss']:.3f} over {steps} "
          f"steps ({last['wall_s']:.0f}s)")
    assert last["loss"] < first["loss"], "model failed to learn"
    print(f"checkpoints in {checkpoint_dir}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="~100M params; --steps 30 for a smoke run")
    ap.add_argument("--checkpoint-dir", default=CHECKPOINT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    main(args.steps, args.checkpoint_dir, device=args.device)
