"""Training CLI.

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 100 \
        [--smoke | --full] [--seq 256] [--batch 8] [--checkpoint-dir ckpt/] \
        [--device cuda]

The JAX package's ``launch/train.py`` with the same arguments and
defaults, plus ``--device`` (default ``cuda``; ``--device cpu`` runs on
the CPU, and asking for CUDA where there is no card fails).  ``--smoke``
(the default) selects the reduced config of the same family; ``--full``
the published one, which trains in fp32 on one card: qwen2-0.5b at full
width fits an 80 GB H100 at the default batch.  On CUDA the Mamba2
families (mamba2-370m, jamba) cannot train yet: the SSD scan's kernel has
no backward (ROADMAP Queue 1 item 12).  The embedding-input archs
(hubert-xlarge, llava-next-34b) train here; the JAX CLI raises
``TypeError`` for them, since it iterates their ``SyntheticEmbeds``.
"""
from __future__ import annotations

import argparse
import itertools

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.training import AdamWConfig, train
from repro_torch.training.data import SyntheticEmbeds, SyntheticLM


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"training {cfg.name}: {cfg.num_blocks} blocks, "
          f"d_model={cfg.d_model}, ~{cfg.param_count()/1e6:.1f}M params")
    if cfg.embedding_inputs:
        data = SyntheticEmbeds(cfg.d_model, cfg.vocab_size, args.seq,
                               args.batch)
    else:
        data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    # batch_at(step) for both data classes: SyntheticEmbeds has no
    # __iter__, and SyntheticLM's yields exactly these batches.
    batches = (data.batch_at(step) for step in itertools.count())
    train(cfg, opt, batches, args.steps,
          dtype=torch.float32, device=args.device,
          checkpoint_dir=args.checkpoint_dir,
          checkpoint_every=args.checkpoint_every)


if __name__ == "__main__":
    main()
