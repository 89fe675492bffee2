"""CLI launcher: ``python -m repro_torch.launch.train --arch <id> [options]``
(port of ``repro/launch/train.py``, the same flags plus ``--device``).

Trains on the card (``--device cuda``, the default) or on the CPU
(``--device cpu``, reduced configs), one device::

    python -m repro_torch.launch.train --arch minicpm-2b --steps 6 \\
        --seq-len 2048 --batch 8 --accum 2
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd", "const"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..data.pipeline import DataConfig
    from ..optim.adamw import AdamWConfig
    from ..train.train_loop import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    # MiniCPM's assigned schedule is WSD
    schedule = "wsd" if cfg.name == "minicpm-2b" and args.schedule == "cosine" else args.schedule

    dcfg = DataConfig(
        seq_len=args.seq_len, global_batch=args.batch, vocab=cfg.vocab,
        source=args.data, path=args.data_path, seed=args.seed,
    )
    ocfg = AdamWConfig(lr=args.lr, schedule=schedule, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 20))
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         accum_steps=args.accum)
    tr = Trainer(cfg, ocfg, dcfg, tcfg, seed=args.seed, device=args.device)
    if args.resume:
        tr.try_restore()
    hist = tr.run(args.steps)
    last = hist[-min(10, len(hist)):]
    avg = sum(h["loss"] for h in last) / len(last)
    print(f"final step {tr.step}: loss(last10)={avg:.4f}")


if __name__ == "__main__":
    main()
