"""End-to-end LM training driver example, the port of
``examples/lm_train.py``.

Default: a reduced qwen2-family model for a few hundred steps with
checkpoint/restart (into a temporary directory unless ``--ckpt-dir``
names one).  ``--params 100000000`` scales the family config to ~100M
parameters.

    python -m repro_torch.examples.lm_train --steps 300 [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

from ..launch.train import train_lm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--params", type=int, default=0,
                    help="scale width to ~this many params (0 = reduced)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        out = train_lm(args.arch, args.steps, args.batch_size, args.seq_len,
                       reduced=args.params == 0,
                       ckpt_dir=args.ckpt_dir or tmp, save_every=100,
                       target_params=args.params, device=args.device)
    first, last = out["losses"][0][1], out["final_loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {args.steps} steps")
    return out


if __name__ == "__main__":
    main()
