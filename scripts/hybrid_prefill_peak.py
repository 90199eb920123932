#!/usr/bin/env python3
"""Peak device memory of zamba2-7b's prefills on one card: the two
prefills of ``chip_smoke.py``'s ``main_hybrid`` phase (2 x 1024 tokens,
then 1 x 8192 under the long-context window), at published width and
depth, bf16 weights from a CUDA generator seeded 0 (as the smoke's).

    python3 scripts/hybrid_prefill_peak.py [--src DIR] [--label NAME]

``--src`` is the ``src/`` directory the port is imported from (default:
this checkout's), so that one call on the card can hold one tree against
another unpacked beside it: run each in a process of its own, in turns
(parent, tree, tree, parent).  Each prefill runs twice (the first builds
B5).  Prints one JSON line: the label, the package's path, torch's
version, the card's name and power limit, the weights' bytes, and per
prefill its shape, seconds and, per run, the peak bytes allocated
(``torch.cuda.max_memory_allocated``, reset just before the prefill, the
batch on the card) and that peak less the bytes allocated before it.
Exits 2 without a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "zamba2-7b"
# (name, batch, tokens, under the long-context overrides)
PREFILLS = (("prefill", 2, 1024, False), ("long_prefill", 1, 8192, True))
RUNS = 2


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hybrid_prefill_peak: no CUDA card", file=sys.stderr)
        sys.exit(2)
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch import configs
    from repro_torch.models import common, registry
    assert pathlib.Path(repro_torch.__file__).resolve().is_relative_to(src)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    cfg = configs.get_config(ARCH)
    gen = torch.Generator("cuda")
    gen.manual_seed(0)
    params = common.init_params(registry.param_specs(cfg), gen, "cuda")
    param_bytes = sum(t.numel() * t.element_size()
                      for t in common.leaves(params))
    rows = []
    for name, B, S, long in PREFILLS:
        c = dataclasses.replace(cfg, **configs.long_context_overrides(
            ARCH)) if long else cfg
        batch = {k: v.cuda() for k, v in registry.make_train_batch(
            cfg, B, S, 0).items()}
        runs = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits = registry.prefill(params, c, batch)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            if not bool(torch.isfinite(logits).all()):
                raise RuntimeError(f"{name}: logits not finite")
            del logits
            runs.append(dict(seconds=seconds, peak_bytes=peak,
                             peak_over_before=peak - before))
        del batch
        torch.cuda.empty_cache()
        rows.append(dict(name=name, shape=[B, S], runs=runs))
    print(json.dumps(dict(label=args.label, package=str(src),
                          torch=torch.__version__, card=card,
                          param_bytes=param_bytes, prefills=rows)))


if __name__ == "__main__":
    main()
