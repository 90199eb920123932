"""A copy of the benchmark's layout at small sizes, for the CPU tests."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# The CI sizes of the port's configs/paper.py::SMALL, at the configs' own
# recipes: OCR chains of 12 labels, HorseSeg lattices of 6 x 6 nodes.
SMALL = {
    "ocr": dict(n=120, f=32, num_labels=12, mean_len=7, max_len=10,
                d=12 * 32 + 12 * 12),
    "horseseg": dict(n=80, f=48, grid=[6, 6], sweeps=20, d=96),
}


def small_layout(tmp: Path) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and ``bench/``'s data files, the
    configurations cut to :data:`SMALL`.  Returns the root."""
    root = Path(tmp)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(REPO / "bench" / sub, root / "bench" / sub)
    for name, sizes in SMALL.items():
        path = root / "bench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(sizes)
        path.write_text(json.dumps(cfg))
    return root
