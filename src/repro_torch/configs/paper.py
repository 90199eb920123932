"""The paper's experimental scenarios (Sec. 4 / appendix).

A copy of ``repro/configs/paper.py``: the full-size scenarios and the
CI-sized ``SMALL`` stand-ins.  The port trains all three (multiclass
``core/oracles/multiclass.py``, chain ``chain.py``, graph ``graph.py``,
with their data from ``data/synthetic.py``).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class SSVMScenario:
    name: str
    kind: str          # multiclass | chain | graph
    n: int
    f: int
    num_classes: int = 0
    mean_len: int = 0
    max_len: int = 0
    grid: tuple = ()
    oracle_sweeps: int = 0
    # simulated oracle cost (seconds/call) for the runtime-regime replay
    oracle_cost: float = 0.02
    plane_cost: float = 1e-4


USPS = SSVMScenario("usps", "multiclass", n=7291, f=256, num_classes=10,
                    oracle_cost=0.02)
OCR = SSVMScenario("ocr", "chain", n=6877, f=128, num_classes=26,
                   mean_len=8, max_len=14, oracle_cost=0.3)
HORSESEG = SSVMScenario("horseseg", "graph", n=2376, f=649, grid=(16, 16),
                        oracle_sweeps=40, oracle_cost=2.2)

SMALL = {
    "usps": SSVMScenario("usps", "multiclass", n=200, f=64, num_classes=10,
                         oracle_cost=0.02, plane_cost=1e-4),
    "ocr": SSVMScenario("ocr", "chain", n=120, f=32, num_classes=12,
                        mean_len=7, max_len=10, oracle_cost=0.3,
                        plane_cost=1e-4),
    "horseseg": SSVMScenario("horseseg", "graph", n=80, f=48, grid=(6, 6),
                             oracle_sweeps=20, oracle_cost=2.2,
                             plane_cost=1e-4),
}
