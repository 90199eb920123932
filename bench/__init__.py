"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once (see ``bench/run.py``).  Everything a cell
needs is found by name: ``configs/<config>.json``, ``traffic/<traffic>
.json``, ``workloads/<cell>.json``, ``metrics/<metric>.py``, the seeded
generators ``data/<kind>.py`` and the plain references
``reference/<kind>.py``.
"""
