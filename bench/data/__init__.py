"""Seeded generators of the benchmark's data, one module per
configuration ``kind`` (``chain.py``, ``graph.py``).

Each module has ``generate(cfg, seed, device) -> dict of tensors``, made
on ``device`` by a ``torch.Generator`` seeded with ``seed`` in a few large
calls, and ``problem(arrays, cfg)``, which hands those same tensors to the
port's own ``make_problem``.  The same seed on the same kind of device
gives the same arrays.
"""
