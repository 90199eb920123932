"""HorseSeg-like lattices (arXiv:1408.6804 App. A.3), made on the device.

The recipe of the port's ``data/synthetic.py::horseseg_like``: two
Gaussian prototypes of width ``f``; per example a random half-plane
``a r / H + b c / W + 0.3 c0 > 0`` over the ``H x W`` lattice as the
ground truth; features ``prototype[y] + noise * N(0, 1)``; the lattice's
4-neighbour edges and its checkerboard 2-colouring (red-black ICM).
"""
from __future__ import annotations

import torch


def lattice(H: int, W: int, device):
    """The 4-neighbour edges ``(E, 2)`` int32 and the checkerboard colour
    ``(H W,)`` int32 of an ``H x W`` lattice, row-major nodes."""
    v = torch.arange(H * W, device=device).reshape(H, W)
    right = torch.stack([v[:, :-1], v[:, 1:]], -1).reshape(-1, 2)
    down = torch.stack([v[:-1, :], v[1:, :]], -1).reshape(-1, 2)
    # The reference order: per node, its right edge then its down edge.
    src = torch.cat([right, down])
    order = torch.argsort(src[:, 0] * 2 + (src[:, 1] - src[:, 0] != 1),
                          stable=True)
    edges = src[order].to(torch.int32)
    r, c = torch.meshgrid(torch.arange(H, device=device),
                          torch.arange(W, device=device), indexing="ij")
    return edges, ((r + c) % 2).reshape(-1).to(torch.int32)


def generate(cfg, seed: int, device) -> dict:
    n, f = int(cfg["n"]), int(cfg["f"])
    H, W = (int(s) for s in cfg["grid"])
    L = H * W
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    protos = torch.randn((2, f), generator=g, device=device)
    abc = torch.randn((n, 3), generator=g, device=device)
    r, c = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                          torch.arange(W, device=device, dtype=torch.float32),
                          indexing="ij")
    y = ((abc[:, 0, None, None] * r / H + abc[:, 1, None, None] * c / W
          + 0.3 * abc[:, 2, None, None]) > 0).reshape(n, L).long()
    x = protos[y] + float(cfg["noise"]) * torch.randn(
        (n, L, f), generator=g, device=device)
    edges, color = lattice(H, W, device)
    E = edges.shape[0]
    return {"x": x.contiguous(), "y": y.to(torch.int32),
            "mask": torch.ones((n, L), dtype=torch.bool, device=device),
            "edges": edges.expand(n, E, 2).contiguous(),
            "edge_mask": torch.ones((n, E), dtype=torch.bool, device=device),
            "color": color.expand(n, L).contiguous()}


def problem(arrays: dict, cfg):
    """The port's graph problem over ``arrays`` (on their device)."""
    from repro_torch.core.oracles import graph
    return graph.make_problem(arrays["x"], arrays["y"], arrays["mask"],
                              arrays["edges"], arrays["edge_mask"],
                              arrays["color"], int(cfg["sweeps"]),
                              device=arrays["x"].device)


def stats(arrays: dict) -> dict:
    return {"positions": int(arrays["mask"].sum()),
            "edges": int(arrays["edge_mask"].sum())}


def work(cfg, stats: dict) -> dict:
    """Per-example work of the ICM oracle: the features, labels, masks,
    colours and edges read; the unary scores (``4 f`` per node), per
    half-sweep four operations per edge and per node, and the two feature
    maps' sums (``2 f`` per node each)."""
    n, f = int(cfg["n"]), int(cfg["f"])
    L, E = stats["positions"] / n, stats["edges"] / n
    example = L * f * 4 + L * (4 + 1 + 4) + E * (8 + 1)
    flops = L * 4 * f + int(cfg["sweeps"]) * 2 * (4 * E + 4 * L) + 4 * L * f
    return {"example_bytes": example, "data_bytes": n * example,
            "oracle_flops": flops}
