"""Graph-labeling max-oracle (paper appendix A.3, HorseSeg-style), PyTorch
port of ``repro/core/oracles/graph.py``.

Binary superpixel labeling with learned unaries and a fixed attractive
pairwise term: the oracle maximizes

    sum_l [ <w_{y'_l}, x_l> + [y'_l != y_l] / L ]  -  sum_{k~l} [y'_k != y'_l]

with red-black **parallel ICM sweeps** (:func:`icm_decode`), an
approximate oracle, as in the reference (which stands in for the paper's
BK maxflow).  The fixed cut energy is the spec's offset term, and
``clamp = True`` marks the decoder approximate: the shared assembly then
clamps planes that score below the ground-truth plane to the zero plane.
Every method takes a batch of examples; ICM updates a batch at once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ...api.oracle import OracleSpec, build_problem
from ..types import SSVMProblem
from .chain import resolve_device, to_device


def _scatter_sum(values: torch.Tensor, index: torch.Tensor,
                 L: int) -> torch.Tensor:
    """Per-row sums of ``values (B, E)`` into ``L`` nodes at ``index``."""
    out = torch.zeros((values.shape[0], L), dtype=values.dtype,
                      device=values.device)
    return out.scatter_add_(1, index, values)


def _neighbor_ones(labels, edges, edge_mask, L):
    """For each node: (# valid neighbours labeled 1, degree), (B, L)."""
    lab = labels.to(torch.float32)
    em = edge_mask.to(torch.float32)
    a, b = edges[..., 0].long(), edges[..., 1].long()
    nb1 = (_scatter_sum(em * lab.gather(1, b), a, L)
           + _scatter_sum(em * lab.gather(1, a), b, L))
    deg = _scatter_sum(em, a, L) + _scatter_sum(em, b, L)
    return nb1, deg


def icm_decode(unary: torch.Tensor, edges: torch.Tensor,
               edge_mask: torch.Tensor, color: torch.Tensor,
               mask: torch.Tensor, num_sweeps: int) -> torch.Tensor:
    """Red-black ICM for ``max_y sum_l unary[l, y_l] - cut(y)``, batched.

    ``unary (B, L, 2)``; ``edges (B, E, 2)`` int; ``color (B, L)`` in {0, 1}
    (a 2-colouring: same-colour nodes are not adjacent, so they update
    together); ``mask (B, L)`` node validity.  Warm start from the unaries,
    then ``num_sweeps`` sweeps of colour 0 then colour 1.  Returns
    ``(B, L)`` int32 labels.  Neighbour counts are sums of 0/1 values,
    exact in any order.
    """
    L = unary.shape[1]
    udiff = unary[..., 1] - unary[..., 0]
    y = (udiff > 0.0) & mask
    for _ in range(num_sweeps):
        for phase in (0, 1):
            nb1, deg = _neighbor_ones(y, edges, edge_mask, L)
            # score(1) - score(0) with the neighbours fixed.
            diff = udiff - deg + 2.0 * nb1
            upd = (color == phase) & mask
            y = torch.where(upd, diff > 0.0, y)
    return y.to(torch.int32)


def _cut(labels, edges, edge_mask) -> torch.Tensor:
    """Cut edges per example, (B,)."""
    em = edge_mask.to(torch.float32)
    a, b = edges[..., 0].long(), edges[..., 1].long()
    return torch.sum(em * (labels.gather(1, a) != labels.gather(1, b)
                           ).to(torch.float32), dim=1)


def _length(ex) -> torch.Tensor:
    return torch.clamp_min(ex["mask"].to(ex["x"].dtype).sum(dim=1), 1.0)


def _plane(x, y_true, y_pred, mask, edges, edge_mask, n):
    """phi^{iy} per example, written out: unary feature difference / n and
    circ = (loss + cut(y) - cut(y')) / n.  The explicit form of what
    :func:`repro_torch.api.build_problem` assembles from :class:`GraphSpec`
    (before the clamp); the tests pin the two together."""
    m = mask.to(x.dtype)
    length = torch.clamp_min(m.sum(dim=1), 1.0)
    oh_pred = F.one_hot(y_pred.long(), 2).to(x.dtype) * m[..., None]
    oh_true = F.one_hot(y_true.long(), 2).to(x.dtype) * m[..., None]
    star = torch.matmul((oh_pred - oh_true).transpose(1, 2), x
                        ).reshape(x.shape[0], -1) / n
    loss = torch.sum((y_pred != y_true) * m, dim=1) / length
    circ = (loss + _cut(y_true, edges, edge_mask)
            - _cut(y_pred, edges, edge_mask)) / n
    return torch.cat([star, circ[:, None]], dim=1)


@dataclass(frozen=True)
class GraphSpec(OracleSpec):
    """Binary graph labeling over ``data = {"x", "y", "mask", "edges",
    "edge_mask", "color"}`` with an approximate (ICM) decoder."""

    num_sweeps: int = 20
    clamp = True  # approximate decoder: clamp planes to H~_i >= 0

    def dim(self, data: Any) -> int:
        return 2 * int(data["x"].shape[-1])

    def truth(self, ex: Dict[str, Any]):
        return ex["y"]

    def decode(self, w: torch.Tensor, ex: Dict[str, Any]) -> torch.Tensor:
        return self.decode_scores(w, self.scores(w, ex), ex)

    def scores(self, w: torch.Tensor, ex: Dict[str, Any]) -> torch.Tensor:
        """Loss-augmented unaries <w_c, x_l> + [c != y_l] / L, zero at
        masked nodes, (B, L, 2): the decode's only sums over features."""
        x, y, m = ex["x"], ex["y"], ex["mask"]
        wc = w.reshape(2, x.shape[-1])
        unary = (torch.matmul(x, wc.T)
                 + (1.0 - F.one_hot(y.long(), 2).to(x.dtype))
                 / _length(ex)[:, None, None])
        return torch.where(m[..., None], unary, torch.zeros_like(unary))

    def decode_scores(self, w: torch.Tensor, unary: torch.Tensor,
                      ex: Dict[str, Any]) -> torch.Tensor:
        """Red-black ICM from ``unary``, each row on its own."""
        return icm_decode(unary, ex["edges"], ex["edge_mask"], ex["color"],
                          ex["mask"], self.num_sweeps)

    def features(self, ex: Dict[str, Any], y) -> torch.Tensor:
        x = ex["x"]
        m = ex["mask"].to(x.dtype)
        oh = F.one_hot(y.long(), 2).to(x.dtype) * m[..., None]
        return torch.matmul(oh.transpose(1, 2), x).reshape(x.shape[0], -1)

    def loss(self, ex: Dict[str, Any], y) -> torch.Tensor:
        m = ex["mask"].to(ex["x"].dtype)
        return torch.sum((y != ex["y"]) * m, dim=1) / _length(ex)

    def offset(self, ex: Dict[str, Any], y) -> torch.Tensor:
        # Fixed attractive pairwise energy: the score gains -cut(y).
        return -_cut(y, ex["edges"], ex["edge_mask"])

    def meta(self, data: Any):
        return {"f": int(data["x"].shape[-1]),
                "L": int(data["x"].shape[-2]),
                "num_sweeps": self.num_sweeps}


def make_problem(features, labels, mask, edges, edge_mask, color,
                 num_sweeps: int = 20, *,
                 device: Optional[Any] = None) -> SSVMProblem:
    """features: (n, L, f); labels, mask, color: (n, L); edges: (n, E, 2);
    edge_mask: (n, E); numpy arrays or tensors.  ``device`` defaults to
    CUDA."""
    dev = resolve_device(device)
    data = {"x": to_device(features, torch.float32, dev),
            "y": to_device(labels, torch.int32, dev),
            "mask": to_device(mask, torch.bool, dev),
            "edges": to_device(edges, torch.int32, dev),
            "edge_mask": to_device(edge_mask, torch.bool, dev),
            "color": to_device(color, torch.int32, dev)}
    return build_problem(GraphSpec(num_sweeps), data)
