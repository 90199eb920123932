"""Sequence-labeling max-oracle (paper appendix A.2, OCR-style), PyTorch port.

Loss-augmented Viterbi over a chain CRF with unary features
phi_u(x,y) = sum_l onehot(y_l) (x) x_l and pairwise transition
indicators phi_p(x,y) = sum_l e_{y_l, y_{l+1}}; loss = normalized Hamming.
Sequences are padded to a fixed length L with a validity mask: padded
positions contribute zero score, zero features and zero loss.

:meth:`ChainSpec.decode` computes the unaries with one ``torch.matmul``
(:meth:`ChainSpec.scores`) and runs the DP in the Viterbi kernel
(:meth:`ChainSpec.decode_scores`, :func:`repro_torch.kernels.ops
.viterbi_decode`): ``B = 1`` per exact-oracle call, ``B = n`` for the
evaluation sweep, a padded bucket of requests per serving round
(:mod:`repro_torch.serve.engine`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...api.oracle import OracleSpec, build_problem
from ...kernels import ops as kops
from ..types import SSVMProblem


def viterbi_decode(unary: torch.Tensor, trans: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """argmax_y sum_l unary[l, y_l] + sum_l trans[y_l, y_{l+1}] (masked).

    unary: (L, C); trans: (C, C); mask: (L,) bool with mask[0] true.
    Transitions into padded positions are zeroed, so the path score is the
    valid prefix's.  Returns (L,) int32 labels (arbitrary on padded
    positions).  One chain of :func:`repro_torch.kernels.ops
    .viterbi_decode`: the Viterbi kernel on a CUDA tensor, its plain
    version on a CPU tensor."""
    return kops.viterbi_decode(unary[None].float().contiguous(),
                               trans.float().contiguous(),
                               mask[None].bool().contiguous())[0]


def _one_hot(y: torch.Tensor, C: int, dtype) -> torch.Tensor:
    return F.one_hot(y.long(), C).to(dtype)


@dataclass(frozen=True)
class ChainSpec(OracleSpec):
    """Chain-CRF sequence labeling over ``data = {"x", "y", "mask"}``:
    ``x (n, L, f)`` float32, ``y (n, L)`` int32, ``mask (n, L)`` bool."""

    num_labels: int

    def dim(self, data: Any) -> int:
        f = int(data["x"].shape[-1])
        return self.num_labels * f + self.num_labels * self.num_labels

    def truth(self, ex: Dict[str, Any]):
        return ex["y"]

    def _length(self, ex) -> torch.Tensor:
        return torch.clamp_min(ex["mask"].to(ex["x"].dtype).sum(dim=1), 1.0)

    def decode(self, w: torch.Tensor, ex: Dict[str, Any]) -> torch.Tensor:
        return self.decode_scores(w, self.scores(w, ex), ex)

    def scores(self, w: torch.Tensor, ex: Dict[str, Any]) -> torch.Tensor:
        """Loss-augmented unaries <w_c, x_l> + [c != y_l] / L_i, (B, L, C):
        the decode's only sums over features."""
        x, y = ex["x"], ex["y"]
        C, f = self.num_labels, x.shape[-1]
        wu = w[: C * f].reshape(C, f)
        return (torch.matmul(x, wu.T)
                + (1.0 - _one_hot(y, C, x.dtype))
                / self._length(ex)[:, None, None])

    def decode_scores(self, w: torch.Tensor, unary: torch.Tensor,
                      ex: Dict[str, Any]) -> torch.Tensor:
        """The masked Viterbi decode of ``unary`` under the transition
        weights, each row on its own."""
        C = self.num_labels
        wp = w[w.shape[0] - C * C:].reshape(C, C)
        return kops.viterbi_decode(unary.contiguous(), wp.contiguous(),
                                   ex["mask"].contiguous())

    def features(self, ex: Dict[str, Any], y) -> torch.Tensor:
        x, mask = ex["x"], ex["mask"]
        B, C = x.shape[0], self.num_labels
        m = mask.to(x.dtype)
        # Unary part: sum_l onehot(y_l) (x) x_l, masked.
        oh = _one_hot(y, C, x.dtype) * m[:, :, None]              # (B, L, C)
        unary = torch.matmul(oh.transpose(1, 2), x).reshape(B, -1)
        # Pairwise part: transition indicators over valid adjacent pairs.
        pm = (mask[:, :-1] & mask[:, 1:]).to(x.dtype)
        pair = torch.matmul(
            _one_hot(y[:, :-1], C, x.dtype).transpose(1, 2),
            _one_hot(y[:, 1:], C, x.dtype) * pm[:, :, None]).reshape(B, -1)
        return torch.cat([unary, pair], dim=1)

    def loss(self, ex: Dict[str, Any], y) -> torch.Tensor:
        m = ex["mask"].to(ex["x"].dtype)
        return torch.sum((y != ex["y"]) * m, dim=1) / self._length(ex)

    def meta(self, data: Any):
        return {"num_labels": self.num_labels,
                "f": int(data["x"].shape[-1]),
                "L": int(data["x"].shape[-2])}


def resolve_device(device: Optional[Any]) -> torch.device:
    """The caller's device, or CUDA; raises when CUDA is asked for (or
    defaulted to) on a host without it.  Never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and this host has no CUDA "
            "device; pass device='cpu' to run the plain PyTorch path")
    return dev


def to_device(a, dtype, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a contiguous ``dtype`` tensor on
    ``device`` (the specs' ``make_problem`` inputs)."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device, dtype=dtype).contiguous()


def make_problem(features, labels, mask, num_labels: int, *,
                 device: Optional[Any] = None) -> SSVMProblem:
    """features: (n, L, f); labels: (n, L) int; mask: (n, L) bool, as numpy
    arrays or tensors.  ``device`` defaults to CUDA."""
    dev = resolve_device(device)
    data = {"x": to_device(features, torch.float32, dev),
            "y": to_device(labels, torch.int32, dev),
            "mask": to_device(mask, torch.bool, dev)}
    return build_problem(ChainSpec(num_labels), data)
