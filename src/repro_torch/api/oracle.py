"""The declarative ``OracleSpec`` and :func:`build_problem` (PyTorch port).

A task is described by its loss-augmented decoder, joint feature map,
task loss and optional fixed score terms; :func:`build_problem` turns
that into the plane oracle of the paper (eq. 5):

    phi^{iy} = [(psi(x_i, y) - psi(x_i, y_i)) / n,
                (Delta(y_i, y) + offset(y) - offset(y_i)) / n].

Unlike the reference, whose spec methods take one example and are
``vmap``-ed, every method here takes a *batch*: the data pytree sliced
along its leading dimension (one example is a batch of one).  The same
oracle then serves the exact pass (one example) and the evaluation sweep
(all ``n`` examples in one call).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..core.types import SSVMProblem


class OracleSpec:
    """Declarative description of a structural-SVM task.

    Subclass and implement :meth:`dim`, :meth:`truth`, :meth:`decode`,
    :meth:`features` and :meth:`loss`; override :meth:`offset` when the
    score has fixed (weight-free) terms, and set ``clamp = True`` when the
    decoder is approximate.  ``batch`` leaves have a leading batch
    dimension ``B``.
    """

    clamp: bool = False

    def dim(self, data: Any) -> int:
        """Feature dimension ``d`` of the learned weight vector."""
        raise NotImplementedError

    def truth(self, batch: Any) -> Any:
        """The ground-truth labelings ``y_i`` of the batch."""
        raise NotImplementedError

    def decode(self, w: torch.Tensor, batch: Any) -> Any:
        """Loss-augmented argmax per example."""
        raise NotImplementedError

    def features(self, batch: Any, y: Any) -> torch.Tensor:
        """Joint feature maps ``psi(x, y)``: (B, d)."""
        raise NotImplementedError

    def loss(self, batch: Any, y: Any) -> torch.Tensor:
        """Task losses ``Delta(y_true, y)``: (B,)."""
        raise NotImplementedError

    def offset(self, batch: Any, y: Any) -> torch.Tensor:
        """Fixed (weight-free) score terms: (B,), default 0."""
        del y
        x = next(iter(batch.values()))
        return torch.zeros((x.shape[0],), dtype=torch.float32,
                           device=x.device)

    def meta(self, data: Any) -> Any:
        del data
        return None


def _leading_dim(data: Any) -> int:
    leaves = list(data.values())
    if not leaves:
        raise ValueError("data has no array leaves")
    n = int(leaves[0].shape[0])
    for leaf in leaves:
        if int(leaf.shape[0]) != n:
            raise ValueError("all data leaves must share the leading "
                             f"dimension n; got {leaf.shape[0]} != {n}")
    return n


def build_problem(spec: OracleSpec, data: Any,
                  meta: Optional[Any] = None) -> SSVMProblem:
    """Assemble an :class:`SSVMProblem` from a spec (``data``: dict of
    tensors sharing the leading dimension ``n``)."""
    n = _leading_dim(data)
    d = int(spec.dim(data))

    def oracle(w: torch.Tensor, batch: Any) -> torch.Tensor:
        y_hat = spec.decode(w, batch)
        y_true = spec.truth(batch)
        star = (spec.features(batch, y_hat)
                - spec.features(batch, y_true)) / n
        circ = (spec.loss(batch, y_hat) + spec.offset(batch, y_hat)
                - spec.offset(batch, y_true)) / n
        planes = torch.cat([star, circ[:, None].to(star.dtype)], dim=1)
        if spec.clamp:
            # An approximate decoder can return a plane worse than the
            # ground-truth (zero) plane; clamp it to zero so H~_i >= 0.
            score = planes[:, :-1] @ w + planes[:, -1]
            planes = torch.where(score[:, None] > 0.0, planes,
                                 torch.zeros_like(planes))
        return planes

    return SSVMProblem(n=n, d=d, data=data, oracle=oracle,
                       meta=meta if meta is not None else spec.meta(data),
                       spec=spec)
