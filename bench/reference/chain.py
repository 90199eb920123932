"""Plain reference of the OCR chain oracle (arXiv:1408.6804 App. A.2).

A chain CRF over padded sequences: unary features ``sum_l onehot(y_l)
(x) x_l`` and pairwise transition indicators over valid adjacent pairs,
``d = C f + C^2``; the loss is the normalised Hamming distance.  The
max-oracle is loss-augmented Viterbi over each sequence's valid prefix
(first argmax on ties).  Planes follow paper eq. 5:
``phi^{iy} = [(psi(x_i, y) - psi(x_i, y_i)) / n, Delta(y_i, y) / n]``.
"""
from __future__ import annotations

import numpy as np

from .precision import matmul_for


class ChainOracle:
    """The oracle over ``arrays = {"x" (n, L, f) f32, "y" (n, L) int,
    "mask" (n, L) bool}`` (host arrays), products in ``precision``."""

    def __init__(self, arrays, cfg, precision: str = "float32"):
        self.x = np.ascontiguousarray(arrays["x"], np.float32)
        self.y = np.asarray(arrays["y"], np.int64)
        self.mask = np.asarray(arrays["mask"], bool)
        self.n, self.L, self.f = self.x.shape
        self.C = int(cfg["num_labels"])
        self.d = self.C * self.f + self.C * self.C
        self.mm = matmul_for(precision)
        self.lengths = np.maximum(self.mask.sum(1), 1)
        self.len32 = self.lengths.astype(np.float32)
        self.eye = np.eye(self.C, dtype=np.float32)

    def _split(self, w):
        C, f = self.C, self.f
        return w[:C * f].reshape(C, f), w[C * f:].reshape(C, C)

    def _unary(self, wu, i, Li):
        x = self.x[i, :Li]
        return (self.mm(x, wu.T)
                + (np.float32(1.0) - self.eye[self.y[i, :Li]])
                / self.len32[i])

    def _viterbi(self, u, wp):
        Li, C = u.shape
        m = u[0]
        backs = np.zeros((Li, C), np.int64)
        cols = np.arange(C)
        for l in range(1, Li):
            cand = m[:, None] + wp
            back = cand.argmax(0)
            m = cand[back, cols] + u[l]
            backs[l] = back
        lab = np.empty(Li, np.int64)
        lab[-1] = int(m.argmax())
        for l in range(Li - 1, 0, -1):
            lab[l - 1] = backs[l, lab[l]]
        return lab

    def _features(self, i, Li, lab):
        x = self.x[i, :Li]
        C = self.C
        unary = self.mm(self.eye[lab].T, x).reshape(-1)
        pair = np.bincount(lab[:-1] * C + lab[1:], minlength=C * C)
        return np.concatenate([unary, pair.astype(np.float32)])

    def decode(self, w, i):
        """The loss-augmented argmax of example ``i``'s valid prefix."""
        wu, wp = self._split(w)
        Li = int(self.lengths[i])
        return self._viterbi(self._unary(wu, i, Li), wp)

    def plane(self, w, i):
        """``phi^{i y_hat}`` at ``w``, (d+1,) float32."""
        Li = int(self.lengths[i])
        lab = self.decode(w, i)
        truth = self.y[i, :Li]
        star = ((self._features(i, Li, lab) - self._features(i, Li, truth))
                / np.float32(self.n))
        loss = np.float32(np.sum(lab != truth)) / self.len32[i]
        return np.concatenate([star, [loss / np.float32(self.n)]]
                              ).astype(np.float32)

    def hinges(self, w):
        """``H_i(w) = max_y <phi^{iy}, [w 1]>`` of every example, (n,)
        float64: a batched Viterbi over all chains, padded steps adding
        nothing."""
        wu, wp = self._split(np.asarray(w, np.float32))
        n, L, C = self.n, self.L, self.C
        u = (self.mm(self.x.reshape(n * L, self.f), wu.T).reshape(n, L, C)
             + (np.float32(1.0) - self.eye[self.y])
             / self.len32[:, None, None])
        u = np.where(self.mask[:, :, None], u, np.float32(0.0))
        m = u[:, 0]
        backs = np.zeros((n, L, C), np.int64)
        zero = np.zeros_like(wp)
        rows = np.arange(n)[:, None]
        cols = np.arange(C)[None, :]
        for l in range(1, L):
            t = np.where(self.mask[:, l, None, None], wp[None], zero[None])
            cand = m[:, :, None] + t
            back = cand.argmax(1)
            m = cand[rows, back, cols] + u[:, l]
            backs[:, l] = back
        lab = np.empty((n, L), np.int64)
        lab[:, -1] = m.argmax(1)
        for l in range(L - 1, 0, -1):
            lab[:, l - 1] = backs[np.arange(n), l, lab[:, l]]
        return self._scores(u, wp, lab) - self._scores(u, wp, self.y)

    def _scores(self, u, wp, lab):
        """Loss-augmented score of labelings ``lab`` over the valid
        positions, minus nothing: (n,) float64 over n."""
        n, L = lab.shape
        m = self.mask
        un = np.take_along_axis(u, lab[:, :, None], 2)[:, :, 0]
        pm = m[:, :-1] & m[:, 1:]
        pair = wp[lab[:, :-1], lab[:, 1:]] * pm
        s = (np.where(m, un, 0).astype(np.float64).sum(1)
             + pair.astype(np.float64).sum(1))
        return s / self.n


ORACLE = ChainOracle
