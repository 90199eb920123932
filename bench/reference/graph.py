"""Plain reference of the HorseSeg graph oracle (arXiv:1408.6804 App. A.3).

Binary labelling of a graph with learned unaries ``<w_c, x_l>`` and a
fixed attractive pairwise term ``-cut(y)``: ``d = 2 f``.  The oracle
maximises the loss-augmented score with red-black ICM (a warm start from
the unaries, then ``sweeps`` sweeps of colour 0 then colour 1), an
approximate decoder, so a plane scoring below the ground truth's (zero)
plane is replaced by the zero plane.  Planes follow paper eq. 5 with the
fixed term in the offset: ``[(psi(y) - psi(y_i)) / n, (Delta + cut(y_i) -
cut(y)) / n]``.
"""
from __future__ import annotations

import numpy as np

from .precision import matmul_for


class GraphOracle:
    """The oracle over ``arrays = {"x" (n, L, f) f32, "y", "mask", "edges"
    (n, E, 2), "edge_mask", "color"}`` (host arrays)."""

    def __init__(self, arrays, cfg, precision: str = "float32"):
        self.x = np.ascontiguousarray(arrays["x"], np.float32)
        self.y = np.asarray(arrays["y"], np.int64)
        self.mask = np.asarray(arrays["mask"], bool)
        self.edges = np.asarray(arrays["edges"], np.int64)
        self.em = np.asarray(arrays["edge_mask"], bool).astype(np.float32)
        self.color = np.asarray(arrays["color"], np.int64)
        self.n, self.L, self.f = self.x.shape
        self.d = 2 * self.f
        self.sweeps = int(cfg["sweeps"])
        self.mm = matmul_for(precision)
        self.len32 = np.maximum(self.mask.sum(1), 1).astype(np.float32)
        self.eye = np.eye(2, dtype=np.float32)
        self.nbr, self.nbw = self._neighbours()

    def _neighbours(self):
        """Each node's neighbours over the valid edges, both directions:
        flat node indices ``(n L, K)`` and 0/1 weights (0 pads to the
        largest degree K)."""
        n, L = self.n, self.L
        off = (np.arange(n) * L)[:, None]
        a = (self.edges[..., 0] + off).reshape(-1)
        b = (self.edges[..., 1] + off).reshape(-1)
        em = self.em.reshape(-1)
        src, dst = np.concatenate([a, b]), np.concatenate([b, a])
        wt = np.concatenate([em, em])
        order = np.argsort(src, kind="stable")
        src, dst, wt = src[order], dst[order], wt[order]
        counts = np.bincount(src, minlength=n * L)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(src.size) - first[src]
        K = max(int(counts.max()), 1)
        nbr = np.repeat(np.arange(n * L)[:, None], K, 1)
        nbw = np.zeros((n * L, K), np.float32)
        nbr[src, rank] = dst
        nbw[src, rank] = wt
        return nbr, nbw

    def _unary(self, w, x, y, mask, len32):
        """Loss-augmented unaries (..., L, 2), zero at masked nodes."""
        wc = w.reshape(2, self.f)
        u = (self.mm(x, wc.T) + (np.float32(1.0) - self.eye[y])
             / len32[..., None, None])
        return np.where(mask[..., None], u, np.float32(0.0))

    def _icm(self, udiff, nbr, nbw, color, mask):
        """Red-black ICM over flat nodes: ``nbr``/``nbw`` each node's
        neighbours (indices into the same flat nodes) and weights."""
        deg = nbw.sum(1, dtype=np.float32)
        lab = (udiff > 0) & mask
        upd = [(color == p) & mask for p in (0, 1)]
        for _ in range(self.sweeps):
            for p in (0, 1):
                nb1 = (lab[nbr] * nbw).sum(1, dtype=np.float32)
                diff = udiff - deg + np.float32(2.0) * nb1
                lab = np.where(upd[p], diff > 0, lab)
        return lab.astype(np.int64)

    def _cut(self, lab, a, b, em):
        return np.float32(np.sum(em * (lab[a] != lab[b])))

    def decode(self, w, i):
        u = self._unary(w, self.x[i], self.y[i], self.mask[i], self.len32[i])
        L = self.L
        nodes = slice(i * L, (i + 1) * L)
        return self._icm(u[:, 1] - u[:, 0], self.nbr[nodes] - i * L,
                         self.nbw[nodes], self.color[i], self.mask[i])

    def plane(self, w, i):
        """``phi^{i y_hat}`` at ``w``, clamped to the zero plane when it
        scores at most 0, (d+1,) float32."""
        lab = self.decode(w, i)
        truth, m = self.y[i], self.mask[i]
        x = self.x[i]
        mf = m.astype(np.float32)[:, None]
        feat = (self.mm((self.eye[lab] * mf).T, x).reshape(-1)
                - self.mm((self.eye[truth] * mf).T, x).reshape(-1))
        a, b, em = self.edges[i, :, 0], self.edges[i, :, 1], self.em[i]
        loss = np.float32(np.sum((lab != truth) & m)) / self.len32[i]
        circ = ((loss - self._cut(lab, a, b, em))
                + self._cut(truth, a, b, em)) / np.float32(self.n)
        plane = np.concatenate([feat / np.float32(self.n), [circ]]
                               ).astype(np.float32)
        score = self.mm(plane[:-1], w) + plane[-1]
        return plane if score > 0 else np.zeros_like(plane)

    def hinges(self, w):
        """``H_i(w)`` of every example after the clamp, (n,) float64: one
        batched ICM over all graphs laid end to end."""
        w = np.asarray(w, np.float32)
        n, L = self.n, self.L
        u = self._unary(w, self.x, self.y, self.mask, self.len32)
        lab = self._icm((u[..., 1] - u[..., 0]).reshape(-1), self.nbr,
                        self.nbw, self.color.reshape(-1),
                        self.mask.reshape(-1)).reshape(n, L)
        m = self.mask

        def score(y):
            un = np.take_along_axis(u, y[:, :, None], 2)[:, :, 0]
            s = np.where(m, un, 0).astype(np.float64).sum(1)
            cut = (self.em * (np.take_along_axis(y, self.edges[..., 0], 1)
                              != np.take_along_axis(y, self.edges[..., 1],
                                                    1))).sum(1)
            return s - cut
        return np.maximum(score(lab) - score(self.y), 0.0) / n


ORACLE = GraphOracle
