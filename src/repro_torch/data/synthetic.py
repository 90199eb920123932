"""Synthetic structured data of the paper's three scenarios.

A numpy copy of ``repro/data/synthetic.py``: the same seed gives the same
arrays, so the two packages train on identical data.

  * ``usps_like``     -- multiclass, class-conditional Gaussians (App. A.1);
  * ``ocr_like``      -- chain labeling with banded Markov label transitions
                         and label-conditional Gaussians (App. A.2);
  * ``horseseg_like`` -- binary labeling of H x W lattices with the
                         checkerboard 2-colouring (App. A.3).

The problems are learnable but not separable.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def usps_like(n: int = 200, f: int = 64, num_classes: int = 10,
              noise: float = 1.5, seed: int = 0):
    """Multiclass data ``(x (n, f) f32, y (n,) i32)``."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(num_classes, f).astype(np.float32)
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    x = protos[y] + noise * rng.randn(n, f).astype(np.float32)
    return x.astype(np.float32), y


def ocr_like(n: int = 100, f: int = 32, num_labels: int = 26,
             mean_len: int = 8, max_len: int = 12, noise: float = 1.5,
             trans_strength: float = 1.0, seed: int = 0):
    """Chain data ``(X (n, max_len, f) f32, Y (n, max_len) i32,
    M (n, max_len) bool)`` with lengths ``clip(Poisson(mean_len), 3,
    max_len)``."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(num_labels, f).astype(np.float32)
    # A banded transition preference makes the pairwise weights matter.
    logits = trans_strength * np.exp(
        -0.5 * ((np.arange(num_labels)[:, None]
                 - np.arange(num_labels)[None, :]) % num_labels) ** 2)
    trans = logits / logits.sum(1, keepdims=True)
    X = np.zeros((n, max_len, f), np.float32)
    Y = np.zeros((n, max_len), np.int32)
    M = np.zeros((n, max_len), bool)
    for i in range(n):
        L = int(np.clip(rng.poisson(mean_len), 3, max_len))
        y = np.zeros(L, np.int32)
        y[0] = rng.randint(num_labels)
        for l in range(1, L):
            y[l] = rng.choice(num_labels, p=trans[y[l - 1]])
        X[i, :L] = protos[y] + noise * rng.randn(L, f)
        Y[i, :L] = y
        M[i, :L] = True
    return X, Y, M


def horseseg_like(n: int = 60, grid: Tuple[int, int] = (6, 6), f: int = 48,
                  noise: float = 1.5, seed: int = 0):
    """Binary labeling on H x W lattices: ``(features (n, L, f) f32, labels
    (n, L) i32, node_mask (n, L) bool, edges (n, E, 2) i32, edge_mask (n,
    E) bool, color (n, L) i32)`` with L = H*W and the checkerboard
    colouring of the red-black ICM oracle."""
    rng = np.random.RandomState(seed)
    H, W = grid
    L = H * W
    protos = rng.randn(2, f).astype(np.float32)
    edges = []
    for r in range(H):
        for c in range(W):
            v = r * W + c
            if c + 1 < W:
                edges.append((v, v + 1))
            if r + 1 < H:
                edges.append((v, v + W))
    edges = np.asarray(edges, np.int32)
    E = len(edges)
    color = np.asarray([(v // W + v % W) % 2 for v in range(L)], np.int32)

    X = np.zeros((n, L, f), np.float32)
    Y = np.zeros((n, L), np.int32)
    for i in range(n):
        # Smooth ground truth: a random half-plane on the grid.
        a, b, c0 = rng.randn(3)
        rr, cc = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        y = ((a * rr / H + b * cc / W + 0.3 * c0) > 0).astype(np.int32)
        y = y.reshape(-1)
        Y[i] = y
        X[i] = protos[y] + noise * rng.randn(L, f)
    M = np.ones((n, L), bool)
    EM = np.ones((n, E), bool)
    return (X, Y, M,
            np.broadcast_to(edges, (n, E, 2)).copy(),
            EM, np.broadcast_to(color, (n, L)).copy())
