"""Synthetic OCR-style chain data (the paper's App. A.2 scenario).

A numpy copy of ``repro/data/synthetic.py::ocr_like``: the same seed gives
the same arrays, so the two packages train on identical data.  Features
are drawn from label-conditional Gaussians with banded Markov label
transitions, so the problem is learnable but not separable.
"""
from __future__ import annotations

import numpy as np


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
