"""OCR-like chains (arXiv:1408.6804 App. A.2), made on the device.

The recipe of the port's ``data/synthetic.py::ocr_like``, vectorised over
the examples: ``num_labels`` Gaussian prototypes of width ``f``; lengths
``clip(Poisson(mean_len), 3, max_len)``; labels from a banded Markov chain
(``P(b | a)`` proportional to ``exp(-((a - b) mod C)^2 / 2)``) with a
uniform first label; features ``prototype[y_l] + noise * N(0, 1)`` at
valid positions and zero past each sequence's end.
"""
from __future__ import annotations

import torch


def generate(cfg, seed: int, device) -> dict:
    n, f, C = int(cfg["n"]), int(cfg["f"]), int(cfg["num_labels"])
    L, mean = int(cfg["max_len"]), float(cfg["mean_len"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    protos = torch.randn((C, f), generator=g, device=device)
    lab = torch.arange(C, device=device, dtype=torch.float32)
    logits = float(cfg["trans_strength"]) * torch.exp(
        -0.5 * torch.remainder(lab[:, None] - lab[None, :], C) ** 2)
    trans = logits / logits.sum(1, keepdim=True)
    lengths = torch.poisson(torch.full((n,), mean, device=device),
                            generator=g).clamp(3, L).long()
    y = torch.empty((n, L), dtype=torch.long, device=device)
    y[:, 0] = torch.randint(C, (n,), generator=g, device=device)
    for l in range(1, L):
        y[:, l] = torch.multinomial(trans[y[:, l - 1]], 1, generator=g)[:, 0]
    mask = torch.arange(L, device=device)[None, :] < lengths[:, None]
    noise = torch.randn((n, L, f), generator=g, device=device)
    x = (protos[y] + float(cfg["noise"]) * noise) * mask[:, :, None]
    return {"x": x.contiguous(), "y": (y * mask).to(torch.int32),
            "mask": mask}


def problem(arrays: dict, cfg):
    """The port's chain problem over ``arrays`` (on their device)."""
    from repro_torch.core.oracles import chain
    return chain.make_problem(arrays["x"], arrays["y"], arrays["mask"],
                              int(cfg["num_labels"]),
                              device=arrays["x"].device)


def stats(arrays: dict) -> dict:
    """What the counting functions read: the valid positions."""
    return {"positions": int(arrays["mask"].sum())}


def work(cfg, stats: dict) -> dict:
    """Per-example work of the chain oracle, for the counting functions:
    the valid positions' features and the labels and mask read; per valid
    position the unary scores (``2 f C``), a Viterbi step (``2 C^2``) and
    the two feature maps' sums (``2 f``)."""
    n, f, C = int(cfg["n"]), int(cfg["f"]), int(cfg["num_labels"])
    L = int(cfg["max_len"])
    per = stats["positions"] / n
    example = per * f * 4 + L * (4 + 1)
    return {"example_bytes": example, "data_bytes": n * example,
            "oracle_flops": per * (2 * f * C + 2 * C * C + 2 * f)}
