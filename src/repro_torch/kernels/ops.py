"""Device dispatch for the port's kernels.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain version in :mod:`.ref`.  The
choice rests on the tensor's device alone: there is no switch, and no
fallback from a failed build or launch.

Each kernel module keeps a plain integer launch counter (``launches``),
read and reset here, so a run can show that its main path went through
the kernels.

The reference's ``kernels/ops.py`` defines ``viterbi_step`` twice (lines
78 and 107).  Here the max-plus step exists once, as
:func:`.ref.viterbi_step_ref`, and the kernel layer exposes the
whole-sequence :func:`viterbi_decode`, which fuses the step with its scan.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import plane_scores as _ps
from . import ref
from . import viterbi as _vit

# The one invalid-slot score sentinel: loses every argmax, and is exactly
# representable in float32.
INVALID_SCORE = -1e30  # repro: allow[R001] the port's own sentinel home

_KERNELS = {"plane_scores": _ps, "viterbi_decode": _vit}


def plane_scores(planes: torch.Tensor, w: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """``scores[r] = <planes[r], w> + offsets[r]`` for ``(N, d)`` planes."""
    if planes.device.type == "cpu":
        return ref.plane_scores_ref(planes, w, offsets)
    return _ps.plane_scores(planes, w, offsets)


def viterbi_decode(unary: torch.Tensor, trans: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Batched masked Viterbi: ``(B, L, C)``, ``(C, C)``, ``(B, L)`` ->
    ``(B, L)`` int32 labels, each row ``chain.viterbi_decode``."""
    if unary.device.type == "cpu":
        return ref.viterbi_decode_ref(unary, trans, mask)
    return _vit.viterbi_decode(unary, trans, mask)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
