"""The yardstick's arithmetic: the card's peaks, the work an outer
iteration needs, and the device's busy time.

Peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W (the
card's power limit is printed beside every run).  The work is counted as
the on-chip guide says: every input byte read once, every output byte
written once, for these inputs (the planes a pass finds valid, the
positions a chain has), whatever a kernel reads again.  An SSVM iteration
is bound by bytes; the least time is the larger of the two bounds.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, data sheet
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
F32 = 4


def least_time(nbytes: float, flops: float) -> float:
    """Seconds the card needs at least for ``nbytes`` and ``flops``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def approx_pass_work(n: int, d: int, cap: int, planes: int
                     ) -> Tuple[float, float]:
    """Bytes and FLOPs of one plain approximate pass over ``n`` blocks
    holding ``planes`` valid cached planes of ``d + 1`` floats: each valid
    plane read once and scored (``2 (d + 1)``), each block's ``phi_i``
    row read and written, its validity and activity read and one stamp
    written, the permutation read, and the line search, update and
    averaging step per block (``10 (d + 1)``)."""
    row = (d + 1) * F32
    nbytes = (planes * row + 2 * n * row + n * cap * (1 + 4) + n * 4
              + n * 8)
    flops = 2.0 * (d + 1) * planes + 10.0 * (d + 1) * n
    return float(nbytes), float(flops)


def exact_step_work(d: int, example_bytes: float, oracle_flops: float,
                    cache: bool) -> Tuple[float, float]:
    """Bytes and FLOPs of one exact block step: the example read and the
    oracle's work, ``phi``, the block's ``phi_i`` row and the exact
    average each read and written, and, with a cache, the plane
    written."""
    row = (d + 1) * F32
    nbytes = example_bytes + 6 * row + (row if cache else 0)
    return float(nbytes), float(oracle_flops + 10.0 * (d + 1))


def evaluation_work(n: int, d: int, data_bytes: float, oracle_flops: float,
                    sweeps: int) -> Tuple[float, float]:
    """Bytes and FLOPs of ``sweeps`` evaluation sweeps: the data read once
    each, every example's oracle and its plane scored."""
    return (float(sweeps * (data_bytes + (d + 1) * F32)),
            float(sweeps * n * (oracle_flops + 2.0 * (d + 1))))


def iteration_least_time(n: int, d: int, cap: int, work: Dict,
                         planes: int, passes: int, cache: bool,
                         eval_sweeps: int) -> float:
    """Least time of one outer iteration: ``n`` exact steps, ``passes``
    approximate passes over ``planes`` valid planes each, and the
    evaluation; ``work`` is the configuration's per-example work
    (``example_bytes``, ``oracle_flops``, ``data_bytes``)."""
    eb, ef = exact_step_work(d, work["example_bytes"], work["oracle_flops"],
                             cache)
    ab, af = approx_pass_work(n, d, cap, planes)
    vb, vf = evaluation_work(n, d, work["data_bytes"], work["oracle_flops"],
                             eval_sweeps)
    return least_time(n * eb + passes * ab + vb, n * ef + passes * af + vf)


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals (any unit): time
    in which at least one of them ran, overlaps counted once."""
    return sum(e - s for s, e in merged(intervals))


def merged(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def gaps(busy: Sequence[Tuple[float, float]], start: float, end: float
         ) -> List[Tuple[float, float]]:
    """The idle ``(start, end)`` stretches of ``[start, end]`` outside the
    disjoint sorted ``busy`` intervals."""
    out, t = [], start
    for s, e in busy:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]
