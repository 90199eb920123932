"""The launch plans of the port's B4 ``gram`` and B1 ``plane_scores``
kernels, computed on the host from the shape alone.

The kernels run only on a card (``tests/test_torch_gpu.py``); what they
are launched with is plain Python and is checked here: B4's split of each
output tile's K range over a cluster, and B1's rows per CTA.
"""
import pytest

from repro_torch.kernels import gram as t_gram
from repro_torch.kernels import plane_scores as t_ps

D_CASES = [1, 31, 32, 33, 127, 4004]
GRAM_SHAPES = [(n, d) for n in (1, 33, 64, 65, 128, 192, 384, 512, 1024,
                                2048, 4096) for d in D_CASES]


def _splits_up_to(d):
    steps = -(-d // t_gram.K_STEP)
    return [s for s in (1, 2, 4, 8, 16) if s <= max(1, steps)]


@pytest.mark.parametrize("d", D_CASES)
def test_gram_k_ranges_tile_d_in_whole_k_steps(d):
    """Every split the plan may pick cuts [0, d) into contiguous, non-empty
    ranges whose inner edges are whole K steps."""
    for split in _splits_up_to(d):
        ranges = t_gram.k_ranges(d, split)
        assert len(ranges) == split
        assert ranges[0][0] == 0 and ranges[-1][1] == d
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0
        for k0, k1 in ranges:
            assert k0 < k1 and k0 % t_gram.K_STEP == 0
            assert k1 == d or k1 % t_gram.K_STEP == 0


@pytest.mark.parametrize("n,d", GRAM_SHAPES)
def test_gram_plan_is_a_function_of_the_shape(n, d):
    """A power-of-two split of at most 16 CTAs, at most one per K step;
    more than one only where the tiles alone leave SMs idle; the same
    (n, d) always gives the same plan."""
    tile, split = t_gram.plan(n, d)
    assert (tile, split) == t_gram.plan(n, d)
    assert 1 <= split <= t_gram.MAX_SPLIT and split & (split - 1) == 0
    steps = -(-d // t_gram.K_STEP)
    assert split <= max(1, steps)
    tiles = (-(-n // tile)) * (-(-n // tile) + 1) // 2
    assert tile in t_gram.TILES
    if split > 1:
        assert tile == 32 and tiles * (split // 2) < t_gram.SMS
    if tile == 128:
        assert split == 1 and tiles >= t_gram.SMS


@pytest.mark.parametrize("n,d,want", [
    (4096, 4004, (128, 1)),   # the flattened 64-block working set
    (2048, 4004, (128, 1)),
    (1024, 127, (32, 1)),
    (512, 4004, (32, 1)),     # 136 32-tiles fill the card
    (64, 4004, (32, 16)),     # one cache block: 3 tiles, clusters of 16
    (65, 4004, (32, 16)),
    (192, 4004, (32, 8)),
    (256, 4004, (32, 4)),
    (384, 4004, (32, 2)),
    (64, 127, (32, 4)),       # four K steps
    (64, 33, (32, 2)),
    (64, 1, (32, 1)),
])
def test_gram_plan_picks(n, d, want):
    """The shapes of the card's tests pick every tile and every split, 1
    to 16."""
    assert t_gram.plan(n, d) == want


@pytest.mark.parametrize("n", [1, 7, 64, 65, 4096, 440_128])
def test_plane_scores_rows_per_cta_cover_n(n):
    """The CTAs cover the n rows once, one row per CTA while they fit on
    the card (a 64-row cache block spreads over 64 SMs), 8 per CTA for
    the flat multi-block calls."""
    rows, stages = t_ps.plan(n)
    assert rows in t_ps.ROWS_PER_CTA
    ctas = -(-n // rows)
    assert ctas * rows >= n > (ctas - 1) * rows
    assert ctas <= t_ps.SMS or rows == t_ps.ROWS_PER_CTA[-1]
    if n <= 2 * t_ps.SMS:
        assert rows <= 2 and stages == 4
    if n <= t_ps.SMS:
        assert rows == 1
    if n > 8 * t_ps.SMS:
        assert (rows, stages) == (8, 2)
    assert t_ps.plan(n) == (rows, stages)
