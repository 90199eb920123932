"""The launch plans of the port's B4 ``gram``, B1 ``plane_scores``,
B2 ``plane_select``, ``approx_pass``, B3 ``viterbi`` and B5
``flash_attention`` kernels, computed on the host from the shape alone.

The kernels run only on a card (``tests/test_torch_gpu.py``); what they
are launched with is plain Python and is checked here: B4's split of each
output tile's K range over a cluster, B1's rows per CTA, B2's rows per
CTA, ring and shared memory, the rows ``approx_pass`` stages per buffer
and how far ahead, whether B3 stages a row in shared memory, and which
of B5's builds (head dims, mask, tile) a call runs.
"""
import pytest
import torch

from repro_torch.kernels import approx_pass as t_ap
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import gram as t_gram
from repro_torch.kernels import plane_scores as t_ps
from repro_torch.kernels import plane_select as t_psel
from repro_torch.kernels import viterbi as t_vit

SMEM = 232448   # shared memory a CTA may opt into on an H100

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


# B2 at the pipelined path (all 6877 OCR blocks, a 512-block fold window,
# a tau chunk of 64), single rows, and ragged counts around the plan's
# steps.
SELECT_K = [1, 2, 7, 63, 64, 257, 512, 527, 528, 1056, 4224, 6877, 16897,
            440_128]
SELECT_CAPS = [1, 7, 64, 4096]
SELECT_DS = [1, 127, 4004, 8193]


@pytest.mark.parametrize("k", SELECT_K)
def test_plane_select_plan_covers_every_row(k):
    """The CTAs' row groups cover the k rows once: a power of two of rows
    per CTA, at most MAX_ROWS, and more than one only while the grid
    keeps CTAS_PER_SM CTAs per SM."""
    how = t_psel.plan(k, 64, 4004)
    ctas = -(-k // how.rows)
    assert ctas * how.rows >= k > (ctas - 1) * how.rows
    assert how.rows & (how.rows - 1) == 0 and how.rows <= t_psel.MAX_ROWS
    if how.rows > 1:
        assert ctas >= t_psel.CTAS_PER_SM * t_psel.SMS
    if how.rows < t_psel.MAX_ROWS:
        assert -(-k // (2 * how.rows)) < t_psel.CTAS_PER_SM * t_psel.SMS


@pytest.mark.parametrize("d", SELECT_DS)
@pytest.mark.parametrize("cap", SELECT_CAPS)
@pytest.mark.parametrize("k", [1, 64, 6877])
def test_plane_select_plan_fits_shared_memory(k, cap, d):
    """Every plan fits the card's shared memory, its count is the layout's,
    and w is staged exactly when it fits beside the rest."""
    how = t_psel.plan(k, cap, d)
    assert how.smem_bytes <= SMEM == t_psel.SMEM_LIMIT
    assert how.smem_bytes == t_psel.smem_bytes(how.rows, how.chunk, d, cap,
                                               how.w_shared)
    with_w = t_psel.smem_bytes(how.rows, how.chunk, d, cap, True)
    assert how.w_shared == (with_w <= SMEM)


@pytest.mark.parametrize("d", [0, 1, 31, 32, 33, 4004, 4096, 4097, 8192,
                               8193, 12289, 100_000])
def test_plane_select_chunks_keep_the_lane_order(d):
    """A chunk is a multiple of 32 columns, so each lane keeps its columns
    l, l+32, ... across chunks; rows up to MAX_CHUNK go in one copy, wider
    ones in equal chunks of at most MAX_CHUNK."""
    chunk = t_psel.chunk_of(d)
    assert chunk % 32 == 0 and 32 <= chunk <= t_psel.MAX_CHUNK
    pieces = max(1, -(-d // chunk))
    if d <= t_psel.MAX_CHUNK:
        assert pieces == 1
    else:
        assert pieces == -(-d // t_psel.MAX_CHUNK)


@pytest.mark.parametrize("k,cap,d", [(6877, 64, 4004), (64, 64, 4004),
                                     (512, 64, 4004), (300, 4096, 8193),
                                     (1, 1, 1)])
def test_plane_select_plan_depends_on_the_shape_alone(k, cap, d):
    """The same shape gives the same plan, whatever the data; the path's
    shape takes 4 rows per CTA with w staged, a tau chunk one row."""
    assert t_psel.plan(k, cap, d) == t_psel.plan(k, cap, d)
    assert t_psel.plan(k, cap, d) == t_psel.plan(int(k), int(cap), int(d))
    if (k, cap, d) == (6877, 64, 4004):
        assert t_psel.plan(k, cap, d).rows == 4
        assert t_psel.plan(k, cap, d).w_shared
    if k == 64:
        assert t_psel.plan(k, cap, d).rows == 1


@pytest.mark.parametrize("k,cap,d,what", [
    (64, 0, 4004, "cap="), (64, t_psel.MAX_CAP + 1, 1, "cap="),
    (64, 1 << 16, 1, "cap="), (64, t_psel.MAX_CAP, 4004, "shared memory"),
    (64, 64, -1, "d="), (64, 64, 2 ** 31, "d=")])
def test_plane_select_plan_refuses_what_it_cannot_hold(k, cap, d, what):
    with pytest.raises(ValueError, match=what):
        t_psel.plan(k, cap, d)


def test_plane_select_max_cap_is_the_most_one_row_holds():
    """MAX_CAP slots fit one row per CTA at the smallest width; one more
    does not."""
    assert t_psel.plan(1, t_psel.MAX_CAP, 1).smem_bytes <= SMEM
    assert t_psel.smem_bytes(1, 32, 1, t_psel.MAX_CAP + 1, False) > SMEM


# The shapes the paths launch approx_pass at: full-size OCR (d = 4004,
# cap = 64), the SSVM head on OLMoE features (d = 10265, cap = 16) and the
# card tests' small one; each plain (0) and with 10 Gram steps.
PASS_SHAPES = [(d, cap, steps) for d, cap in ((4004, 64), (10265, 16),
                                              (7, 5))
               for steps in (0, 10)]


@pytest.mark.parametrize("d,cap,steps", PASS_SHAPES)
def test_approx_pass_plan_fits_and_prefetches_on_the_paths(d, cap, steps):
    """Every path's shape fits the card's shared memory with two buffers
    (the next block staged while this one computes) and at least one
    staged row; the plan depends on the shape alone."""
    how = t_ap.plan(d, cap, steps)
    assert how == t_ap.plan(d, cap, steps)
    assert how.smem_bytes <= SMEM
    assert how.distance == 1 and 1 <= how.rows <= cap


@pytest.mark.parametrize("d,cap,steps,rows", [
    (4004, 64, 0, 5), (4004, 64, 10, 4), (10265, 16, 0, 1),
    (10265, 16, 10, 1), (7, 5, 0, 5), (7, 5, 10, 5)])
def test_approx_pass_plan_stages_as_many_rows_as_fit(d, cap, steps, rows):
    """The rows per buffer are the most that fit: one more does not."""
    how = t_ap.plan(d, cap, steps)
    assert how.rows == rows
    if rows < cap:
        more = t_ap._words(d + 1, cap, steps, rows + 1, how.distance + 1)
        assert 4 * more > SMEM


def _taken_before(d, cap, steps):
    """The kernel before staging kept w, phi, the average and, in the
    Sec-3.5 mode, phi_i and the Gram leaf in shared memory."""
    d1 = d + 1
    words = 3 * d1 + 4 * cap + 68 + (d1 + cap * cap if steps else 0)
    return 4 * words <= SMEM


TAKEN_BEFORE = [(d, cap, steps)
                for d in (1, 7, 127, 4004, 10265, 15000, 19000, 19344)
                for cap in (1, 5, 16, 64, 128) for steps in (0, 10)
                if _taken_before(d, cap, steps)]


@pytest.mark.parametrize("d,cap,steps", TAKEN_BEFORE)
def test_approx_pass_plan_takes_every_shape_the_single_buffer_kernel_took(
        d, cap, steps):
    """Each shape the kernel took before staging still has a plan; one
    that stages a row prefetches it a block ahead."""
    d1 = d + 1
    how = t_ap.plan(d, cap, steps)
    assert how.smem_bytes <= SMEM and 0 <= how.rows <= cap
    if 4 * t_ap._words(d1, cap, steps, 1, 2) <= SMEM:
        assert how.distance == 1 and how.rows >= 1


@pytest.mark.parametrize("steps", [0, 10])
@pytest.mark.parametrize("d,cap", [(60000, 4), (60000, 64), (30000, 1)])
def test_approx_pass_plan_refuses_what_shared_memory_cannot_hold(d, cap,
                                                                  steps):
    """Shapes whose layout outgrows shared memory are not staged: they
    take the wide plan (phi and the average in device memory), which
    stages nothing."""
    assert 4 * t_ap._words(d + 1, cap, steps, 0, 1) > SMEM
    assert t_ap.plan(d, cap, steps) == t_ap.Plan(0, 0, t_ap.WIDE_SMEM,
                                                 wide=True)


@pytest.mark.parametrize("d", [20480, 25000])
def test_approx_pass_plan_refuses_more_of_phi_than_a_thread_holds(d):
    """Past 40 elements of phi per thread (d + 1 > 20480) there is no
    staged build, though one buffer would fit: the wide plan runs it."""
    assert 4 * t_ap._words(d + 1, 1, 0, 0, 1) <= SMEM
    how = t_ap.plan(d, 1, 0)
    assert how.wide and how.rows == 0 and how.smem_bytes <= SMEM


def _plan_before(d, cap, steps):
    """The plan before the wide plan existed (None where it raised): the
    staged kernel's, which every shape it took keeps."""
    d1 = d + 1
    for nbuf in (2, 1):
        base = 4 * t_ap._words(d1, cap, steps, 0, nbuf)
        if base <= SMEM:
            if d1 > t_ap.MAX_D1:
                return None
            rows = min(cap, (SMEM - base) // (4 * nbuf * t_ap._slot(d1)))
            return t_ap.Plan(rows, nbuf - 1,
                             4 * t_ap._words(d1, cap, steps, rows, nbuf))
    return None


# Every shape this file checked before the wide plan, and a sweep around
# the edges of what the staged kernel holds.
BEFORE = sorted(set(
    PASS_SHAPES + TAKEN_BEFORE
    + [(d, cap, steps) for d in (1, 7, 4004, 10265, 19347, 19400, 20479)
       for cap in (1, 4, 16, 64, 128, 200, 236, 237, 1000, 3800, 3900)
       for steps in (0, 10)]))


@pytest.mark.parametrize("d,cap,steps", BEFORE)
def test_approx_pass_plan_is_unchanged_where_the_staged_kernel_ran(d, cap,
                                                                   steps):
    before = _plan_before(d, cap, steps)
    how = t_ap.plan(d, cap, steps)
    if before is None:
        assert how.wide
    else:
        assert how == before and not how.wide


# ROADMAP C6: the widths of the SSVM head over Minitron-8B (20,505),
# Mistral-NeMo-12B and Qwen2.5-14B (25,625), and d = 60,000; the caps past
# what shared memory holds in either mode.
@pytest.mark.parametrize("steps", [0, 10])
@pytest.mark.parametrize("d", [20479, 20505, 25625, 60000])
@pytest.mark.parametrize("cap", [1, 16, 64])
def test_approx_pass_plan_takes_the_wide_widths(d, cap, steps):
    how = t_ap.plan(d, cap, steps)
    assert how.wide == (d + 1 > t_ap.MAX_D1)
    assert how.smem_bytes <= SMEM


@pytest.mark.parametrize("d", [7, 4004])
@pytest.mark.parametrize("cap,steps", [(4096, 0), (8192, 0), (237, 10),
                                       (238, 10), (256, 10), (512, 10)])
def test_approx_pass_plan_takes_the_wide_caps(d, cap, steps):
    """Plain caps in the thousands and Sec-3.5 caps past 236: the wide
    plan, whose scratch grows with the cap and whose shared memory does
    not."""
    how = t_ap.plan(d, cap, steps)
    assert how.wide
    assert how.smem_bytes == t_ap.WIDE_SMEM
    assert t_ap.wide_scratch_words(cap) == 7 * cap + 1


@pytest.mark.parametrize("d,cap,steps", [(0, 4, 0), (7, 0, 0), (7, 4, -1)])
def test_approx_pass_plan_refuses_only_empty_shapes(d, cap, steps):
    with pytest.raises(ValueError, match="no plan"):
        t_ap.plan(d, cap, steps)


@pytest.mark.parametrize("algo", ["mpbcfw", "mpbcfw-avg", "mpbcfw-gram",
                                  "mpbcfw-async"])
def test_solver_refuses_a_refused_plan_when_it_is_built(monkeypatch, algo):
    """The engines take the pass's plan in init_state, so a shape the
    kernel refuses fails when the Solver is built (before any pass), and
    engines without approximate passes do not ask."""
    from repro_torch.api import RunConfig, Solver, UnsupportedConfigError
    from repro_torch.core.oracles import chain
    from repro_torch.data import synthetic
    X, Y, M = synthetic.ocr_like(n=6, f=4, num_labels=3, mean_len=3,
                                 max_len=4, seed=0)
    problem = chain.make_problem(X, Y, M, 3, device="cpu")
    asked = []

    def refuse(d, cap, steps=0):
        asked.append((d, cap, steps))
        raise ValueError("no room")
    monkeypatch.setattr(t_ap, "plan", refuse)
    with pytest.raises(UnsupportedConfigError, match="no room"):
        Solver(problem, RunConfig(lam=0.1, algo=algo, cap=5))
    assert asked == [(problem.d, 5, 10 if algo == "mpbcfw-gram" else 0)]
    Solver(problem, RunConfig(lam=0.1, algo="bcfw", cap=5))
    assert len(asked) == 1


# B3 at the paths' shapes (OCR rows of 14 steps over 26 labels, the SSVM
# head's 32 steps) and at the most labels one block takes (109).
VITERBI_SHAPES = ([(14, 26)] + [(32, c) for c in (5, 26, 64, 109)]
                  + [(L, 109) for L in (1, 14, 32, 211, 212, 1000)])


@pytest.mark.parametrize("L,C", VITERBI_SHAPES)
def test_viterbi_plan_stages_what_fits(L, C):
    """Staged exactly when the table and two score rows (at least 64
    words), the unaries, the back pointers and the mask bytes fit; either
    way within the card's shared memory, and a function of (L, C)
    alone."""
    how = t_vit.plan(L, C)
    assert how == t_vit.plan(L, C)
    assert how.smem_bytes <= SMEM
    table = max(C * C + 2 * C, 64)
    staged = 4 * (table + L * C + (L - 1) * C) + 4 * (-(-L // 4))
    assert how.staged == (staged <= SMEM)
    assert how.smem_bytes == (staged if how.staged else 4 * table)
    if L <= 32:
        assert how.staged


# -- B5 flash_attention: one build per head-dim pair and mask ----------------

@pytest.mark.parametrize("mask", ["causal", "window", "bidirectional"])
@pytest.mark.parametrize("D", [16, 32, 64, 100, 112, 128])
@pytest.mark.parametrize("S", [1, 20, 32, 33, 1024, 1500, 8192])
def test_flash_attention_plan_keys_the_build_by_mask(mask, D, S):
    p = t_fa.plan(D, D, S, torch.bfloat16, mask)
    assert p["mask"] == mask and p["path"] == "mma"
    assert p["dq"] == p["dv"] == (32 if D <= 32 else 64 if D <= 64 else 128)
    assert p["build"] == f"bf16-{p['dq']}x{p['dv']}-{mask}"
    short = S <= 32 and mask == "causal"
    assert (p["warps"], p["bk"], p["rows"]) == ((2, 32, 32) if short
                                                else (4, 64, 64))
    assert p["smem"] <= SMEM
    f = t_fa.plan(D, D, S, torch.float32, mask)
    assert (f["path"], f["build"], f["rows"]) == (
        "fma", f"f32-{mask}", 32 if short else 64)


def test_flash_attention_head_dim_112_takes_the_padded_128_build():
    p = t_fa.plan(112, 112, 1024, torch.bfloat16, "window")
    assert (p["dq"], p["dv"], p["build"]) == (128, 128, "bf16-128x128-window")
    assert p["smem"] == 2 * (64 * 136 + 2 * 64 * (136 + 136))


def test_flash_attention_mla_build_is_causal_only():
    assert t_fa.plan(192, 128, 1024, torch.bfloat16)["build"] == \
        "bf16-192x128-causal"
    for mask in ("window", "bidirectional"):
        with pytest.raises(ValueError, match="causal only"):
            t_fa.plan(192, 128, 1024, torch.bfloat16, mask)
    with pytest.raises(ValueError, match="mask"):
        t_fa.plan(64, 64, 10, torch.bfloat16, "sliding")


@pytest.mark.parametrize("window,causal,mask", [
    (0, True, "causal"), (1, True, "window"), (4096, True, "window"),
    (0, False, "bidirectional")])
def test_flash_attention_mask_of_a_call(window, causal, mask):
    assert t_fa.mask_of(window, causal) == mask


def test_flash_attention_mask_of_refuses_a_window_without_causality():
    with pytest.raises(ValueError, match="a window is causal"):
        t_fa.mask_of(3, False)
    with pytest.raises(ValueError, match="< 0"):
        t_fa.mask_of(-1)


# -- B5's bf16-score builds: a build of its own per bf16 build -------------

@pytest.mark.parametrize("mask", ["causal", "window"])
@pytest.mark.parametrize("D", [16, 64, 112, 128])
@pytest.mark.parametrize("S", [20, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_bf16_scores_key_a_build_of_their_own(mask, D, S,
                                                              dtype):
    # float32 inputs run the bf16 build, cast: the plan is bf16's.
    p = t_fa.plan(D, D, S, dtype, mask, "bf16")
    base = t_fa.plan(D, D, S, torch.bfloat16, mask)
    assert p["build"] == base["build"] + "-s16"
    assert p["score_dtype"] == "bf16" and base["score_dtype"] == "f32"
    assert {k: v for k, v in p.items() if k not in ("build", "score_dtype")
            } == {k: v for k, v in base.items()
                  if k not in ("build", "score_dtype")}


def test_flash_attention_bf16_scores_keys():
    assert t_fa.plan(128, 128, 1024, torch.bfloat16, "causal", "bf16")[
        "build"] == "bf16-128x128-causal-s16"
    assert t_fa.plan(112, 112, 8192, torch.float32, "window", "bf16")[
        "build"] == "bf16-128x128-window-s16"
    assert t_fa.plan(192, 128, 1024, torch.bfloat16, "causal", "bf16")[
        "build"] == "bf16-192x128-causal-s16"


def test_flash_attention_bf16_scores_refuse_what_no_build_takes():
    with pytest.raises(ValueError, match="causal or windowed"):
        t_fa.plan(64, 64, 100, torch.bfloat16, "bidirectional", "bf16")
    with pytest.raises(ValueError, match="causal only"):
        t_fa.plan(192, 128, 1024, torch.bfloat16, "window", "bf16")
    with pytest.raises(ValueError, match="score dtype"):
        t_fa.plan(64, 64, 100, torch.bfloat16, "causal", "f16")
