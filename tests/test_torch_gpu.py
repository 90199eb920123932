"""The port's CUDA kernels against their plain versions, on a card.

Every test here is ``gpu``-marked and skips without a CUDA device.  The
file imports neither ``jax`` nor ``repro``, so it runs on a GPU host that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports jax.)  Scores compare at
rtol = atol = 3e-5, labels must be equal.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.api import CostModel, RunConfig, Solver
from repro_torch.core.mpbcfw import eager_pass
from repro_torch.core.oracles import chain
from repro_torch.data.synthetic import ocr_like
from repro_torch.kernels import ops, ref
from repro_torch.kernels import plane_select as t_psel
from repro_torch.kernels import viterbi as t_vit

pytestmark = pytest.mark.gpu
TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,d", [(1, 1), (7, 127), (64, 4004), (65, 4004),
                                 (4096, 127)])
def test_plane_scores_kernel_matches_plain(cuda, n, d):
    r = np.random.RandomState(n + d)
    block = torch.from_numpy(r.randn(n, d + 1).astype(np.float32)).to(cuda)
    w = torch.from_numpy(r.randn(d).astype(np.float32)).to(cuda)
    before = ops.launch_counts()["plane_scores"]
    got = ops.plane_scores(block[:, :-1], w, block[:, -1])
    assert ops.launch_counts()["plane_scores"] == before + 1
    want = ref.plane_scores_ref(block[:, :-1].cpu(), w.cpu(),
                                block[:, -1].cpu())
    assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)


def test_plane_scores_kernel_scores_equal_rows_equally(cuda):
    r = np.random.RandomState(3)
    block = torch.from_numpy(r.randn(64, 4005).astype(np.float32))
    block[[5, 17, 40]] = block[2].clone()
    block = block.to(cuda)
    w = torch.from_numpy(r.randn(4004).astype(np.float32)).to(cuda)
    got = ops.plane_scores(block[:, :-1], w, block[:, -1]).cpu()
    assert (got[[5, 17, 40]] == got[2]).all()


@pytest.mark.parametrize("n", [1, 7, 64, 65, 4096])
@pytest.mark.parametrize("d", [1, 127, 4004])
def test_plane_scores_kernel_equals_plane_select_bit_for_bit(cuda, n, d):
    """B1 and B2 reduce a row in one order: B1's scores of strided rows
    equal B2's for the same rows, each its own one-slot cache row."""
    r = np.random.RandomState(n + 3 * d)
    block = torch.from_numpy(r.randn(n, d + 1).astype(np.float32)).to(cuda)
    w = torch.from_numpy(r.randn(d).astype(np.float32)).to(cuda)
    scores = ops.plane_scores(block[:, :-1], w, block[:, -1])
    stack = block[:, None, :]
    best, idx = ops.plane_select(
        stack[..., :-1], w, stack[..., -1],
        torch.ones((n, 1), dtype=torch.bool, device=cuda))
    assert torch.equal(idx, torch.zeros_like(idx))
    assert torch.equal(scores, best)


@pytest.mark.parametrize("n,d", [(64, 4004), (4096, 127), (7, 1)])
def test_plane_scores_kernel_replayed_from_a_graph_equals_eager(cuda, n, d):
    """The launch is capturable (as in the gram exact step's graph): a
    replay writes the eager launch's bits, and reads its inputs anew."""
    r = np.random.RandomState(n + d)
    block = torch.from_numpy(r.randn(n, d + 1).astype(np.float32)).to(cuda)
    w = torch.from_numpy(r.randn(d).astype(np.float32)).to(cuda)
    eager = ops.plane_scores(block[:, :-1], w, block[:, -1])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.plane_scores(block[:, :-1], w, block[:, -1])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    w.mul_(-1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ops.plane_scores(block[:, :-1], w,
                                             block[:, -1]))


def test_kernel_launchers_refuse_plans_they_do_not_have(cuda):
    """A launch with a tile, split, row count or ring depth the kernels do
    not build returns an error, which the wrappers raise; nothing runs
    another way."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import gram as t_gram
    from repro_torch.kernels import plane_scores as t_ps
    P = torch.zeros((64, 64), device=cuda)
    G = torch.empty((64, 64), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    lib = t_gram._lib()
    for tile, split in ((64, 1), (16, 1), (32, 3), (32, 32), (128, 0)):
        with pytest.raises(RuntimeError, match="cudaError"):
            _build.check(lib.gram_launch(P.data_ptr(), 64, G.data_ptr(), 64,
                                         64, tile, split, stream), "gram")
    lib = t_ps._lib()
    out = torch.empty((64,), device=cuda)
    for rows, stages in ((3, 4), (4, 4), (1, 3)):
        with pytest.raises(RuntimeError, match="cudaError"):
            _build.check(lib.plane_scores_launch(
                P.data_ptr(), 64, P.data_ptr(), P.data_ptr(), 1,
                out.data_ptr(), 64, 64, rows, stages, stream),
                "plane_scores")


def _select_case(n, cap, d, seed):
    """A (n, cap, d+1) stack with mixed validity, empty rows and duplicate
    planes, and a permutation of its rows."""
    r = np.random.RandomState(seed)
    # Unit-scale scores: the absolute part of TOL means the same at every d.
    stack = (r.randn(n, cap, d + 1) / np.sqrt(d)).astype(np.float32)
    valid = r.rand(n, cap) < 0.4
    valid[::7] = False
    if cap > 3:
        stack[::2, 3] = stack[::2, 1]
        valid[::2, 1] = valid[::2, 3] = True
    w = r.randn(d).astype(np.float32)
    rows = r.permutation(n)
    return (torch.from_numpy(stack), torch.from_numpy(valid),
            torch.from_numpy(w), torch.from_numpy(rows))


@pytest.mark.parametrize("n,cap,d", [(1, 1, 1), (9, 7, 127), (300, 64, 4004),
                                     (40, 200, 33)])
@pytest.mark.parametrize("permuted", [False, True])
def test_plane_select_kernel_matches_plain(cuda, n, cap, d, permuted):
    stack, valid, w, rows = _select_case(n, cap, d, n + cap + d)
    rows = rows if permuted else None
    gstack = stack.to(cuda)
    before = ops.launch_counts()["plane_select"]
    best, idx = ops.plane_select(
        gstack[..., :-1], w.to(cuda), gstack[..., -1], valid.to(cuda),
        rows=None if rows is None else rows.to(cuda))
    assert ops.launch_counts()["plane_select"] == before + 1
    want_best, want_idx = ref.plane_select_ref(stack[..., :-1], w,
                                               stack[..., -1], valid, rows)
    assert torch.equal(idx.cpu(), want_idx)
    assert_allclose(best.cpu().numpy(), want_best.numpy(), **TOL)
    sel = valid if rows is None else valid[rows]
    empty = ~sel.any(dim=1)
    assert (best.cpu()[empty] == ops.INVALID_SCORE).all()


def test_plane_select_kernel_ties_and_two_step_agree(cuda):
    """Duplicate planes tie bit for bit, the first copy wins, and the fused
    scores equal the plane_scores kernel's."""
    stack, valid, w, _ = _select_case(64, 64, 4004, 5)
    stack, valid, w = stack.to(cuda), valid.to(cuda), w.to(cuda)
    best, idx = ops.plane_select(stack[..., :-1], w, stack[..., -1], valid)
    flat = stack.reshape(64 * 64, 4005)
    scores = ops.plane_scores(flat[:, :-1], w, flat[:, -1]).reshape(64, 64)
    scores = torch.where(valid, scores, torch.full_like(scores,
                                                        ops.INVALID_SCORE))
    assert torch.equal(best, scores.amax(dim=1))
    assert torch.equal(idx.long(), scores.argmax(dim=1))


def test_plane_select_kernel_refuses_what_it_cannot_hold(cuda):
    planes = torch.zeros((2, t_psel.MAX_CAP + 1, 4), device=cuda)
    with pytest.raises(ValueError, match="cap="):
        ops.plane_select(planes[..., :-1], torch.zeros(3, device=cuda),
                         planes[..., -1],
                         torch.ones(planes.shape[:2], dtype=torch.bool,
                                    device=cuda))
    planes = torch.zeros((4, 3, 5), device=cuda)
    args = (planes[..., :-1], torch.zeros(4, device=cuda), planes[..., -1],
            torch.ones((4, 3), dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="rows"):
        ops.plane_select(*args, rows=torch.arange(8, device=cuda)[::2])
    with pytest.raises(ValueError, match="int64"):
        ops.plane_select(*args, rows=torch.arange(4, device=cuda,
                                                  dtype=torch.int32))
    best, idx = ops.plane_select(*args, rows=torch.tensor([1, 4, -1],
                                                          device=cuda))
    assert torch.isnan(best[1:]).all() and idx.tolist() == [0, -1, -1]


SELECT_DENSITIES = [0.0, 1.0 / 64, 0.3, 1.0]


@pytest.fixture(scope="module")
def ocr_cache():
    """The full-size (6877, 64, 4004) cache of unit-scale planes, rows of
    4005 floats read in place, with duplicate planes in slots 10 and 40 of
    every fifth row; w and a generator for the masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    n, cap, d = 6877, 64, 4004
    stack = torch.randn((n, cap, d + 1), generator=gen, device="cuda") \
        / np.sqrt(d)
    stack[1::5, 40] = stack[1::5, 10]
    w = torch.randn((d,), generator=gen, device="cuda")
    yield stack, w, gen
    del stack
    torch.cuda.empty_cache()


def _select_mask(gen, n, cap, density):
    valid = torch.rand((n, cap), generator=gen, device="cuda") < density
    if 0.0 < density < 1.0:
        valid[::11] = False                       # rows with no valid slot
        if cap > 40:
            valid[1::5, 10] = valid[1::5, 40] = True   # tied duplicates
    return valid


def _select_against_plain_and_b1(stack, w, valid, rows):
    """B2 on the card against the plain version (idx equal, best within
    TOL) and against B1's scores of the same planes, bit for bit.  The
    plain version's matrix-vector product does not always round equal
    rows equally (seen at d = 8193): where it picks slot 40 of a row
    whose valid slot 10 holds the same plane, the first copy, slot 10, is
    what it means."""
    P, b = stack[..., :-1], stack[..., -1]
    best, idx = ops.plane_select(P, w, b, valid, rows=rows)
    want_best, want_idx = ref.plane_select_ref(P, w, b, valid, rows)
    if stack.shape[1] > 40:
        twin = (want_idx == 40) & valid[rows, 10] & (
            stack[rows, 10] == stack[rows, 40]).all(dim=1)
        want_idx = torch.where(twin, torch.full_like(want_idx, 10), want_idx)
    assert torch.equal(idx, want_idx)
    assert_allclose(best.cpu().numpy(), want_best.cpu().numpy(), **TOL)
    n, cap, d = P.shape
    scores = ops.plane_scores(P.reshape(n * cap, d), w,
                              b.reshape(n * cap)).reshape(n, cap)
    masked = torch.where(valid, scores, torch.full_like(
        scores, ops.INVALID_SCORE))[rows]
    assert torch.equal(best, masked.amax(dim=1))
    assert torch.equal(idx.long(), masked.argmax(dim=1))
    return best, idx


@pytest.mark.parametrize("density", SELECT_DENSITIES)
@pytest.mark.parametrize("k", [1, 8, 64, 257, 6877])
def test_plane_select_kernel_at_every_density_and_k(cuda, ocr_cache,
                                                     density, k):
    """The full-size cache through ``rows``: k rows of a permutation (the
    first ones again at the end, so rows repeat), at the path's density
    (1/64), none, 0.3 and all valid."""
    stack, w, gen = ocr_cache
    n, cap = stack.shape[:2]
    valid = _select_mask(gen, n, cap, density)
    perm = torch.randperm(n, generator=gen, device="cuda")
    rows = torch.cat([perm[:k - k // 8], perm[:k // 8]])
    best, idx = _select_against_plain_and_b1(stack, w, valid, rows)
    if density == 0.0:
        assert (best == ops.INVALID_SCORE).all() and (idx == 0).all()


@pytest.mark.parametrize("d", [1, 31, 33, 127, 4004, 8193])
@pytest.mark.parametrize("density", SELECT_DENSITIES)
def test_plane_select_kernel_at_every_width(cuda, d, density):
    """257 rows of a (300, 64, d) cache, with repeats, at every width: one
    column, less than a warp, just over, a ragged 127, the path's 4004
    and 8193 (staged in three chunks of 2752 columns)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(d)
    n, cap = 300, 64
    stack = torch.randn((n, cap, d + 1), generator=gen, device="cuda") \
        / np.sqrt(d)
    stack[1::5, 40] = stack[1::5, 10]
    w = torch.randn((d,), generator=gen, device="cuda")
    valid = _select_mask(gen, n, cap, density)
    rows = torch.randint(0, n, (257,), generator=gen, device="cuda")
    _select_against_plain_and_b1(stack, w, valid, rows)


def test_plane_select_kernel_ties_to_the_lower_slot_at_every_density(
        cuda, ocr_cache):
    """Duplicate planes in slots 10 and 40 of every fifth row, both valid:
    the lower slot wins wherever they are the best."""
    stack, w, gen = ocr_cache
    n, cap = stack.shape[:2]
    for density in SELECT_DENSITIES[1:]:
        valid = _select_mask(gen, n, cap, density)
        valid[1::5, 10] = valid[1::5, 40] = True
        P, b = stack[..., :-1], stack[..., -1]
        # w pointing along slot 10's plane makes it the best of its row.
        rows = torch.arange(1, n, 5, device=cuda)
        w10 = stack[1, 10, :-1].contiguous()
        best, idx = ops.plane_select(P, w10, b, valid, rows=rows)
        assert idx[0] == 10
        assert not (idx == 40).any()


def test_plane_select_kernel_rows_outside_give_nan(cuda, ocr_cache):
    """Row indices outside [0, n) give (NaN, -1); the rows around them
    are scored as without them."""
    stack, w, gen = ocr_cache
    n, cap = stack.shape[:2]
    valid = _select_mask(gen, n, cap, 1.0 / 64)
    P, b = stack[..., :-1], stack[..., -1]
    inside = torch.randint(0, n, (40,), generator=gen, device="cuda")
    rows = inside.clone()
    rows[[0, 9, 10, 39]] = torch.tensor([-1, n, -5, n + 7], device=cuda)
    best, idx = ops.plane_select(P, w, b, valid, rows=rows)
    want_best, want_idx = ops.plane_select(P, w, b, valid, rows=inside)
    out = torch.zeros(40, dtype=torch.bool, device=cuda)
    out[[0, 9, 10, 39]] = True
    assert torch.isnan(best[out]).all() and (idx[out] == -1).all()
    assert torch.equal(best[~out], want_best[~out])
    assert torch.equal(idx[~out], want_idx[~out])


@pytest.mark.parametrize("density", [1.0 / 64, 1.0])
def test_plane_select_kernel_relaunches_give_the_same_bits(cuda, ocr_cache,
                                                           density):
    stack, w, gen = ocr_cache
    n, cap = stack.shape[:2]
    valid = _select_mask(gen, n, cap, density)
    P, b = stack[..., :-1], stack[..., -1]
    rows = torch.randperm(n, generator=gen, device="cuda")
    best, idx = ops.plane_select(P, w, b, valid, rows=rows)
    for _ in range(50):
        again = ops.plane_select(P, w, b, valid, rows=rows)
        assert torch.equal(again[0], best) and torch.equal(again[1], idx)


@pytest.mark.parametrize("k", [64, 6877])
def test_plane_select_kernel_replayed_from_a_graph_equals_eager(
        cuda, ocr_cache, k):
    """The launch is capturable: a replay writes the eager launch's bits,
    and reads its inputs anew."""
    stack, w, gen = ocr_cache
    n, cap = stack.shape[:2]
    valid = _select_mask(gen, n, cap, 1.0 / 64)
    P, b = stack[..., :-1], stack[..., -1]
    rows = torch.randperm(n, generator=gen, device="cuda")[:k]
    eager = ops.plane_select(P, w, b, valid, rows=rows)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.plane_select(P, w, b, valid, rows=rows)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])
    w2 = w.clone()
    w.mul_(-1.0)
    graph.replay()
    torch.cuda.synchronize()
    again = ops.plane_select(P, w, b, valid, rows=rows)
    w.copy_(w2)
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])


@pytest.mark.parametrize("d", [0, 1, 31, 4004, 4096, 4097, 8193, 20000])
@pytest.mark.parametrize("cap", [1, 7, 64, 4096])
def test_plane_select_plan_matches_the_kernels_layout(cuda, d, cap):
    """The wrapper's shared-memory count is the kernel's own, for the
    picked plan and with w moved to the other place."""
    lib = t_psel._lib()
    try:
        how = t_psel.plan(6877, cap, d)
    except ValueError:
        return
    for w_shared in (how.w_shared, not how.w_shared):
        assert t_psel.smem_bytes(how.rows, how.chunk, d, cap, w_shared) == \
            lib.plane_select_smem_bytes(how.rows, how.chunk, d, cap,
                                        int(w_shared))


def test_plane_select_launcher_refuses_plans_it_does_not_have(cuda):
    """Rows per CTA or chunks the kernel does not take, or more shared
    memory than a CTA gets, return an error and launch nothing."""
    lib = t_psel._lib()
    planes = torch.zeros((4, 3, 5), device=cuda)
    w = torch.zeros(4, device=cuda)
    valid = torch.ones((4, 3), dtype=torch.bool, device=cuda)
    best = torch.full((4,), 7.0, device=cuda)
    idx = torch.full((4,), 7, dtype=torch.int32, device=cuda)

    def launch(rows_per_cta, chunk, cap=3):
        return lib.plane_select_launch(
            planes.data_ptr(), 15, 5, w.data_ptr(), planes.data_ptr() + 16,
            15, 5, valid.data_ptr(), 3, 1, None, 4, 4, cap, 4, 0.0,
            best.data_ptr(), idx.data_ptr(), rows_per_cta, chunk, 1,
            torch.cuda.current_stream().cuda_stream)
    for rows_per_cta, chunk in ((0, 32), (t_psel.MAX_ROWS + 1, 32), (1, 48),
                                (1, 0)):
        assert launch(rows_per_cta, chunk) != 0
    assert launch(32, 32, cap=t_psel.MAX_CAP) != 0
    torch.cuda.synchronize()
    assert (best == 7.0).all() and (idx == 7).all()
    assert launch(1, 32) == 0
    torch.cuda.synchronize()
    assert (idx == 0).all()


def _viterbi_args(B, L, C, seed, tie):
    r = np.random.RandomState(seed)
    if tie:
        unary = r.randint(-2, 3, (B, L, C)).astype(np.float32)
        trans = r.randint(-2, 3, (C, C)).astype(np.float32)
    else:
        unary = r.randn(B, L, C).astype(np.float32)
        trans = r.randn(C, C).astype(np.float32)
    lens = r.randint(1, L + 1, size=B)
    mask = np.arange(L)[None, :] < lens[:, None]
    mask[:, 0] = True
    return [torch.from_numpy(a) for a in (unary, trans, mask)]


@pytest.mark.parametrize("B,L,C,seed,tie", [
    (1, 1, 4, 0, False), (1, 14, 26, 1, False), (1, 14, 26, 2, True),
    (6877, 14, 26, 3, False), (513, 14, 26, 4, True), (9, 8, 109, 5, True),
    (1, 32, 109, 6, True), (7, 32, 109, 7, False), (5, 211, 109, 8, True),
    (3, 212, 109, 9, True), (1, 2000, 26, 10, False), (2, 1200, 5, 11, True),
    (4, 1098, 26, 12, True), (4, 1099, 26, 13, True)])
def test_viterbi_kernel_matches_plain(cuda, B, L, C, seed, tie):
    """Labels equal the plain version's on both plans: staged (the row in
    shared memory) and scratch (back pointers in device memory), at the
    edge between them too, ties included."""
    args = _viterbi_args(B, L, C, seed, tie)
    got = ops.viterbi_decode(*(a.to(cuda) for a in args))
    assert torch.equal(got.cpu(), ref.viterbi_decode_ref(*args))


@pytest.mark.parametrize("L,C,staged", [(14, 26, True), (32, 109, True),
                                        (2000, 26, False),
                                        (300, 109, False)])
def test_viterbi_kernel_replayed_from_a_graph_equals_eager(cuda, L, C,
                                                           staged):
    """B = 1 as the captured exact step runs it: a graph replay of the
    decode gives the eager launch's labels, on either plan."""
    args = [a.to(cuda) for a in _viterbi_args(1, L, C, L + C, True)]
    want = ops.viterbi_decode(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.viterbi_decode(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ops.viterbi_decode(*args)
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert t_vit.plan(L, C).staged == staged


@pytest.mark.parametrize("L,C", [(14, 26), (32, 109), (1, 4), (1098, 26),
                                 (1099, 26), (300, 109)])
def test_viterbi_plan_matches_the_kernels_layout(cuda, L, C):
    """The host plan's shared-memory bytes are the kernel's own layout."""
    how = t_vit.plan(L, C)
    lib = t_vit._lib()
    assert lib.viterbi_smem_bytes(L, C, int(how.staged)) == how.smem_bytes


def test_viterbi_kernel_refuses_what_it_cannot_hold(cuda):
    C = t_vit.MAX_LABELS + 1
    with pytest.raises(ValueError, match="labels exceed"):
        ops.viterbi_decode(torch.zeros((1, 3, C), device=cuda),
                           torch.zeros((C, C), device=cuda),
                           torch.ones((1, 3), dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.viterbi_decode(torch.zeros((1, 5, 3), device=cuda)[:, ::2],
                           torch.zeros((3, 3), device=cuda),
                           torch.ones((1, 3), dtype=torch.bool, device=cuda))


def test_solver_on_card_matches_cpu_run(cuda):
    X, Y, M = ocr_like(n=24, f=8, num_labels=5, mean_len=6, max_len=8,
                       seed=1)
    traces = []
    for dev in (cuda, "cpu"):
        cfg = RunConfig(lam=1 / 24, max_iters=3, cap=8, approx_batch=4,
                        max_approx_passes=6, cost_model=CostModel(0.3, 1e-3))
        traces.append(Solver(chain.make_problem(X, Y, M, 5, device=dev),
                             cfg).run().trace)
    for g, c in zip(*traces):
        assert (g.n_exact, g.n_approx, g.approx_passes) == (
            c.n_exact, c.n_approx, c.approx_passes)
        assert_allclose(g.dual, c.dual, rtol=1e-4)
        assert_allclose(g.primal, c.primal, rtol=1e-4)


def test_async_solver_on_card_matches_cpu_run(cuda):
    """mpbcfw-async with the side-stream oracle and a straggler mask."""
    X, Y, M = ocr_like(n=24, f=8, num_labels=5, mean_len=6, max_len=8,
                       seed=1)
    traces = []
    for dev in (cuda, "cpu"):
        cfg = RunConfig(lam=1 / 24, algo="mpbcfw-async", max_iters=4, cap=8,
                        approx_batch=4, max_approx_passes=6,
                        cost_model=CostModel(0.3, 1e-3))
        solver = Solver(chain.make_problem(X, Y, M, 5, device=dev), cfg)
        solver.engine.outcome_fn = (
            lambda it, k: np.random.RandomState(it).rand(k) > 0.3)
        traces.append(solver.run().trace)
    for g, c in zip(*traces):
        assert (g.n_exact, g.n_approx, g.approx_passes) == (
            c.n_exact, c.n_approx, c.approx_passes)
        assert_allclose(g.dual, c.dual, rtol=1e-4)
        assert_allclose(g.primal, c.primal, rtol=1e-4)
        assert_allclose(g.oracle_overlap, c.oracle_overlap, rtol=1e-6)


# -- the gram kernel and the mpbcfw-gram path ---------------------------------

# Every tile and split the plan picks: 32-tiles split over 1, 2, 4, 8 and
# 16 CTAs (n <= 512), and 128-tiles at n = 4096.
GRAM_CASES = ([(1, 1, False), (4, 32, False), (33, 200, False),
               (65, 127, True), (130, 33, True)]
              + [(n, d, True) for n in (1, 33, 64, 65, 128, 4096)
                 for d in (1, 127, 4004)]
              + [(192, 4004, True), (384, 4004, True), (512, 4004, True),
                 (64, 33, True), (1024, 127, True)])


@pytest.mark.parametrize("n,d,strided", GRAM_CASES)
def test_gram_kernel_matches_plain(cuda, n, d, strided):
    """Ragged n and d, every launch plan, and row-strided views read in
    place: entries within 3e-5 |p_a| |p_b| + 3e-4 of the plain product,
    G == G^T exactly, and a second launch gives the same bits."""
    from repro_torch.kernels import gram as t_gram
    r = np.random.RandomState(n + d)
    buf = torch.from_numpy(r.randn(n, d + 1 if strided else d).astype(
        np.float32)).to(cuda)
    P = buf[:, :d]
    before = ops.launch_counts()["gram"]
    got = ops.gram(P)
    assert ops.launch_counts()["gram"] == before + 1
    assert torch.equal(got, got.T), t_gram.plan(n, d)
    assert torch.equal(got, ops.gram(P))
    want = ref.gram_ref(P.cpu())
    norms = want.diagonal().sqrt()
    allow = 3e-5 * norms[:, None] * norms[None, :] + 3e-4
    assert bool(((got.cpu() - want).abs() <= allow).all()), t_gram.plan(n, d)


def test_gram_kernel_refuses_what_it_cannot_hold(cuda):
    from repro_torch.kernels import gram as t_gram
    with pytest.raises(ValueError, match="unit-stride"):
        t_gram.gram(torch.zeros((4, 8), device=cuda).T)
    with pytest.raises(ValueError, match="float32"):
        t_gram.gram(torch.zeros((4, 8), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        t_gram.gram(torch.zeros((4, 8)))


def test_gram_solver_on_card_matches_cpu_run(cuda):
    X, Y, M = ocr_like(n=24, f=8, num_labels=5, mean_len=6, max_len=8,
                       seed=1)
    traces = []
    for dev in (cuda, "cpu"):
        cfg = RunConfig(lam=1 / 24, algo="mpbcfw-gram", max_iters=3, cap=8,
                        approx_batch=4, max_approx_passes=6,
                        cost_model=CostModel(0.3, 1e-3))
        traces.append(Solver(chain.make_problem(X, Y, M, 5, device=dev),
                             cfg).run().trace)
    for g, c in zip(*traces):
        assert (g.n_exact, g.n_approx, g.approx_passes) == (
            c.n_exact, c.n_approx, c.approx_passes)
        assert_allclose(g.dual, c.dual, rtol=1e-4)
        assert_allclose(g.primal, c.primal, rtol=1e-4)


# -- the approximate pass kernel (approx_pass) --------------------------------

def _pass_state(n, cap, d, steps, seed, cuda):
    """A synthetic cache (unit-scale scores, empty blocks, duplicate
    planes), phi_i = half of slot 0, phi their sum."""
    r = np.random.RandomState(seed)
    planes = r.randn(n, cap, d + 1).astype(np.float32) / np.sqrt(d)
    valid = r.rand(n, cap) < 2.0 / cap
    valid[:, 0] |= r.rand(n) < 0.8
    valid[::17] = False
    if cap > 10:
        planes[1::5, cap - 1] = planes[1::5, 3]
        valid[1::5, 3] = valid[1::5, cap - 1] = True
    phi_i = 0.5 * planes[:, 0]
    arrays = dict(planes=planes, valid=valid, phi_i=phi_i, phi=phi_i.sum(0),
                  bar=0.1 * r.randn(d + 1),
                  last=np.zeros((n, cap), np.int32))
    t = {k: torch.from_numpy(np.ascontiguousarray(
        v.astype(np.float32) if v.dtype == np.float64 else v)).to(cuda)
        for k, v in arrays.items()}
    gram = (torch.bmm(t["planes"][..., :-1],
                      t["planes"][..., :-1].transpose(1, 2))
            if steps else None)
    perm = torch.from_numpy(r.permutation(n)).to(cuda)
    return t, gram, perm


def _run_pass(fn, st, planes, valid, gram, perm, steps, go=None):
    fn(st["phi"], st["phi_i"], st["bar"], planes, valid, st["last"], perm,
       lam=1.0 / 6877, k0=7000, outer_it=5, gram=gram, steps=steps, go=go)


@pytest.mark.parametrize("steps", [None, 10])
@pytest.mark.parametrize("n,cap,d", [(512, 64, 4004), (40, 16, 10265),
                                     (33, 5, 7)])
def test_approx_pass_kernel_matches_plain(cuda, n, cap, d, steps):
    """One pass, kernel vs the eager loop on the card: activity stamps
    equal, phi, phi_i and the average within rtol = atol = 3e-5."""
    t, gram, perm = _pass_state(n, cap, d, steps, n + cap, cuda)
    keys = ("phi", "phi_i", "bar", "last")
    got = {k: t[k].clone() for k in keys}
    want = {k: t[k].clone() for k in keys}
    before = ops.launch_counts()["approx_pass"]
    _run_pass(ops.approx_pass, got, t["planes"], t["valid"], gram, perm,
              steps)
    assert ops.launch_counts()["approx_pass"] == before + 1
    _run_pass(eager_pass, want, t["planes"], t["valid"], gram, perm, steps)
    assert torch.equal(got["last"], want["last"])
    for k in ("phi", "phi_i", "bar"):
        assert_allclose(got[k].cpu().numpy(), want[k].cpu().numpy(), **TOL)


@pytest.mark.parametrize("steps", [None, 10])
@pytest.mark.parametrize("n,cap,d", [(512, 64, 4004), (33, 5, 7)])
def test_approx_pass_kernel_is_deterministic(cuda, n, cap, d, steps):
    """50 launches from the same state give the same bits: every
    block-wide read of a row ends before the row is rewritten."""
    t, gram, perm = _pass_state(n, cap, d, steps, n + cap, cuda)
    keys = ("phi", "phi_i", "bar", "last")
    first = None
    for _ in range(50):
        st = {k: t[k].clone() for k in keys}
        _run_pass(ops.approx_pass, st, t["planes"], t["valid"], gram, perm,
                  steps)
        if first is None:
            first = st
        for k in keys:
            assert torch.equal(st[k], first[k]), k


@pytest.mark.parametrize("steps", [None, 10])
def test_approx_pass_kernel_gated_off_changes_nothing(cuda, steps):
    t, gram, perm = _pass_state(64, 8, 100, steps, 3, cuda)
    st = {k: t[k].clone() for k in ("phi", "phi_i", "bar", "last")}
    _run_pass(ops.approx_pass, st, t["planes"], t["valid"], gram, perm,
              steps, go=torch.zeros((), dtype=torch.bool, device=cuda))
    for k in st:
        assert torch.equal(st[k], t[k]), k


@pytest.mark.parametrize("algo", ["mpbcfw", "mpbcfw-gram"])
def test_approx_pass_run_all_batch_matches_plain_passes(cuda, algo):
    """A trained SMALL ocr state: a 4-pass run_all batch of gated kernel
    launches against 4 eager passes, duals within rtol 1e-4."""
    from repro_torch.configs.paper import SMALL
    from repro_torch.core import mpbcfw
    from repro_torch.core.ssvm import dual_value
    sc = SMALL["ocr"]
    X, Y, M = ocr_like(n=sc.n, f=sc.f, num_labels=sc.num_classes,
                       mean_len=sc.mean_len, max_len=sc.max_len, seed=0)
    solver = Solver(chain.make_problem(X, Y, M, sc.num_classes, device=cuda),
                    RunConfig(lam=1 / sc.n, algo=algo, max_iters=2, cap=16,
                              approx_batch=4, max_approx_passes=6,
                              cost_model=CostModel(0.3, 1e-4)))
    solver.run()
    mp, lam = solver.state, solver.cfg.lam
    steps = solver.cfg.gram_steps if algo == "mpbcfw-gram" else None
    perms = np.stack([np.random.RandomState(s).permutation(sc.n)
                      for s in range(4)])
    c = mp.cache
    plain = {k: v.clone() for k, v in dict(
        phi=mp.inner.phi, phi_i=mp.inner.phi_i, bar=mp.avg.bar_approx,
        last=c.last_active).items()}
    want = []
    for k, p in enumerate(perms):
        mpbcfw.eager_pass(plain["phi"], plain["phi_i"], plain["bar"],
                          c.planes, c.valid, plain["last"],
                          torch.from_numpy(p).to(cuda), lam=lam,
                          k0=mp.avg.k_approx + k * sc.n,
                          outer_it=mp.outer_it, gram=c.gram, steps=steps)
        want.append(float(dual_value(plain["phi"], lam)))
    clock = mpbcfw.make_slope_clock(0.0, 0.0, 1.0, 1e-4, cuda)
    _, _, st = mpbcfw.multi_approx_pass(mp, perms, clock, lam=lam,
                                        steps=steps, run_all=True)
    got = st.duals.cpu().numpy()
    assert int(st.passes_run) == 4
    assert_allclose(got, want, rtol=1e-4)
    assert_allclose(mp.inner.phi.cpu().numpy(), plain["phi"].cpu().numpy(),
                    rtol=1e-4, atol=1e-6)


def test_approx_pass_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels import approx_pass as t_ap
    t, gram, perm = _pass_state(8, 4, 16, None, 1, cuda)
    st = {k: t[k].clone() for k in ("phi", "phi_i", "bar", "last")}
    with pytest.raises(ValueError, match="int64"):
        _run_pass(t_ap.approx_pass, st, t["planes"], t["valid"], None,
                  perm.int(), None)
    with pytest.raises(ValueError, match="Gram leaf"):
        _run_pass(t_ap.approx_pass, st, t["planes"], t["valid"], None, perm,
                  10)
    with pytest.raises(ValueError, match="one-element flag"):
        _run_pass(t_ap.approx_pass, st, t["planes"], t["valid"], None, perm,
                  None, go=torch.ones(2, dtype=torch.bool, device=cuda))


def _kernel_vs_eager(t, gram, perm, steps):
    """One pass from state ``t`` over ``perm``: the kernel against the
    eager loop, stamps equal, phi, phi_i and the average within TOL."""
    keys = ("phi", "phi_i", "bar", "last")
    got = {k: t[k].clone() for k in keys}
    want = {k: t[k].clone() for k in keys}
    _run_pass(ops.approx_pass, got, t["planes"], t["valid"], gram, perm,
              steps)
    _run_pass(eager_pass, want, t["planes"], t["valid"], gram, perm, steps)
    assert torch.equal(got["last"], want["last"])
    for k in ("phi", "phi_i", "bar"):
        assert_allclose(got[k].cpu().numpy(), want[k].cpu().numpy(), **TOL)


@pytest.mark.parametrize("steps", [None, 10])
@pytest.mark.parametrize("n,cap,d", [(96, 64, 4004), (24, 16, 10265),
                                     (33, 5, 7)])
def test_approx_pass_kernel_streams_rows_past_the_staged_ones(cuda, n, cap,
                                                              d, steps):
    """Blocks with every slot valid hold more valid planes than the plan
    stages (5 or 4 rows at d = 4004, 1 at d = 10265): the rest stream from
    device memory in the same lane order."""
    from repro_torch.kernels import approx_pass as t_ap
    t, gram, perm = _pass_state(n, cap, d, steps, 7 * n + cap, cuda)
    t["valid"][::3] = True
    t["valid"][1::6, : cap // 2] = True
    if d > 7:
        assert t_ap.plan(d, cap, steps or 0).rows < cap
    _kernel_vs_eager(t, gram, perm, steps)


@pytest.mark.parametrize("steps", [None, 10])
@pytest.mark.parametrize("n,cap,d", [(64, 64, 4004), (16, 16, 10265),
                                     (9, 5, 7)])
def test_approx_pass_kernel_with_blocks_repeated_close_together(cuda, n, cap,
                                                                d, steps):
    """A perm that repeats blocks at distance 1, 2 and 3, three in a row,
    and alternating pairs (no path sends one, the kernel must stay right):
    a repeat inside the prefetch distance reads the rewritten phi_i row."""
    t, gram, _ = _pass_state(n, cap, d, steps, 11 * n + cap, cuda)
    t["valid"][2] = True          # a repeated block past the staged rows
    order = [2, 2, 5, 2, 7, 7, 7, 1, 3, 1, 3, 4, 0, 6, 4, 8, 8, 2, 6, 5, 5]
    perm = torch.tensor(order + list(range(n)), device=cuda)
    _kernel_vs_eager(t, gram, perm, steps)


@pytest.mark.parametrize("steps", [None, 10])
@pytest.mark.parametrize("n,cap,d", [(512, 64, 4004), (40, 16, 10265)])
def test_approx_pass_kernel_over_part_of_the_blocks(cuda, n, cap, d, steps):
    """n_perm < n: a pass over a third of the blocks leaves the rest."""
    t, gram, perm = _pass_state(n, cap, d, steps, 13 * n + cap, cuda)
    _kernel_vs_eager(t, gram, perm[: n // 3].contiguous(), steps)


@pytest.mark.parametrize("steps", [None, 10])
@pytest.mark.parametrize("n,cap,d", [(128, 64, 4004), (33, 5, 7)])
def test_approx_pass_kernel_with_runs_of_empty_blocks(cuda, n, cap, d,
                                                      steps):
    """Blocks with no valid plane, alone and in runs (the zero plane in
    the plain mode, only the average moves in the Sec-3.5 mode)."""
    t, gram, perm = _pass_state(n, cap, d, steps, 17 * n + cap, cuda)
    empty = perm[: n // 2]
    t["valid"][empty] = False
    t["valid"][perm[n // 2 + 1]] = False
    _kernel_vs_eager(t, gram, perm, steps)


@pytest.mark.parametrize("steps", [None, 10])
@pytest.mark.parametrize("n,cap,d", [(12, 1, 19400), (12, 1, 19347),
                                     (10, 4, 15000), (12, 8, 7000)])
def test_approx_pass_kernel_on_one_buffer_and_every_build(cuda, n, cap, d,
                                                          steps):
    """The widest shapes: one buffer where two do not fit (staged just
    before its block, distance 0; at d = 19347 with 10 steps one staged
    row, plain two buffers of phi_i alone) and the builds holding 16, 24
    and 40 elements of phi per thread; with a repeated block."""
    from repro_torch.kernels import approx_pass as t_ap
    how = t_ap.plan(d, cap, steps or 0)
    if d == 19400:
        assert how.distance == 0
    t, gram, perm = _pass_state(n, cap, d, steps, 19 * n + cap, cuda)
    t["valid"][perm[0]] = True
    perm = torch.cat([perm[:1], perm[:1], perm]).contiguous()
    _kernel_vs_eager(t, gram, perm, steps)


@pytest.mark.parametrize("d,cap,steps", [(4004, 64, 0), (4004, 64, 10),
                                         (10265, 16, 0), (10265, 16, 10),
                                         (7, 5, 0), (7, 5, 10),
                                         (19347, 1, 0), (15000, 4, 10)])
def test_approx_pass_plan_matches_the_kernels_layout(cuda, d, cap, steps):
    """The host plan's shared-memory bytes are the kernel's own layout."""
    from repro_torch.kernels import approx_pass as t_ap
    how = t_ap.plan(d, cap, steps)
    lib = t_ap._lib()
    assert lib.approx_pass_smem_bytes(d, cap, steps, how.rows,
                                      how.distance + 1) == how.smem_bytes


# The wide plan (ROADMAP C6): the SSVM head's widths over Minitron-8B
# (20,505) and Mistral-NeMo-12B / Qwen2.5-14B (25,625), d = 60,000, plain
# caps in the thousands and Sec-3.5 caps past 256.
WIDE_CASES = [(12, 16, 20505, None), (12, 16, 20505, 10),
              (12, 16, 25625, None), (12, 16, 25625, 10),
              (4, 4, 60000, None), (4, 4, 60000, 10),
              (6, 4096, 7, None), (3, 4096, 4004, None),
              (12, 512, 7, 10), (6, 512, 4004, 10)]


@pytest.mark.parametrize("n,cap,d,steps", WIDE_CASES)
def test_approx_pass_wide_plan_matches_plain(cuda, n, cap, d, steps):
    """Shapes past the staged kernel, on the wide plan: one pass against
    the eager loop, stamps equal, phi, phi_i and the average within TOL;
    blocks with every slot valid and a repeated block included."""
    from repro_torch.kernels import approx_pass as t_ap
    assert t_ap.plan(d, cap, steps or 0).wide
    t, gram, perm = _pass_state(n, cap, d, steps, 23 * n + cap, cuda)
    t["valid"][perm[1]] = True
    t["valid"][perm[2], : min(cap, 300)] = True
    perm = torch.cat([perm[:1], perm[:1], perm]).contiguous()
    before = ops.launch_counts()["approx_pass"]
    _kernel_vs_eager(t, gram, perm, steps)
    assert ops.launch_counts()["approx_pass"] == before + 1


@pytest.mark.parametrize("steps", [None, 10])
def test_approx_pass_wide_plan_is_deterministic_and_gated(cuda, steps):
    """Ten launches from one state give the same bits; a false flag
    changes nothing."""
    t, gram, perm = _pass_state(16, 16, 25625, steps, 29, cuda)
    keys = ("phi", "phi_i", "bar", "last")
    first = None
    for _ in range(10):
        st = {k: t[k].clone() for k in keys}
        _run_pass(ops.approx_pass, st, t["planes"], t["valid"], gram, perm,
                  steps)
        first = first or st
        for k in keys:
            assert torch.equal(st[k], first[k]), k
    st = {k: t[k].clone() for k in keys}
    _run_pass(ops.approx_pass, st, t["planes"], t["valid"], gram, perm,
              steps, go=torch.zeros((), dtype=torch.bool, device=cuda))
    for k in keys:
        assert torch.equal(st[k], t[k]), k


def test_approx_pass_wide_plan_matches_the_kernels_layout(cuda):
    from repro_torch.kernels import approx_pass as t_ap
    lib = t_ap._lib()
    assert lib.approx_pass_wide_smem_bytes() == t_ap.WIDE_SMEM
    for cap in (1, 16, 4096, 8192):
        assert lib.approx_pass_wide_scratch_words(cap) == \
            t_ap.wide_scratch_words(cap)


# -- the LM kernels (moe_ffn, flash_attention) --------------------------------

def _lm(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        device=device, dtype=dtype)


def _moe_case(E, C, D, F, seed):
    r = np.random.RandomState(seed)
    return [r.randn(E, C, D), 0.1 * r.randn(E, D, F), 0.1 * r.randn(E, D, F),
            0.1 * r.randn(E, F, D)]


def _close_to_emulation(got, want):
    """bf16 kernel vs its roundings emulated in fp32: the intermediate it
    rounds to bf16 (h, or p) is summed in another order, so ~0.1 % of it
    rounds to the neighbouring bf16 value and moves its output row by
    ulp(h) |wd|: relative L2 <= 2^-9, each value within 4 bf16 ulps of
    the row scale."""
    got, want = got.float().cpu(), want.float().cpu()
    assert _rel_l2(got, want) <= 2.0 ** -9
    rms = float(want.pow(2).mean().sqrt())
    assert bool(((got - want).abs() <= 2.0 ** -5 * (want.abs() + rms)).all())


def _rel_l2(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).norm() / want.norm())


# The tensor-core pair (bf16 with D and F multiples of 8: ragged C, D and F
# tiles, the decode shape's single row) and the fp32-FMA path (float32, and
# bf16 with D or F not a multiple of 8) at 8 and 32 rows.
MOE_SHAPES = [(2, 8, 64, 32), (3, 130, 128, 300), (64, 1, 256, 128),
              (2, 40, 64, 2000), (5, 3, 96, 72), (2, 70, 100, 4000),
              (3, 200, 64, 128)]


@pytest.mark.parametrize("E,C,D,F", MOE_SHAPES)
def test_moe_ffn_kernel_matches_plain_in_f32(cuda, E, C, D, F):
    args = _moe_case(E, C, D, F, E + C + F)
    before = ops.launch_counts()["moe_ffn"]
    got = ops.moe_ffn(*(_lm(a, torch.float32, cuda) for a in args))
    assert ops.launch_counts()["moe_ffn"] == before + 1
    want = ref.moe_ffn_ref(*(_lm(a, torch.float32, "cpu") for a in args))
    assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("E,C,D,F", MOE_SHAPES)
def test_moe_ffn_kernel_rounds_as_the_tpu_kernel_in_bf16(cuda, E, C, D, F):
    """fp32 g and u, h rounded to bf16, fp32 sums of h wd, y in bf16."""
    args = [_lm(a, torch.bfloat16, cuda)
            for a in _moe_case(E, C, D, F, E * C + F)]
    got = ops.moe_ffn(*args)
    assert got.dtype == torch.bfloat16
    xs, wg, wu, wd = (a.float() for a in args)
    g, u = torch.bmm(xs, wg), torch.bmm(xs, wu)
    h = (torch.nn.functional.silu(g) * u).bfloat16().float()
    _close_to_emulation(got, torch.bmm(h, wd).bfloat16())
    assert _rel_l2(got, ref.moe_ffn_ref(*args)) <= 2e-2


def _attn_case(shape, kv_heads, seed, dtype, device):
    r = np.random.RandomState(seed)
    q = r.randn(*shape)
    kv_shape = shape if len(shape) == 3 else shape[:2] + (kv_heads,
                                                          shape[3])
    k, v = r.randn(*kv_shape), r.randn(*kv_shape)
    return [_lm(a, dtype, device) for a in (q, k, v)]


# 64-row blocks (S > 32) and 32-row blocks (S <= 32), (BH, S, D) and
# (B, S, H, D) with grouped kv heads.
ATTN_CASES = [((1, 64, 32), 0), ((2, 200, 64), 0), ((4, 128, 128), 0),
              ((2, 200, 4, 128), 4), ((3, 77, 8, 64), 2), ((2, 33, 14, 64), 2),
              ((1, 1, 2, 16), 1), ((2, 32, 4, 128), 2), ((3, 20, 2, 64), 1)]


@pytest.mark.parametrize("shape,kv_heads", ATTN_CASES)
def test_flash_attention_kernel_matches_plain_in_f32(cuda, shape, kv_heads):
    q, k, v = _attn_case(shape, kv_heads, sum(shape), torch.float32, "cpu")
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda))
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.shape == q.shape
    assert_allclose(got.cpu().numpy(), ref.flash_attention_ref(q, k, v)
                    .numpy(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("shape,kv_heads", ATTN_CASES)
def test_flash_attention_kernel_in_bf16(cuda, shape, kv_heads):
    q, k, v = _attn_case(shape, kv_heads, 1 + sum(shape), torch.bfloat16,
                         cuda)
    got = ops.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got, ref.flash_attention_ref(q, k, v)) <= 2e-2


def test_flash_attention_kernel_rounds_p_as_the_tpu_kernel(cuda):
    """One k block (S <= 64): p = exp(s - rowmax) rounded to bf16 before
    p.v, the unrounded sum as the normaliser."""
    q, k, v = _attn_case((3, 64, 4, 128), 4, 9, torch.bfloat16, cuda)
    got = ops.flash_attention(q, k, v)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) / 128 ** 0.5
    s = s.masked_fill(~torch.ones((64, 64), dtype=torch.bool,
                                  device=cuda).tril(), -3e38)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(e.bfloat16().float(), vf) / e.sum(dim=-1, keepdim=True)
    _close_to_emulation(got, o.transpose(1, 2).bfloat16())


# The MLA build: q/k head dim 192 (nope 128 + rope 64), v head dim 128, 64-
# and 32-row blocks, one and several k/v blocks, ragged head dims below
# the build's; v a strided view of the model's per-head [k_nope ; v]
# expansion.  fp32 at the reduced config's (24, 16) and a wider pair.
MLA_CASES = [((2, 200, 4), 192, 128, torch.bfloat16),
             ((3, 20, 8), 192, 128, torch.bfloat16),
             ((1, 1, 2), 192, 128, torch.bfloat16),
             ((2, 130, 3), 160, 96, torch.bfloat16),
             ((2, 77, 4), 24, 16, torch.bfloat16),
             ((2, 77, 4), 24, 16, torch.float32),
             ((3, 20, 2), 24, 16, torch.float32),
             ((2, 130, 3), 128, 64, torch.float32)]


def _mla_case(cuda, B, S, H, D, Dv, dtype, seed):
    g = torch.Generator(cuda)
    g.manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, H, D), generator=g, device=cuda).to(dtype)
    kv = torch.randn((B, S, H, 128 + Dv), generator=g, device=cuda)
    return q, k, kv.to(dtype)[..., 128:]


@pytest.mark.parametrize("bsh,D,Dv,dtype", MLA_CASES)
def test_flash_attention_mla_build_matches_plain(cuda, bsh, D, Dv, dtype):
    q, k, v = _mla_case(cuda, *bsh, D, Dv, dtype, sum(bsh) + D)
    assert v.stride(3) == 1 and not v.is_contiguous()
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.shape == bsh + (Dv,) and got.dtype == dtype
    want = ref.flash_attention_ref(q, k, v)
    if dtype == torch.float32:
        assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=3e-4,
                        atol=3e-4)
    else:
        assert _rel_l2(got, want) <= 2e-2


def test_flash_attention_mla_build_rounds_p_as_the_tpu_kernel(cuda):
    """One k block (S <= 64) of the MLA build: the scale is q's head
    dim's, p rounded to bf16 before p.v, the unrounded sum as the
    normaliser."""
    q, k, v = _mla_case(cuda, 3, 64, 4, 192, 128, torch.bfloat16, 5)
    got = ops.flash_attention(q, k, v)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) / 192 ** 0.5
    s = s.masked_fill(~torch.ones((64, 64), dtype=torch.bool,
                                  device=cuda).tril(), -3e38)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(e.bfloat16().float(), vf) / e.sum(dim=-1, keepdim=True)
    _close_to_emulation(got, o.transpose(1, 2).bfloat16())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mla_gradient_on_card(cuda, dtype):
    D, Dv = (192, 128) if dtype == torch.bfloat16 else (24, 16)
    q, k, v = _grad_inputs(cuda, ((2, 70, 4, D), (2, 70, 4, D),
                                  (2, 70, 4, Dv)), dtype, 3)
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == before + 1
    gout = torch.randn_like(out)
    want = torch.autograd.grad(ops.attention_math(q, k, v), (q, k, v), gout)
    got = torch.autograd.grad(out, (q, k, v), gout)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C", [1, 64])
def test_moe_ffn_kernel_at_deepseek_width(cuda, C):
    """B6 at deepseek-v3's (E, D, F) = (256, 7168, 2048): the decode's one
    capacity row and a 2 x 1024-token prefill's 64, bf16, against
    moe_ffn_math and against the kernel's roundings emulated in fp32, 16
    experts at a time (22.5 GB of weights)."""
    E, D, F = 256, 7168, 2048
    g = torch.Generator(cuda)
    g.manual_seed(C)
    xs = torch.randn((E, C, D), generator=g, device=cuda).bfloat16()
    w = [(0.02 * torch.randn(s, generator=g, device=cuda)).bfloat16()
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    before = ops.launch_counts()["moe_ffn"]
    got = ops.moe_ffn(xs, *w)
    assert ops.launch_counts()["moe_ffn"] == before + 1
    assert got.shape == (E, C, D) and got.dtype == torch.bfloat16
    for e0 in range(0, E, 16):
        part = [t[e0:e0 + 16] for t in (xs, *w)]
        assert _rel_l2(got[e0:e0 + 16], ops.moe_ffn_math(*part)) <= 2e-2
        x32, g32, u32, d32 = (t.float() for t in part)
        h = (torch.nn.functional.silu(torch.bmm(x32, g32))
             * torch.bmm(x32, u32)).bfloat16().float()
        _close_to_emulation(got[e0:e0 + 16], torch.bmm(h, d32).bfloat16())
    del xs, w, got
    torch.cuda.empty_cache()


def test_flash_attention_kernel_reads_strided_views(cuda):
    qkv = torch.randn((2, 50, 3, 6, 16), device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q.contiguous(), k.contiguous(),
                                   v.contiguous())
    assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


def test_lm_kernels_refuse_what_they_cannot_hold(cuda):
    x = torch.zeros((1, 4, 2, 129), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(x, x, x)
    x = torch.zeros((1, 4, 6, 16), device=cuda)
    with pytest.raises(ValueError, match="disagree"):
        ops.flash_attention(x, x[:, :, :4], x[:, :, :4])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(x.half(), x.half(), x.half())
    xs = torch.zeros((2, 3, 4), device=cuda)
    w = torch.zeros((2, 4, 30000), device=cuda)
    with pytest.raises(ValueError, match="too wide"):
        ops.moe_ffn(xs, w, w, torch.zeros((2, 30000, 4), device=cuda))
    w = torch.zeros((2, 5, 4), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.moe_ffn(xs, w, w, torch.zeros((2, 5, 4), device=cuda))
    with pytest.raises(ValueError, match="must be"):
        ops.moe_ffn(xs, w.contiguous().bfloat16(), w.contiguous(),
                    torch.zeros((2, 5, 4), device=cuda))


def test_gqa_forward_on_card_raises_for_unported_attention(cuda):
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import attention, common, registry
    cfg = dataclasses.replace(configs.reduced_config("qwen2-0.5b"),
                              dtype=torch.float32)
    gen = torch.Generator(cuda)
    params = common.init_params(registry.param_specs(cfg), gen, cuda)
    p = {k: v[0] for k, v in params["layers"]["attn"].items()}
    x = torch.randn((2, 5, cfg.d_model), device=cuda)
    pos = torch.arange(5, device=cuda)[None].expand(2, 5)
    assert attention.gqa_forward(p, x, pos, cfg).shape == x.shape
    with pytest.raises(NotImplementedError, match="attn_impl='flash'"):
        attention.gqa_forward(p, x, pos, dataclasses.replace(
            cfg, attn_impl="flash"))
    # bf16 scores run the kernel's bf16-score builds (the fp32 model's q,
    # k, v cast to bf16), causal and windowed, against the CPU's bf16
    # score slab: relative L2 <= 2e-2 (bf16 softmax on the CPU, fp32
    # online softmax with p rounded to bf16 on the card).
    for window in (0, 3):
        s16 = dataclasses.replace(cfg, attn_score_dtype="bf16",
                                  sliding_window=window)
        ops.reset_launch_counts()
        got = attention.gqa_forward(p, x, pos, s16)
        mask = "window" if window else "causal"
        assert ops.flash_attention_builds() == {
            f"bf16-32x32-{mask}-s16": 1}
        want = attention.gqa_forward({k: v.cpu() for k, v in p.items()},
                                     x.cpu(), pos.cpu(), s16)
        rel = float((got.cpu() - want).norm() / want.norm())
        assert rel <= 2e-2, (window, rel)
    # A sliding window runs the kernel's window build, equal to the plain
    # path on the CPU.
    window = dataclasses.replace(cfg, sliding_window=3)
    ops.reset_launch_counts()
    got = attention.gqa_forward(p, x, pos, window)
    assert ops.flash_attention_builds() == {"f32-window": 1}
    want = attention.gqa_forward({k: v.cpu() for k, v in p.items()},
                                 x.cpu(), pos.cpu(), window)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    # The stub probe (v + 0 q, no attention) on the card, as on the CPU.
    stub = dataclasses.replace(cfg, attn_impl="stub")
    got = attention.gqa_forward(p, x, pos, stub)
    want = attention.gqa_forward({k: v.cpu() for k, v in p.items()},
                                 x.cpu(), pos.cpu(), stub)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-0.5b"])
def test_reduced_model_on_card_matches_cpu(cuda, arch):
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import common, registry, transformer
    cfg = dataclasses.replace(configs.reduced_config(arch),
                              dtype=torch.float32)
    gen = torch.Generator("cpu")
    gen.manual_seed(0)
    cpu = common.init_params(registry.param_specs(cfg), gen, "cpu")
    gpu = common.tree_map(lambda t: t.to(cuda), cpu)
    tok = torch.from_numpy(np.random.RandomState(0).randint(0, 128, (6, 20)))
    ops.reset_launch_counts()
    feats = []
    for params, dev in ((gpu, cuda), (cpu, "cpu")):
        x, pos = transformer._embed_inputs(params, cfg,
                                           {"tokens": tok.to(dev)})
        feats.append(transformer.backbone(params, cfg, x, pos).cpu())
    assert_allclose(feats[0].numpy(), feats[1].numpy(), rtol=1e-4, atol=1e-4)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == cfg.num_layers
    assert counts["moe_ffn"] == (cfg.num_layers if cfg.moe else 0)


# -- the exact pass and the fold as captured CUDA graphs ----------------------

def _clone(mp):
    c = mp.cache
    return mp._replace(
        inner=mp.inner._replace(phi=mp.inner.phi.clone(),
                                phi_i=mp.inner.phi_i.clone()),
        cache=type(c)(*(None if t is None else t.clone() for t in c)),
        avg=mp.avg._replace(bar_exact=mp.avg.bar_exact.clone(),
                            bar_approx=mp.avg.bar_approx.clone()))


def _leaves(mp):
    c = mp.cache
    return [mp.inner.phi, mp.inner.phi_i, mp.avg.bar_exact, c.planes,
            c.valid, c.last_active] + ([] if c.gram is None else [c.gram])


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _card_state(cuda, n, f, C, mean_len, max_len, algo, cap):
    """A chain problem on the card and its state after one Solver
    iteration (a part-filled cache)."""
    X, Y, M = ocr_like(n=n, f=f, num_labels=C, mean_len=mean_len,
                       max_len=max_len, seed=0)
    problem = chain.make_problem(X, Y, M, C, device=cuda)
    solver = Solver(problem, RunConfig(
        lam=1.0 / n, algo=algo, max_iters=1, cap=cap, approx_batch=2,
        max_approx_passes=2, cost_model=CostModel(0.3, 1e-4)))
    solver.run()
    return problem, solver.state


# SMALL["ocr"] (n=120, f=32, C=12), plain and Gram cache; a window of 256
# blocks at the full OCR widths (f=128, C=26, d=4004, cap=64).
GRAPH_CASES = [((120, 32, 12, 7, 10), "mpbcfw", 16, 120),
               ((120, 32, 12, 7, 10), "mpbcfw-gram", 16, 120),
               ((512, 128, 26, 8, 14), "mpbcfw", 64, 256)]


@pytest.mark.parametrize("shape,algo,cap,blocks", GRAPH_CASES)
def test_graph_replayed_exact_pass_equals_eager_steps(cuda, shape, algo, cap,
                                                      blocks):
    """One replay per block equals the same step body run eagerly on the
    card, bit for bit, with the same kernel launches."""
    from repro_torch.core import graphs, mpbcfw
    problem, mp = _card_state(cuda, *shape, algo, cap)
    lam = 1.0 / problem.n
    perm = np.random.RandomState(4).permutation(problem.n)[:blocks]
    eager = _clone(mp)
    ctl = graphs.new_control(blocks, problem.d, cuda)
    graphs.load_control(ctl, perm, k0=mp.avg.k_exact, it=mp.outer_it)
    ops.reset_launch_counts()
    for _ in range(blocks):
        mpbcfw.exact_step(problem, eager, ctl, lam)
    want_launches = ops.launch_counts()
    steps = graphs.StepGraphs()
    ops.reset_launch_counts()
    out = mpbcfw.exact_pass(problem, mp, perm, lam, graphs=steps)
    torch.cuda.synchronize()
    assert steps.replays == blocks - 1                  # + 1 warm-up step
    assert ops.launch_counts() == want_launches
    assert want_launches["viterbi_decode"] == blocks
    assert want_launches["plane_scores"] == (
        blocks if algo == "mpbcfw-gram" else 0)
    assert _same_bits(out, eager)
    assert out.inner.n_exact == mp.inner.n_exact + blocks


def test_graph_replays_from_one_state_give_the_same_bits(cuda):
    """20 passes of replays, each from the same starting bits copied into
    the captured tensors, end on the same bits."""
    from repro_torch.core import graphs, mpbcfw
    problem, mp = _card_state(cuda, 120, 32, 12, 7, 10, "mpbcfw-gram", 16)
    lam = 1.0 / problem.n
    perm = np.random.RandomState(6).permutation(problem.n)
    start = _clone(mp)
    steps = graphs.StepGraphs()
    ends = []
    for _ in range(20):
        for dst, src in zip(_leaves(mp), _leaves(start)):
            dst.copy_(src)
        mpbcfw.exact_pass(problem, mp, perm, lam, graphs=steps)
        ends.append(_clone(mp))
    assert steps.replays == 20 * problem.n - 1
    assert all(_same_bits(e, ends[0]) for e in ends[1:])


def test_new_state_recaptures_and_the_old_graph_stays_idle(cuda):
    """A state with other tensors (as after a restore) gets its own
    capture; the graph of the first state is never replayed on it, so
    the first state's bits do not move."""
    from repro_torch.core import graphs, mpbcfw
    problem, mp = _card_state(cuda, 120, 32, 12, 7, 10, "mpbcfw", 16)
    lam = 1.0 / problem.n
    perm = np.random.RandomState(8).permutation(problem.n)
    steps = graphs.StepGraphs()
    mpbcfw.exact_pass(problem, mp, perm, lam, graphs=steps)
    frozen = _clone(mp)
    other = _clone(mp)
    eager = _clone(mp)
    r0 = steps.replays
    out = mpbcfw.exact_pass(problem, other, perm, lam, graphs=steps)
    torch.cuda.synchronize()
    assert steps.replays - r0 == problem.n - 1          # a new warm-up
    assert _same_bits(mp, frozen)
    ctl = graphs.new_control(problem.n, problem.d, cuda)
    graphs.load_control(ctl, perm, k0=eager.avg.k_exact, it=eager.outer_it)
    for _ in perm:
        mpbcfw.exact_step(problem, eager, ctl, lam)
    assert _same_bits(out, eager)


def test_capture_survives_cyclic_garbage_holding_an_old_graph(cuda):
    """An unreachable earlier graph (in a reference cycle, as a dropped
    engine's) is not collected inside a later capture: CUDA refuses to
    destroy a graph while the thread captures, which would invalidate
    it.  The body makes such garbage and then enough allocations to pass
    the collector's first threshold."""
    import gc
    from repro_torch.core import graphs
    x = torch.ones(8, device=cuda)
    held = [graphs._Graph(lambda: x.add_(1.0), cuda)]

    def body():
        cycle = {"graph": held.pop()}
        cycle["self"] = cycle
        del cycle
        junk = [[] for _ in range(4 * gc.get_threshold()[0])]
        del junk
        x.mul_(2.0)
    g = graphs._Graph(body, cuda)
    gc.collect()
    x.fill_(1.0)
    g.replay()
    torch.cuda.synchronize()
    assert x.cpu().tolist() == [2.0] * 8


def test_graph_replayed_fold_equals_eager_steps(cuda):
    """Both fold bodies (arrived, straggler), one replay per block, equal
    the bodies run eagerly, bit for bit."""
    from repro_torch.core import graphs
    from repro_torch.core.distributed import (fallback_planes, fold_planes,
                                              fold_step, parallel_oracles)
    from repro_torch.core.ssvm import weights_of
    problem, mp = _card_state(cuda, 512, 128, 26, 8, 14, "mpbcfw", 64)
    lam = 1.0 / problem.n
    rng = np.random.RandomState(2)
    ids = rng.permutation(problem.n)[:256]
    done = rng.rand(256) > 0.3
    w = weights_of(mp.inner.phi, lam)
    planes = parallel_oracles(problem, w, ids)
    fbp, fbs, _ = fallback_planes(mp.cache, ids, w)
    eager = _clone(mp)
    ctl = graphs.new_control(256, problem.d, cuda, fold=True)
    graphs.load_control(ctl, ids, k0=mp.avg.k_exact, it=mp.outer_it,
                        planes=planes, fb_planes=fbp, fb_slots=fbs)
    ops.reset_launch_counts()
    for ok in done:
        fold_step(eager, ctl, lam, arrived=bool(ok))
    want_launches = ops.launch_counts()
    steps = graphs.StepGraphs()
    ops.reset_launch_counts()
    out = fold_planes(mp, ids, planes, fbp, fbs, done, lam, graphs=steps)
    torch.cuda.synchronize()
    assert steps.replays == 256 - 2
    assert ops.launch_counts() == want_launches
    assert _same_bits(out, eager)


def test_async_solver_replays_one_graph_per_folded_block(cuda):
    X, Y, M = ocr_like(n=120, f=32, num_labels=12, mean_len=7, max_len=10,
                       seed=0)
    solver = Solver(chain.make_problem(X, Y, M, 12, device=cuda), RunConfig(
        lam=1 / 120, algo="mpbcfw-async", max_iters=3, cap=16,
        approx_batch=2, max_approx_passes=2, cost_model=CostModel(0.3, 1e-4)))
    solver.engine.outcome_fn = (
        lambda it, k: np.random.RandomState(it).rand(k) > 0.3)
    trace = solver.run().trace
    folded = trace[-1].n_exact + trace[-1].n_approx - 120 * sum(
        r.approx_passes for r in trace)
    assert folded == 2 * 120
    assert solver.engine.graphs.replays == folded - 2


@pytest.mark.parametrize("S", [1, 31, 32, 33, 200])
def test_flash_attention_kernel_ragged_s_at_full_width(cuda, S):
    """The backbone's (B, S, 16, 128) layout at ragged S: bf16 on the
    tensor cores against the plain version, f32 at 3e-4."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _attn_case((4, S, 16, 128), 16, S, dtype, cuda)
        got = ops.flash_attention(q, k, v)
        want = ref.flash_attention_ref(q, k, v)
        if dtype == torch.float32:
            assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                            rtol=3e-4, atol=3e-4)
        else:
            assert _rel_l2(got, want) <= 2e-2


def test_flash_attention_kernel_at_the_backbone_shape(cuda):
    """(1024, 32, 16, 128) bf16, the feature pass's call: against the
    plain version and the emulated roundings (one k block)."""
    q, k, v = _attn_case((1024, 32, 16, 128), 16, 5, torch.bfloat16, cuda)
    got = ops.flash_attention(q, k, v)
    assert _rel_l2(got, ref.flash_attention_ref(q, k, v)) <= 2e-2
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) / 128 ** 0.5
    s = s.masked_fill(~torch.ones((32, 32), dtype=torch.bool,
                                  device=cuda).tril(), -3e38)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(e.bfloat16().float(), vf) / e.sum(dim=-1, keepdim=True)
    _close_to_emulation(got, o.transpose(1, 2).bfloat16())


# -- the simple engines (bcfw, ssg, fw) --------------------------------------

def _small_ocr(device):
    X, Y, M = ocr_like(n=120, f=32, num_labels=12, mean_len=7, max_len=10,
                       seed=0)
    return chain.make_problem(X, Y, M, 12, device=device)


def test_bcfw_and_ssg_replays_equal_eager_steps(cuda):
    """BCFW's exact pass and SSG's pass, one replay per block, equal their
    step bodies run eagerly on the card, bit for bit."""
    from repro_torch.core import bcfw, graphs, subgradient
    from repro_torch.core.averaging import init_averaging
    from repro_torch.core.ssvm import init_state
    problem = _small_ocr(cuda)
    lam = 1.0 / problem.n
    perm = np.random.RandomState(5).permutation(problem.n)
    # BCFW, from a state one pass in.
    st, avg = init_state(problem, cuda), init_averaging(problem.d, cuda)
    steps = graphs.StepGraphs()
    st, avg = bcfw.exact_pass(problem, st, avg, perm, lam, graphs=steps)
    e_st = st._replace(phi=st.phi.clone(), phi_i=st.phi_i.clone())
    e_bar = avg.bar_exact.clone()
    ctl = graphs.new_control(problem.n, problem.d, cuda)
    graphs.load_control(ctl, perm, k0=avg.k_exact, it=0)
    for _ in perm:
        bcfw.exact_step(problem, e_st, e_bar, ctl, lam)
    ops.reset_launch_counts()
    st, avg = bcfw.exact_pass(problem, st, avg, perm, lam, graphs=steps)
    torch.cuda.synchronize()
    assert steps.replays == 2 * problem.n - 1
    assert ops.launch_counts()["viterbi_decode"] == problem.n
    assert torch.equal(st.phi, e_st.phi) and torch.equal(st.phi_i,
                                                         e_st.phi_i)
    assert torch.equal(avg.bar_exact, e_bar)
    # SSG from t = 1.
    w = torch.zeros(problem.d, device=cuda)
    t = torch.ones((), dtype=torch.int32, device=cuda)
    ew, et = w.clone(), t.clone()
    steps = graphs.StepGraphs()
    subgradient.ssg_pass(problem, w, t, perm, lam, graphs=steps)
    ctl = graphs.new_control(problem.n, problem.d, cuda)
    graphs.load_control(ctl, perm, k0=0, it=0)
    for _ in perm:
        subgradient.ssg_step(problem, ew, et, ctl, lam)
    torch.cuda.synchronize()
    assert steps.replays == problem.n - 1
    assert torch.equal(w, ew) and int(t) == int(et) == problem.n + 1


@pytest.mark.parametrize("algo", ["fw", "ssg", "bcfw", "bcfw-avg",
                                  "mpbcfw-avg"])
def test_simple_engines_card_matches_cpu(cuda, algo):
    """Three iterations on SMALL ocr, card against CPU: the same schedule
    and sync counts, objectives within rtol 1e-4 (ssg: no dual)."""
    rows = {}
    for dev in (cuda, "cpu"):
        problem = _small_ocr(dev)
        rows[str(dev)] = Solver(problem, RunConfig(
            lam=1.0 / problem.n, algo=algo, max_iters=3, cap=16,
            approx_batch=4, max_approx_passes=6,
            cost_model=CostModel(0.3, 1e-4))).run().trace
    for g, c in zip(rows["cuda"], rows["cpu"]):
        assert (g.n_exact, g.n_approx, g.approx_passes, g.dispatches,
                g.host_syncs) == (c.n_exact, c.n_approx, c.approx_passes,
                                  c.dispatches, c.host_syncs)
        assert_allclose(g.primal, c.primal, rtol=1e-4)
        assert_allclose(g.primal_avg, c.primal_avg, rtol=1e-4)
        if algo == "ssg":
            assert np.isnan(g.dual) and np.isnan(c.dual)
        else:
            assert_allclose(g.dual, c.dual, rtol=1e-4)


# -- structured serving ---------------------------------------------------------


def _serve_case(kind, device):
    """A seeded random-weight model of ``kind`` on ``device`` and its
    requests: mixed-length chains, odd-width (f = 5, rows at 20-byte
    offsets) and usps-width multiclass rows, mixed 4x5 / 3x5 lattices."""
    from repro_torch import serve
    from repro_torch.core.oracles.graph import GraphSpec
    from repro_torch.core.oracles.multiclass import MulticlassSpec
    from repro_torch.data.synthetic import horseseg_like, usps_like
    if kind == "chain":
        spec, gran = chain.ChainSpec(num_labels=6), 4
        X, Y, M = ocr_like(n=40, f=12, num_labels=6, mean_len=6, max_len=13,
                           seed=3)
        reqs = [{"x": X[i, :L], "y": Y[i, :L], "mask": M[i, :L]}
                for i, L in enumerate(M.sum(axis=1))]
        f = 12
    elif kind in ("multiclass", "usps"):
        f, C = (5, 4) if kind == "multiclass" else (256, 10)
        spec, gran = MulticlassSpec(num_classes=C), 4
        x, y = usps_like(n=37, f=f, num_classes=C, seed=3)
        reqs = [{"x": x[i], "y": y[i]} for i in range(37)]
    else:
        spec, gran, f = GraphSpec(num_sweeps=6), 8, 7
        keys = ("x", "y", "mask", "edges", "edge_mask", "color")
        reqs = []
        for grid, seed in (((4, 5), 3), ((3, 5), 4)):
            arrays = horseseg_like(n=9, grid=grid, f=f, seed=seed)
            reqs += [{k: a[i] for k, a in zip(keys, arrays)}
                     for i in range(9)]
    d = spec.dim({"x": np.zeros((1, 1, f) if kind in ("chain", "graph")
                                else (1, f))})
    w = torch.from_numpy(np.random.RandomState(9).randn(d).astype(
        np.float32)).to(device)
    return serve.ServableModel(spec, w), reqs, gran


@pytest.mark.parametrize("batch_size", [1, 3, 8])
@pytest.mark.parametrize("kind", ["chain", "multiclass", "usps", "graph"])
def test_served_labels_equal_per_example_on_card(cuda, kind, batch_size):
    """On the card: every served labeling equals the per-example decode
    (labels equal); one captured graph per occupied bucket, one replay,
    one dispatch and one sync per round; B3 launched once per chain
    round."""
    from repro_torch import serve
    model, reqs, gran = _serve_case(kind, cuda)
    server = serve.StructuredServer(model, batch_size=batch_size,
                                    bucket_granularity=gran)
    before = ops.launch_counts()["viterbi_decode"]
    served = server.serve(reqs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["viterbi_decode"] - before
    rounds, dispatches, syncs = server.ledger.counts()
    buckets = {serve.bucket_key(server.engine.shape_key(r), gran)
               for r in reqs}
    assert dispatches == syncs == rounds == server.engine.replays > 0
    assert len(server.engine.programs) == len(buckets)
    assert launches == (rounds if kind == "chain" else 0)
    for i, (ex, lab) in enumerate(zip(reqs, served)):
        assert np.array_equal(lab, model.decode(ex).cpu().numpy()), i


def test_served_labels_follow_new_weights_on_card(cuda):
    """The bucket graphs bake in ``w``: a model given new weights captures
    anew, and serves the new weights' per-example labels."""
    from repro_torch import serve
    model, reqs, gran = _serve_case("chain", cuda)
    server = serve.StructuredServer(model, batch_size=4,
                                    bucket_granularity=gran)
    first = server.serve(reqs)
    model.w = -model.w
    second = server.serve(reqs)
    assert server.engine.replays == server.ledger.rounds
    assert any(not np.array_equal(a, b) for a, b in zip(first, second))
    for ex, lab in zip(reqs, second):
        assert np.array_equal(lab, model.decode(ex).cpu().numpy())


# -- the gap output of approx_pass, and mpbcfw-gap on the card ----------------

def _eager_gap_replay(t, perm, lam=1.0 / 6877, k0=7000):
    """The plain version with the gap output, one block per call (the same
    pass), recording for each block its last visit's two scores: the
    chosen plane's ``s`` and the iterate's ``s_i = <phi_i, [w 1]>``.
    Returns the state, the gap vector and per block the allowance of its
    gap (:func:`_gap_allowed`) and ``s - s_i``."""
    from repro_torch import cache as tcache
    from repro_torch.core.bcfw import plane_score
    from repro_torch.core.ssvm import weights_of
    st = {k: t[k].clone() for k in ("phi", "phi_i", "bar", "last")}
    gap = t["gap"].clone()
    cache = tcache.PlaneCache(planes=t["planes"], valid=t["valid"],
                              last_active=st["last"])
    n = gap.shape[0]
    allowed = torch.zeros(n, dtype=torch.float32, device=gap.device)
    raw = torch.zeros_like(allowed)
    one = gap.new_ones(1)
    for pos, i in enumerate(perm.tolist()):
        w = weights_of(st["phi"], lam)
        p, _, s = tcache.approx_oracle(cache, i, w)
        row, wa = st["phi_i"][i], torch.cat([w.abs(), one])
        s_i = plane_score(row, w)
        allowed[i] = _gap_allowed(s.abs() + s_i.abs(),
                                  p.abs() @ wa + row.abs() @ wa)
        raw[i] = s - s_i
        eager_pass(st["phi"], st["phi_i"], st["bar"], t["planes"],
                   t["valid"], st["last"], perm[pos:pos + 1], lam=lam,
                   k0=k0 + pos, outer_it=5, gap=gap)
    return st, gap, allowed, raw


def _gap_allowed(scale, terms):
    """A block gap's allowance: 3e-5 (|s| + |s_i|) plus 64 float32 ulps
    of the two scores' dots' sum of |terms| (their rounding scale; the gap
    is their difference, so no relative tolerance on it holds)."""
    return 3e-5 * scale + 64 * 2.0 ** -24 * terms


GAP_CASES = [(512, 64, 4004), (33, 5, 7), (40, 16, 10265),
             (12, 16, 25625), (6, 4096, 7), (12, 16, 20505)]


@pytest.mark.parametrize("n,cap,d", GAP_CASES)
def test_approx_pass_gap_output_matches_plain(cuda, n, cap, d):
    """approx_pass with the gap output, staged and wide plans, against the
    plain version: each visited block's gap within its allowance
    (:func:`_gap_allowed`) of the plain one's, 0 exactly where the plain
    value clamps a clear negative (and for an empty block whose iterate
    scores above 0),
    unvisited blocks untouched; every other output bit-equal to the
    launch without the gap output, and equal to the plain pass within
    TOL."""
    from repro_torch.kernels import approx_pass as t_ap
    t, _, perm = _pass_state(n, cap, d, None, 31 * n + cap, cuda)
    t["valid"][perm[: max(1, n // 8)]] = False          # empty blocks
    # An empty block whose iterate scores far above 0 (its phi_i row
    # negated): the plain gap is clearly negative and clamps to 0.
    t["phi_i"][perm[0]] *= -1.0
    if n > 8:
        perm = perm[: n - 2].contiguous()               # two unvisited
    r = np.random.RandomState(n + d)
    gap0 = np.where(r.rand(n) < 0.5, np.float32(1e30),
                    r.rand(n)).astype(np.float32)
    t["gap"] = torch.from_numpy(gap0).to(cuda)
    keys = ("phi", "phi_i", "bar", "last")
    got = {k: t[k].clone() for k in keys}
    got_gap = t["gap"].clone()
    plain = {k: t[k].clone() for k in keys}
    before = ops.launch_counts()["approx_pass"]
    _run_pass(ops.approx_pass, got, t["planes"], t["valid"], None, perm,
              None)
    got_state = {k: v.clone() for k, v in got.items()}
    got = {k: t[k].clone() for k in keys}
    ops.approx_pass(got["phi"], got["phi_i"], got["bar"], t["planes"],
                    t["valid"], got["last"], perm, lam=1.0 / 6877, k0=7000,
                    outer_it=5, gap=got_gap)
    _run_pass(ops.approx_pass, plain, t["planes"], t["valid"], None, perm,
              None)
    assert ops.launch_counts()["approx_pass"] == before + 3
    for k in keys:
        assert torch.equal(got[k], got_state[k]), k
        assert torch.equal(plain[k], got_state[k]), k
    want, want_gap, allowed, raw = _eager_gap_replay(t, perm)
    assert torch.equal(got["last"], want["last"])
    for k in ("phi", "phi_i", "bar"):
        assert_allclose(got[k].cpu().numpy(), want[k].cpu().numpy(), **TOL)
    seen = torch.zeros(n, dtype=torch.bool, device=cuda)
    seen[perm] = True
    err = (got_gap - want_gap).abs()
    assert bool((err[seen] <= allowed[seen]).all()), float(err[seen].max())
    assert torch.equal(got_gap[~seen], t["gap"][~seen])
    clear = seen & (raw < -allowed)
    assert bool((got_gap[clear] == 0).all()) and bool(clear.any())
    assert bool((got_gap[seen] >= 0).all())
    assert t_ap.plan(d, cap).wide == (d >= 20480 or cap == 4096)


@pytest.mark.parametrize("n,cap,d", [(512, 64, 4004), (12, 16, 25625)])
def test_approx_pass_gap_output_is_deterministic(cuda, n, cap, d):
    t, _, perm = _pass_state(n, cap, d, None, 3, cuda)
    first = None
    for _ in range(10):
        st = {k: t[k].clone() for k in ("phi", "phi_i", "bar", "last")}
        gap = torch.full((n,), 1e30, device=cuda)
        ops.approx_pass(st["phi"], st["phi_i"], st["bar"], t["planes"],
                        t["valid"], st["last"], perm, lam=1.0 / 6877,
                        k0=7000, outer_it=5, gap=gap)
        first = first or (st, gap)
        assert torch.equal(gap, first[1])
        for k in st:
            assert torch.equal(st[k], first[0][k]), k


def test_approx_pass_refuses_the_gap_output_in_the_sec35_mode(cuda):
    t, gram, perm = _pass_state(8, 4, 16, 10, 1, cuda)
    st = {k: t[k].clone() for k in ("phi", "phi_i", "bar", "last")}
    with pytest.raises(ValueError, match="plain mode"):
        ops.approx_pass(st["phi"], st["phi_i"], st["bar"], t["planes"],
                        t["valid"], st["last"], perm, lam=0.1, k0=0,
                        outer_it=1, gram=gram, steps=10,
                        gap=torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="gap must be"):
        ops.approx_pass(st["phi"], st["phi_i"], st["bar"], t["planes"],
                        t["valid"], st["last"], perm, lam=0.1, k0=0,
                        outer_it=1, gap=torch.zeros(9, device=cuda))


def test_gap_schedule_on_card_equals_cpu(cuda):
    """The gumbel-top-k on the card equals the CPU's for the same gap
    vector and seed (the noise is drawn on the host either way), the
    all-unseen vector in index order at k < n and k = n."""
    from repro_torch import cache as tcache
    from repro_torch.policy import GAP_POLICIES, make_bundle
    for case in range(8):
        r = np.random.RandomState(case)
        n = (16, 6877, 200, 120)[case % 4]
        gap = (r.rand(n) * 10.0 ** r.uniform(-6, 0, n)).astype(np.float32)
        gap[r.rand(n) < 0.2] = np.float32(1e30)
        if case == 0:
            gap[:] = np.float32(1e30)
        for k in (1, round(0.5 * n), n):
            b = make_bundle(GAP_POLICIES, RunConfig(lam=0.1,
                                                    gap_frac=k / n), n)
            ids = {}
            for dev in ("cpu", cuda):
                c = tcache.init(tcache.CacheLayout(cap=1, track_gap=True),
                                n, 1, dev)
                c.gap.copy_(torch.from_numpy(gap))
                ids[str(dev)] = b.sampling.schedule(c, None, 77 + case)
            assert ids["cuda"].device.type == "cuda"
            assert torch.equal(ids["cuda"].cpu(), ids["cpu"]), (case, k)
            if case == 0:
                assert torch.equal(ids["cpu"], torch.arange(k))


def test_gap_solver_on_card_matches_cpu_run(cuda):
    """mpbcfw-gap, 4 iterations of SMALL ocr: every schedule equal, duals,
    primals and gap_total within rtol 1e-4, one dispatch and one sync per
    iteration, one replay per exact block."""
    from repro_torch.configs.paper import SMALL
    from repro_torch.policy import GapSampling
    sc = SMALL["ocr"]
    X, Y, M = ocr_like(n=sc.n, f=sc.f, num_labels=sc.num_classes,
                       mean_len=sc.mean_len, max_len=sc.max_len, seed=0)
    logs = {}
    inner = GapSampling.schedule
    runs = {}
    for dev in ("cpu", cuda):
        log = logs.setdefault(str(dev), [])

        def recorded(self, cache, perm, key, log=log):
            ids = inner(self, cache, perm, key)
            log.append(ids.cpu())
            return ids
        GapSampling.schedule = recorded
        try:
            solver = Solver(
                chain.make_problem(X, Y, M, sc.num_classes, device=dev),
                RunConfig(lam=1 / sc.n, algo="mpbcfw-gap", max_iters=4,
                          cap=16, approx_batch=8, max_approx_passes=8,
                          cost_model=CostModel(0.3, 1e-4)))
            runs[str(dev)] = (solver, solver.run().trace)
        finally:
            GapSampling.schedule = inner
    (gs, g_rows), (_, c_rows) = runs["cuda"], runs["cpu"]
    k = round(0.5 * sc.n)
    for it, (g, c) in enumerate(zip(g_rows, c_rows)):
        assert torch.equal(logs["cuda"][it], logs["cpu"][it]), it
        assert (g.n_exact, g.n_approx, g.approx_passes, g.gap_sampled) == (
            c.n_exact, c.n_approx, c.approx_passes, c.gap_sampled)
        assert g.gap_sampled == k
        assert (g.dispatches, g.host_syncs) == (1, 1)
        for f in ("dual", "primal", "gap_total"):
            assert_allclose(getattr(g, f), getattr(c, f), rtol=1e-4)
    assert torch.equal(logs["cuda"][0], torch.arange(k))
    assert gs.engine.graphs.replays == 4 * k - 1


def test_exact_graph_is_keyed_by_the_gap_vector(cuda):
    """One StepGraphs, a plain state then a gap-tracking one: the second
    captures its own body (which writes the gap vector) instead of
    replaying the first's."""
    from repro_torch.cache import CacheLayout
    from repro_torch.core import mpbcfw
    from repro_torch.core.graphs import StepGraphs
    X, Y, M = ocr_like(n=24, f=8, num_labels=5, mean_len=6, max_len=8,
                       seed=1)
    prob = chain.make_problem(X, Y, M, 5, device=cuda)
    graphs = StepGraphs()
    lam = 1.0 / 24
    plain = mpbcfw.init_mp_state(prob, CacheLayout(cap=4))
    mpbcfw.exact_pass(prob, plain, np.arange(8), lam, graphs=graphs)
    assert graphs.replays == 7
    gap = mpbcfw.init_mp_state(prob, CacheLayout(cap=4, track_gap=True))
    ids = torch.arange(8, device=cuda)
    mpbcfw.exact_pass(prob, gap, ids, lam, graphs=graphs)
    assert graphs.replays == 14           # one more eager warm-up step
    assert bool((gap.cache.gap[:8] < 1e29).all())
    assert bool((gap.cache.gap[8:] == 1e30).all())


# -- observability: the recorder adds no sync on the card -------------------

def _sync_checked(path, **kw):
    """A RunRecorder whose callbacks run under sync-debug "error" (a host
    sync inside one raises), counting them."""
    from repro_torch.obs import RunRecorder

    class SyncChecked(RunRecorder):
        calls = 0

        def _guarded(self, fn, *a, **k):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
                self.calls += 1

        def __call__(self, solver, row):
            return self._guarded(super().__call__, solver, row)

        def observe_phases(self, segments):
            return self._guarded(super().observe_phases, segments)
    return SyncChecked(path, **kw)


@pytest.mark.parametrize("algo", ["mpbcfw", "mpbcfw-gram", "mpbcfw-async",
                                  "mpbcfw-gap", "bcfw"])
def test_recorded_run_equals_unrecorded_on_the_card(cuda, tmp_path, algo):
    from repro_torch.obs import validate_file
    X, Y, M = ocr_like(n=120, f=32, num_labels=12, mean_len=7, max_len=10,
                       seed=0)
    prob = chain.make_problem(X, Y, M, 12, device=cuda)
    kw = dict(lam=1 / 120, algo=algo, max_iters=3, cap=16, approx_batch=4,
              max_approx_passes=6)
    if algo == "mpbcfw-gram":
        kw["gram_steps"] = 10
    # A CostModel is the run's clock: one each.
    bare = Solver(prob, RunConfig(cost_model=CostModel(0.3, 1e-4),
                                  **kw)).run().trace
    rec = _sync_checked(tmp_path / "run.jsonl")
    with rec:
        got = Solver(prob, RunConfig(cost_model=CostModel(0.3, 1e-4), **kw),
                     recorder=rec).run().trace
    assert got == bare
    assert rec.calls == 3
    assert validate_file(tmp_path / "run.jsonl")[1] == []


def test_wall_mode_recorder_fit_on_the_card(cuda, tmp_path):
    X, Y, M = ocr_like(n=120, f=32, num_labels=12, mean_len=7, max_len=10,
                       seed=0)
    prob = chain.make_problem(X, Y, M, 12, device=cuda)
    rec = _sync_checked(tmp_path / "wall.jsonl")
    with rec:
        solver = Solver(prob, RunConfig(
            lam=1 / 120, max_iters=4, cap=16, approx_batch=2,
            max_approx_passes=8, cost_model=None), recorder=rec)
        for row in solver.iterate():
            assert row.host_syncs == row.dispatches
            if rec._phase_fit is not None:
                assert (solver._est_exact, solver._est_plane) == \
                    rec._phase_fit
    assert rec.calls == 8


# -- the shard engine on the card: the averaging stride, NCCL at one rank ----

def _ranks_pass(fn, t, gram, perm, steps, S):
    """The pass as S ranks run it (``repro_torch.shard``), in one process:
    each rank walks its contiguous n/S blocks in ``perm``'s visit order
    from the shared phi, its averaging count advancing by S per block;
    then the engine's damped recombination, phi + sum(delta)/S, phi_i0 +
    (phi_i - phi_i0)/S, the average the mean of the ranks'."""
    from repro_torch.shard.engine import local_schedules
    n = t["phi_i"].shape[0]
    nl = n // S
    phi0, bar0 = t["phi"], t["bar"]
    red0 = torch.zeros_like(phi0)
    red1 = torch.zeros_like(bar0)
    phi_i, last = [], []
    for r in range(S):
        lo, hi = r * nl, (r + 1) * nl
        sched = local_schedules(perm.cpu().numpy()[None], lo, nl)[0]
        st = dict(phi=phi0.clone(), phi_i=t["phi_i"][lo:hi].clone(),
                  bar=bar0.clone(), last=t["last"][lo:hi].clone())
        fn(st["phi"], st["phi_i"], st["bar"], t["planes"][lo:hi],
           t["valid"][lo:hi], st["last"],
           torch.from_numpy(sched).to(phi0.device), lam=1.0 / 6877,
           k0=7000, outer_it=5,
           gram=None if gram is None else gram[lo:hi], steps=steps,
           k_stride=S)
        red0 += st["phi"] - phi0
        red1 += st["bar"] / S
        phi_i.append(t["phi_i"][lo:hi]
                     + (st["phi_i"] - t["phi_i"][lo:hi]) / S)
        last.append(st["last"])
    return dict(phi=phi0 + red0 / S, phi_i=torch.cat(phi_i), bar=red1,
                last=torch.cat(last))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("steps", [None, 10])
@pytest.mark.parametrize("n,cap,d", [(512, 64, 4004), (12, 16, 20505)])
def test_approx_pass_stride_matches_plain_over_rank_slices(cuda, n, cap, d,
                                                           steps, S):
    """k_stride = S on the staged (d = 4004) and the wide (d = 20,505)
    plans: S ranks' passes, recombined, kernel vs the eager loop: stamps
    equal, phi, phi_i and the average within rtol = atol = 3e-5."""
    from repro_torch.kernels import approx_pass as t_ap
    assert t_ap.plan(d, cap, steps or 0).wide == (d > 20000)
    t, gram, perm = _pass_state(n, cap, d, steps, n + S, cuda)
    before = ops.launch_counts()["approx_pass"]
    got = _ranks_pass(ops.approx_pass, t, gram, perm, steps, S)
    assert ops.launch_counts()["approx_pass"] == before + S
    want = _ranks_pass(eager_pass, t, gram, perm, steps, S)
    assert torch.equal(got["last"], want["last"])
    for k in ("phi", "phi_i", "bar"):
        assert_allclose(got[k].cpu().numpy(), want[k].cpu().numpy(), **TOL)


def test_shard_engine_on_nccl_at_one_rank_equals_mpbcfw(cuda):
    """mpbcfw-shard on a world-size-1 NCCL mesh on the card: every row
    equal to mpbcfw's on the card, one all-reduce per pass and one per
    program charged, each pass one approx_pass launch."""
    from repro_torch.launch.mesh import make_data_mesh
    mesh = make_data_mesh(device=cuda)
    assert mesh.backend == "nccl" and mesh.size == 1
    X, Y, M = ocr_like(n=120, f=32, num_labels=12, mean_len=7, max_len=10,
                       seed=0)
    prob = chain.make_problem(X, Y, M, 12, device=cuda)
    kw = dict(lam=1 / 120, max_iters=3, cap=16, approx_batch=4,
              max_approx_passes=6)
    base = Solver(prob, RunConfig(algo="mpbcfw",
                                  cost_model=CostModel(0.3, 1e-4), **kw))
    want = base.run().trace
    shard = Solver(prob, RunConfig(algo="mpbcfw-shard", mesh=mesh,
                                   cost_model=CostModel(0.3, 1e-4), **kw))
    got = shard.run().trace
    assert got == want
    assert shard.engine.ledger.collectives == sum(
        r.host_syncs + r.approx_passes for r in got)
    assert (shard.result().w == base.result().w).all()


# -- uploads: no host sync from pageable memory -----------------------------

def test_uploads_and_a_main_shaped_batch_take_no_host_sync(cuda):
    """``index_tensor`` and ``make_slope_clock`` upload from pinned memory,
    so they and one slope-ruled batch of 8 passes over the full-size OCR
    state (n = 6877, d = 4004, cap 64, one exact iteration in) run under
    sync-debug "error"; a pageable copy raises there."""
    from repro_torch.core import mpbcfw
    from repro_torch.core.types import index_tensor, upload
    X, Y, M = ocr_like(n=6877, f=128, num_labels=26, mean_len=8,
                       max_len=14, seed=0)
    prob = chain.make_problem(X, Y, M, 26, device=cuda)
    solver = Solver(prob, RunConfig(lam=1 / 6877, algo="mpbcfw", cap=64,
                                    max_iters=1, approx_batch=8,
                                    max_approx_passes=8,
                                    cost_model=CostModel(0.3, 1e-4)))
    solver.run()
    mp = solver.state
    perms = np.stack([np.random.RandomState(k).permutation(6877)
                      for k in range(8)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchroniz"):
            torch.as_tensor(perms, device=cuda)       # the pageable copy
        ids = index_tensor(perms, cuda)
        noise = upload(torch.arange(4.0), cuda)
        clock = mpbcfw.make_slope_clock(0.0, 0.0, 1.0, 1e-4, cuda)
        mp, clock, stats = mpbcfw.multi_approx_pass(mp, perms, clock,
                                                    lam=1 / 6877)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(ids.cpu(), torch.from_numpy(perms))
    assert noise.cpu().tolist() == [0.0, 1.0, 2.0, 3.0]
    assert 1 <= int(stats.passes_run) <= 8


# -- the kernels' gradients (training) ----------------------------------------
# The Functions' backward recomputes the reference's training math, so on
# equal inputs and output gradients their gradients equal autograd through
# that math exactly (rtol = atol = 1e-5 stated for float32 sums); the
# forward is the kernel's (f32 within 3e-4 (1 + |ref|) of the plain
# version, bf16 within relative L2 2e-2).

def _grad_inputs(cuda, shapes, dtype, seed):
    g = torch.Generator(cuda)
    g.manual_seed(seed)
    return [torch.randn(s, generator=g, device=cuda).to(dtype)
            .requires_grad_() for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes", [((8, 128, 14, 64), (8, 128, 2, 64)),
                                    ((3, 77, 8, 32), (3, 77, 8, 32)),
                                    ((6, 50, 16), (6, 50, 16))])
def test_flash_attention_gradient_on_card(cuda, shapes, dtype, monkeypatch):
    q, k, v = _grad_inputs(cuda, (shapes[0], shapes[1], shapes[1]), dtype,
                           len(shapes[0]))
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert out.grad_fn is not None
    gout = torch.randn_like(out)
    want_out = ops.attention_math(q, k, v)
    want = torch.autograd.grad(want_out, (q, k, v), gout)

    def boom(*a, **kw):
        raise AssertionError("the backward called kernels/ref.py")
    monkeypatch.setattr(ref, "flash_attention_ref", boom)
    got = torch.autograd.grad(out, (q, k, v), gout)
    assert ops.launch_counts()["flash_attention"] == before + 1
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                        rtol=1e-5, atol=1e-5)
    o, w = out.detach().float(), want_out.detach().float()
    if dtype == torch.float32:
        assert bool(((o - w).abs() <= 3e-4 * (1 + w.abs())).all())
    else:
        assert float((o - w).norm() / w.norm()) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_gradient_on_card(cuda, dtype, monkeypatch):
    xs, wg, wu, wd = _grad_inputs(
        cuda, ((8, 40, 64), (8, 64, 32), (8, 64, 32), (8, 32, 64)), dtype, 1)
    before = ops.launch_counts()["moe_ffn"]
    out = ops.moe_ffn(xs, wg, wu, wd)
    assert ops.launch_counts()["moe_ffn"] == before + 1
    gout = torch.randn_like(out)
    want = torch.autograd.grad(ops.moe_ffn_math(xs, wg, wu, wd),
                               (xs, wg, wu, wd), gout)

    def boom(*a, **kw):
        raise AssertionError("the backward called kernels/ref.py")
    monkeypatch.setattr(ref, "moe_ffn_ref", boom)
    got = torch.autograd.grad(out, (xs, wg, wu, wd), gout)
    for a, b in zip(got, want):
        assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                        rtol=1e-5, atol=1e-5)


def test_kernels_without_grad_keep_the_plain_launch(cuda):
    q = torch.randn((2, 40, 4, 32), device=cuda)
    k, v = torch.randn((2, 2, 40, 2, 32), device=cuda).unbind(0)
    xs = torch.randn((4, 9, 32), device=cuda)
    w = [torch.randn(s, device=cuda) for s in ((4, 32, 16), (4, 32, 16),
                                              (4, 16, 32))]
    before = ops.launch_counts()
    assert ops.flash_attention(q, k, v).grad_fn is None
    assert ops.moe_ffn(xs, *w).grad_fn is None
    q.requires_grad_()
    xs.requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
        assert ops.moe_ffn(xs, *w).grad_fn is None
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 2
    assert after["moe_ffn"] == before["moe_ffn"] + 2


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_reduced_training_on_card_matches_cpu(cuda, arch):
    """5 trainer steps of the reduced model in float32, card against CPU
    from the same weights: losses and grad norms within rtol 1e-3, the
    kernels launched once per layer per step in the forward and once more
    in the backward, which runs each layer's forward again under the
    default remat_policy "nothing"."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data.lm import DataConfig, TokenDataset
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig, cosine_schedule
    cfg = dataclasses.replace(configs.reduced_config(arch),
                              dtype=torch.float32)
    ocfg = AdamWConfig(lr=3e-4)
    cpu = train.init_state(cfg, ocfg, "cpu")
    states = {"cpu": cpu, "cuda": {
        "params": _to(cpu["params"], cuda),
        "opt": cpu["opt"]._replace(m=_to(cpu["opt"].m, cuda),
                                   v=_to(cpu["opt"].v, cuda))}}
    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size, batch_size=4,
                                   seq_len=32))
    before = ops.launch_counts()
    hist = {"cpu": [], "cuda": []}
    for step in range(5):
        lr = cosine_schedule(step, peak_lr=3e-4, warmup=2, total=5)
        for dev in ("cpu", "cuda"):
            batch = {k: v.to(dev) for k, v in data.batch(step).items()}
            states[dev], loss, gnorm = train.train_step(states[dev], cfg,
                                                        batch, ocfg, lr)
            hist[dev].append([float(loss), float(gnorm)])
    assert_allclose(hist["cuda"], hist["cpu"], rtol=1e-3)
    after = ops.launch_counts()
    per_layer = 2 if cfg.remat_policy != "none" else 1
    assert cfg.remat_policy == "nothing"
    assert after["flash_attention"] - before["flash_attention"] == \
        5 * cfg.num_layers * per_layer
    assert after["moe_ffn"] - before["moe_ffn"] == \
        (5 * cfg.num_layers * per_layer if cfg.moe else 0)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# -- B5's window and bidirectional builds, and head dim 112 -------------------
# Each mask a build of its own (64-row tiles at every S), held to the plain
# version: float32 at rtol = atol = 3e-5, bfloat16 at a relative L2 of
# 2e-2.  Windows below, at and past a 64-key block (a row's first visited
# block then lies wholly outside its window), W = 1, and a bidirectional
# S that is not a multiple of 64 (the zero-filled tail tile masked).
MASK_CASES = [((1, 300, 4, 112), 4, 1, True), ((1, 300, 4, 112), 4, 3, True),
              ((1, 300, 4, 112), 4, 100, True), ((2, 200, 8, 64), 2, 64, True),
              ((2, 200, 8, 64), 2, 199, True), ((2, 20, 2, 64), 2, 3, True),
              ((3, 130, 32), 0, 7, True), ((2, 150, 8, 64), 8, 0, False),
              ((2, 77, 8, 64), 2, 0, False), ((1, 1, 2, 16), 1, 0, False),
              ((2, 20, 4, 32), 4, 0, False), ((3, 130, 112), 0, 0, False),
              ((2, 200, 4, 112), 4, 0, True), ((2, 20, 4, 112), 2, 0, True)]


def _mask_name(window, causal):
    return "bidirectional" if not causal else "window" if window else \
        "causal"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kv_heads,window,causal", MASK_CASES)
def test_flash_attention_masked_builds_match_plain(cuda, shape, kv_heads,
                                                   window, causal, dtype):
    from repro_torch.kernels import flash_attention as kfa
    q, k, v = _attn_case(shape, kv_heads, sum(shape) + window, dtype, "cpu")
    ops.reset_launch_counts()
    got = ops.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                              window=window, causal=causal)
    build = kfa.plan(shape[-1], shape[-1], shape[1], dtype,
                     _mask_name(window, causal))["build"]
    assert ops.flash_attention_builds() == {build: 1}
    assert got.shape == q.shape and got.dtype == dtype
    want = ref.flash_attention_ref(q, k, v, window=window, causal=causal)
    if dtype == torch.float32:
        assert_allclose(got.cpu().numpy(), want.numpy(), rtol=3e-5,
                        atol=3e-5)
    else:
        assert _rel_l2(got, want) <= 2e-2


def test_flash_attention_window_build_at_w_1_is_v(cuda):
    """W = 1: each row sees only its own key, so o = v exactly (p = 1)."""
    q, k, v = _attn_case((2, 200, 4, 112), 4, 11, torch.float32, cuda)
    got = ops.flash_attention(q, k, v, window=1)
    assert torch.equal(got, v)


def test_flash_attention_refuses_masks_it_has_no_build_for(cuda):
    x = torch.zeros((1, 8, 2, 192), device=cuda, dtype=torch.bfloat16)
    v = torch.zeros((1, 8, 2, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="causal only"):
        ops.flash_attention(x, x, v, window=4)
    with pytest.raises(ValueError, match="a window is causal"):
        ops.flash_attention(v, v, v, window=4, causal=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,causal", [(5, True), (0, False)])
def test_flash_attention_masked_gradient_on_card(cuda, window, causal,
                                                 dtype):
    q, k, v = _grad_inputs(cuda, ((2, 90, 8, 112), (2, 90, 2, 112),
                                  (2, 90, 2, 112)), dtype, 7)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, window=window, causal=causal)
    assert ops.launch_counts()["flash_attention"] == 1
    gout = torch.randn_like(out)
    want_out = ops.attention_math(q, k, v, window=window, causal=causal)
    want = torch.autograd.grad(want_out, (q, k, v), gout)
    got = torch.autograd.grad(out, (q, k, v), gout)
    for a, b in zip(got, want):
        assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                        rtol=1e-5, atol=1e-5)
    o, w = out.detach().float(), want_out.detach().float()
    if dtype == torch.float32:
        assert bool(((o - w).abs() <= 3e-5 * (1 + w.abs())).all())
    else:
        assert float((o - w).norm() / w.norm()) <= 2e-2


@pytest.mark.parametrize("arch,over", [("zamba2-7b", {}),
                                       ("zamba2-7b", {"sliding_window": 3}),
                                       ("xlstm-125m", {}),
                                       ("whisper-base", {})])
def test_reduced_new_families_on_card_match_cpu(cuda, arch, over):
    """Reduced zamba2-7b (with and without its window), xlstm-125m and
    whisper-base in float32, card against CPU from the same weights: the
    prefill logits and six decode steps' logits within 1e-4, B5 once per
    shared-attention invocation or decoder layer (bidirectional once per
    encoder layer), none on the xLSTM."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import common, registry
    cfg = dataclasses.replace(configs.reduced_config(arch),
                              dtype=torch.float32, **over)
    gen = torch.Generator("cpu")
    gen.manual_seed(0)
    cpu = common.init_params(registry.param_specs(cfg), gen, "cpu")
    gpu = common.tree_map(lambda t: t.to(cuda), cpu)
    batch = registry.make_train_batch(cfg, 3, 40, 0)
    logits, steps = {}, {}
    for params, dev in ((gpu, cuda), (cpu, "cpu")):
        b = {k: t.to(dev) for k, t in batch.items()}
        ops.reset_launch_counts()
        logits[str(dev)] = registry.prefill(params, cfg, b).cpu()
        if dev == cuda:
            builds = ops.flash_attention_builds()
        cache = registry.init_cache(cfg, 3, 16, dev)
        out = []
        for pos in range(6):
            lg, cache = registry.decode_step(params, cfg, cache,
                                             b["tokens"][:, pos:pos + 1],
                                             pos)
            out.append(lg.cpu())
        steps[str(dev)] = torch.stack(out)
    assert_allclose(logits["cuda"].numpy(), logits["cpu"].numpy(),
                    rtol=1e-4, atol=1e-4)
    assert_allclose(steps["cuda"].numpy(), steps["cpu"].numpy(), rtol=1e-4,
                    atol=1e-4)
    if cfg.family == "hybrid":
        mask = "window" if cfg.sliding_window else "causal"
        want = {f"f32-{mask}": cfg.num_layers // cfg.attn_every}
    elif cfg.family == "audio":
        want = {"f32-causal": cfg.num_layers,
                "f32-bidirectional": cfg.encoder_layers}
    else:
        want = {}
    assert builds == want


def test_kernel_wrappers_refuse_cuda_dtensors(cuda):
    """B5's and B6's wrappers given CUDA DTensors raise (sharded execution
    on several cards is not ported); on the host mesh's 1 x 1 CUDA mesh a
    DTensor op runs."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
    rep = [Replicate(), Replicate()]
    x = distribute_tensor(torch.zeros((1, 4, 2, 16), device=cuda), mesh, rep)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.flash_attention(x, x, x)
    xs = distribute_tensor(torch.zeros((2, 3, 4), device=cuda), mesh, rep)
    w = distribute_tensor(torch.zeros((2, 4, 5), device=cuda), mesh, rep)
    wd = distribute_tensor(torch.zeros((2, 5, 4), device=cuda), mesh, rep)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.moe_ffn(xs, w, w, wd)
    assert float((x + 1).sum().full_tensor()) == 128.0


@pytest.mark.parametrize("policy", ["none", "nothing"])
def test_dryrun_temporaries_match_the_card_peak(cuda, policy):
    """One ``dryrun.make_train_step`` step of qwen2-0.5b at full width and
    2 layers on 8 x 128 tokens, bf16 weights from seed 0 and fp32 AdamW
    state, after a warm-up step: the card's peak, less what the process
    holds besides the step's arguments, within 15 % of the world-size-1
    trace's argument + temp bytes (the trace's arguments the card's);
    B5 once per layer under remat "none", twice under "nothing"."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.models import common, registry
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = dataclasses.replace(configs.get_config("qwen2-0.5b"),
                              num_layers=2, remat_policy=policy)
    B, S = 8, 128
    mem = dryrun.run_cell(cfg.name, "train", False, mesh_shape=(1, 1),
                          cfg=cfg, cell=ShapeCell("train", S, B, "train")
                          )["memory_analysis"]
    gen = torch.Generator("cuda").manual_seed(0)
    params = common.init_params(registry.param_specs(cfg), gen, cuda)
    ocfg = AdamWConfig(state_dtype=torch.float32)
    opt = adamw_init(params, ocfg)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                              device=cuda, generator=gen)
             for k in ("tokens", "labels")}
    step = dryrun.make_train_step(cfg, ocfg)
    params, opt, _, _ = step(params, opt, batch)            # warm-up
    torch.cuda.synchronize()
    args = sum(t.numel() * t.element_size() for t in dryrun.tree_leaves(
        (params, opt.m, opt.v, batch)))
    assert args == mem["argument_size_in_bytes"]
    other = torch.cuda.memory_allocated() - args
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()["flash_attention"]
    params, opt, loss, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - other
    assert torch.isfinite(loss).item()
    assert ops.launch_counts()["flash_attention"] - before == (
        cfg.num_layers * (1 if policy == "none" else 2))
    want = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert abs(peak / want - 1) <= 0.15, (peak, want)
