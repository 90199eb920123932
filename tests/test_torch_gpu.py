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


@pytest.mark.parametrize("B,L,C,seed,tie", [
    (1, 1, 4, 0, False), (1, 14, 26, 1, False), (1, 14, 26, 2, True),
    (6877, 14, 26, 3, False), (513, 14, 26, 4, True), (9, 8, 109, 5, True)])
def test_viterbi_kernel_matches_plain(cuda, B, L, C, seed, tie):
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
    args = [torch.from_numpy(a) for a in (unary, trans, mask)]
    got = ops.viterbi_decode(*(a.to(cuda) for a in args))
    assert torch.equal(got.cpu(), ref.viterbi_decode_ref(*args))


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
