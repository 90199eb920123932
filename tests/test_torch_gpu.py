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
