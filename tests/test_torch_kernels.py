"""The port's kernel layer (repro_torch.kernels) against the JAX package.

The plain PyTorch versions run on the CPU against the reference's
Pallas kernels in interpret mode and its jnp references; the CUDA
kernels themselves need a card: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold them against the plain versions there.
Tolerances: rtol = atol = 3e-5 for scores (float32 sums in another
order), labels equal.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core.oracles.chain import viterbi_decode as jax_viterbi_decode
from repro.kernels import plane_scores as jax_ps
from repro.kernels import ref as jax_ref
from repro.kernels import viterbi as jax_vit
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import plane_scores as t_ps
from repro_torch.kernels import viterbi as t_vit

TOL = dict(rtol=3e-5, atol=3e-5)


def _planes(seed, n, d):
    r = np.random.RandomState(seed)
    block = r.randn(n, d + 1).astype(np.float32)
    return block, r.randn(d).astype(np.float32)


@pytest.mark.parametrize("n,d", [(1, 1), (7, 127), (64, 4004 // 8),
                                 (65, 300), (130, 128)])
def test_plane_scores_ref_matches_pallas(n, d):
    """Strided views of a (n, d+1) block, as the cache hands them over."""
    block, w = _planes(n * 1000 + d, n, d)
    P, b = block[:, :-1], block[:, -1]
    want = np.asarray(jax_ps.plane_scores(jnp.asarray(P), jnp.asarray(w),
                                          jnp.asarray(b), interpret=True))
    tb = torch.from_numpy(block)
    got = ops.plane_scores(tb[:, :-1], torch.from_numpy(w), tb[:, -1])
    assert_allclose(got.numpy(), want, **TOL)
    assert_allclose(ref.plane_scores_ref(tb[:, :-1], torch.from_numpy(w),
                                         tb[:, -1]).numpy(),
                    np.asarray(jax_ref.plane_scores_ref(
                        jnp.asarray(P), jnp.asarray(w), jnp.asarray(b))),
                    **TOL)


def _warp_emulation(P, w, b):
    """The CUDA kernel's order of operations, in numpy float32: lane k
    sums columns k, k+32, ...; a xor-shuffle butterfly reduces the
    lanes; the offset is added last."""
    n, d = P.shape
    out = np.zeros(n, np.float32)
    for r in range(n):
        lanes = np.zeros(32, np.float32)
        for j in range(d):
            lanes[j % 32] = np.float32(lanes[j % 32]
                                       + np.float32(P[r, j] * w[j]))
        off = 16
        while off:
            lanes = (lanes + lanes[np.arange(32) ^ off]).astype(np.float32)
            off //= 2
        out[r] = lanes[0] + b[r]
    return out


@pytest.mark.parametrize("n,d", [(3, 1), (5, 33), (9, 200)])
def test_plane_scores_kernel_order_matches_plain(n, d):
    """The kernel's per-lane accumulation and warp reduction (emulated on
    the CPU) agree with the plain version within the kernel tolerance."""
    block, w = _planes(n + d, n, d)
    emu = _warp_emulation(block[:, :-1], w, block[:, -1])
    tb = torch.from_numpy(block)
    want = ref.plane_scores_ref(tb[:, :-1], torch.from_numpy(w), tb[:, -1])
    assert_allclose(emu, want.numpy(), **TOL)


def _viterbi_case(seed, B, L, C, tie=False):
    r = np.random.RandomState(seed)
    if tie:   # small integers: many exactly equal candidates
        unary = r.randint(-2, 3, (B, L, C)).astype(np.float32)
        trans = r.randint(-2, 3, (C, C)).astype(np.float32)
    else:
        unary = r.randn(B, L, C).astype(np.float32)
        trans = r.randn(C, C).astype(np.float32)
    lens = r.randint(1, L + 1, size=B)
    lens[0] = L
    mask = np.arange(L)[None, :] < lens[:, None]
    return unary, trans, mask


VITERBI_CASES = [(1, 1, 4, 0, False), (3, 9, 5, 1, False),
                 (8, 14, 26, 2, False), (13, 7, 26, 3, True),
                 (6, 14, 26, 4, True), (5, 8, 3, 5, True)]


@pytest.mark.parametrize("B,L,C,seed,tie", VITERBI_CASES)
def test_viterbi_ref_matches_chain_decode(B, L, C, seed, tie):
    """Every row equals the reference oracle's per-example DP, padded
    tails and ties included (all positions, not only the valid prefix)."""
    unary, trans, mask = _viterbi_case(seed, B, L, C, tie)
    got = ops.viterbi_decode(torch.from_numpy(unary), torch.from_numpy(trans),
                             torch.from_numpy(mask)).numpy()
    assert got.dtype == np.int32 and got.shape == (B, L)
    for b in range(B):
        want = np.asarray(jax_viterbi_decode(
            jnp.asarray(unary[b]), jnp.asarray(trans), jnp.asarray(mask[b])))
        assert (got[b] == want).all(), f"row {b}"


@pytest.mark.parametrize("B,L,C,seed,tie", VITERBI_CASES[1:4])
def test_viterbi_ref_matches_pallas_decode_batch(B, L, C, seed, tie):
    """The batched decode with the Pallas step in interpret mode."""
    unary, trans, mask = _viterbi_case(seed, B, L, C, tie)
    want = np.asarray(jax_vit.viterbi_decode_batch(
        jnp.asarray(unary), jnp.asarray(trans), jnp.asarray(mask),
        step_fn=functools.partial(jax_vit.viterbi_step, block_b=8,
                                  interpret=True)))
    got = ref.viterbi_decode_ref(torch.from_numpy(unary),
                                 torch.from_numpy(trans),
                                 torch.from_numpy(mask)).numpy()
    assert (got == want).all()


def test_viterbi_step_ref_matches_jnp():
    r = np.random.RandomState(9)
    m = r.randint(-2, 3, (4, 6)).astype(np.float32)
    t = r.randint(-2, 3, (6, 6)).astype(np.float32)
    best, back = ref.viterbi_step_ref(torch.from_numpy(m), torch.from_numpy(t))
    jb, jback = jax_ref.viterbi_step_ref(jnp.asarray(m), jnp.asarray(t))
    assert (best.numpy() == np.asarray(jb)).all()
    assert (back.numpy() == np.asarray(jback)).all()


def test_cpu_tensors_take_the_plain_path_without_launching():
    ops.reset_launch_counts()
    block, w = _planes(0, 4, 8)
    tb = torch.from_numpy(block)
    ops.plane_scores(tb[:, :-1], torch.from_numpy(w), tb[:, -1])
    u, t, m = _viterbi_case(0, 2, 5, 3)
    ops.viterbi_decode(torch.from_numpy(u), torch.from_numpy(t),
                       torch.from_numpy(m))
    assert ops.launch_counts() == {"plane_scores": 0, "viterbi_decode": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes the
    plain version itself."""
    block, w = _planes(1, 4, 8)
    tb = torch.from_numpy(block)
    with pytest.raises(ValueError, match="CUDA"):
        t_ps.plane_scores(tb[:, :-1], torch.from_numpy(w), tb[:, -1])
    u, t, m = _viterbi_case(1, 2, 5, 3)
    with pytest.raises(ValueError, match="CUDA"):
        t_vit.viterbi_decode(torch.from_numpy(u), torch.from_numpy(t),
                             torch.from_numpy(m))
    assert t_ps.launches == 0 and t_vit.launches == 0


def test_viterbi_label_limit_fits_shared_memory():
    C = t_vit.MAX_LABELS
    assert (C * C + 2 * C) * 4 <= t_vit.SMEM_BYTES
    assert ((C + 1) ** 2 + 2 * (C + 1)) * 4 > t_vit.SMEM_BYTES
    assert C >= 26


def test_build_keys_sources_and_flags():
    """Libraries are keyed by source hash into the git-ignored build dir,
    compiled for sm_90a; nothing is built at import."""
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        path = _build.library_path(name)
        assert path.parent == _build.build_dir()
        assert path.name.startswith(name + "-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.build_dir().parts[-2:] == ("build", "repro_torch")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check(9, "k")
    _build.check(0, "k")
