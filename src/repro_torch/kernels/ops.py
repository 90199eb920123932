"""Device dispatch for the port's kernels.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain version in :mod:`.ref`.  The
choice rests on the tensor's device alone: there is no switch, and no
fallback from a failed build or launch.  One kernel differs:
:func:`approx_pass` runs a whole MP-BCFW pass, whose plain version is
made of the core's block steps and lives in the core, which makes the
choice there (:func:`repro_torch.core.mpbcfw.run_pass`).

Each kernel module keeps a plain integer launch counter (``launches``),
read and reset here, so a run can show that its main path went through
the kernels.  A wrapper counts when it launches; a kernel captured into a
CUDA graph launches again on every replay, which the graph's runner adds
with :func:`add_launches`.

Two kernels sit on a path that needs gradients: training runs
:func:`flash_attention` and :func:`moe_ffn` in every forward.  A kernel
launch through ``ctypes`` carries no ``grad_fn``, so when an input needs
a gradient, each wrapper launches its kernel inside a
``torch.autograd.Function`` (:class:`FlashAttention`, :class:`MoeFFN`)
whose backward recomputes, at the saved inputs, the differentiable math
the reference's training runs (it never differentiates a Pallas kernel)
and takes its vector-Jacobian product: the chunked causal attention over
the repeated kv heads, and the einsum SwiGLU.  Inputs that need no
gradient take the plain launch, so serving and feature extraction are
unchanged.

The reference's ``kernels/ops.py`` defines ``viterbi_step`` twice (lines
78 and 107).  Here the max-plus step exists once, as
:func:`.ref.viterbi_step_ref`, and the kernel layer exposes the
whole-sequence :func:`viterbi_decode`, which fuses the step with its scan.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import approx_pass as _ap
from . import flash_attention as _fa
from . import gram as _gram
from . import moe_ffn as _moe
from . import plane_scores as _ps
from . import plane_select as _psel
from . import ref
from . import viterbi as _vit

# The one invalid-slot score sentinel (defined in :mod:`.ref`, whose plain
# versions mask with it).
INVALID_SCORE = ref.INVALID_SCORE
# The query chunk of the attention backward's recompute
# (``ModelConfig.attn_chunk``'s default).
ATTN_CHUNK = 1024

_KERNELS = {"plane_scores": _ps, "plane_select": _psel,
            "viterbi_decode": _vit, "moe_ffn": _moe,
            "flash_attention": _fa, "gram": _gram, "approx_pass": _ap}


def plane_scores(planes: torch.Tensor, w: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """``scores[r] = <planes[r], w> + offsets[r]`` for ``(N, d)`` planes."""
    if planes.device.type == "cpu":
        return ref.plane_scores_ref(planes, w, offsets)
    return _ps.plane_scores(planes, w, offsets)


def plane_scores_masked(planes: torch.Tensor, w: torch.Tensor,
                        offsets: torch.Tensor, valid: torch.Tensor,
                        neg: float = INVALID_SCORE) -> torch.Tensor:
    """Masked plane scoring over a flattened cache view: ``planes (m, d)``,
    ``offsets (m,)`` and ``valid (m,)`` as :func:`repro_torch.cache
    .flat_view` lays them out (the whole cache, or one rank's ``(n_local
    * cap, d)`` part of it: the launch scores the rows it is given, with
    no gather).  :func:`plane_scores`, then ``neg`` on the invalid slots,
    so they never win an argmax."""
    scores = plane_scores(planes, w, offsets)
    return torch.where(valid, scores, torch.full_like(scores, neg))


def plane_select(planes: torch.Tensor, w: torch.Tensor,
                 offsets: torch.Tensor, valid: torch.Tensor,
                 rows: Optional[torch.Tensor] = None,
                 neg: float = INVALID_SCORE
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best valid slot per cache row of ``(n, cap, d)`` planes, rows
    ``rows`` (int64, default all): ``(best (k,) float32, idx (k,)
    int32)``, first maximum on ties; ``(neg, 0)`` for a row with no valid
    slot."""
    if planes.device.type == "cpu":
        return ref.plane_select_ref(planes, w, offsets, valid, rows, neg)
    return _psel.plane_select(planes, w, offsets, valid, rows, neg=neg)


def gram(planes: torch.Tensor) -> torch.Tensor:
    """``G[a, b] = <planes[a], planes[b]>``: ``(N, d)`` float32 planes (any
    row stride) -> ``(N, N)`` float32, exactly symmetric on CUDA."""
    if planes.device.type == "cpu":
        return ref.gram_ref(planes)
    return _gram.gram(planes)


def viterbi_decode(unary: torch.Tensor, trans: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Batched masked Viterbi: ``(B, L, C)``, ``(C, C)``, ``(B, L)`` ->
    ``(B, L)`` int32 labels, each row ``chain.viterbi_decode``."""
    if unary.device.type == "cpu":
        return ref.viterbi_decode_ref(unary, trans, mask)
    return _vit.viterbi_decode(unary, trans, mask)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _vjp(fn, inputs, needs, grad_out) -> tuple:
    """``fn``'s vector-Jacobian product with ``grad_out``, recomputed with
    autograd at ``inputs``, for the inputs that ``needs`` marks (None for
    the others)."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs,
                                                                 needs)]
        out = fn(*xs)
        got = iter(torch.autograd.grad(out, [x for x in xs
                                             if x.requires_grad], grad_out))
    return tuple(next(got) if n else None for n in needs)


def moe_ffn_math(xs: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                 wd: torch.Tensor) -> torch.Tensor:
    """The expert FFN as the reference computes it off the TPU
    (``repro/models/moe.py:66-70``): three einsums in the input type, the
    function whose gradient :class:`MoeFFN` takes."""
    g = torch.einsum("ecd,edf->ecf", xs, wg)
    u = torch.einsum("ecd,edf->ecf", xs, wu)
    return torch.einsum("ecf,efd->ecd", torch.nn.functional.silu(g) * u, wd)


class MoeFFN(torch.autograd.Function):
    """The expert FFN with a gradient: the forward launches the kernel
    (the plain version for CPU tensors), the backward is the VJP of
    :func:`moe_ffn_math` at the saved inputs."""

    @staticmethod
    def forward(ctx, xs, wg, wu, wd):
        ctx.save_for_backward(xs, wg, wu, wd)
        if xs.device.type == "cpu":
            return ref.moe_ffn_ref(xs, wg, wu, wd)
        return _moe.moe_ffn(xs, wg, wu, wd)

    @staticmethod
    def backward(ctx, grad_out):
        return _vjp(moe_ffn_math, ctx.saved_tensors, ctx.needs_input_grad,
                    grad_out)


def attention_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sm_scale: Optional[float] = None, window: int = 0,
                   causal: bool = True,
                   score_dtype: str = "f32") -> torch.Tensor:
    """Attention as the reference's model computes it in training
    (``repro/models/attention.py:158``, whatever the device): causal, the
    chunked causal attention of :mod:`repro_torch.models.attention` (with
    its ``sliding_window`` = ``window``) over the kv heads repeated to
    q's, in ``ModelConfig.attn_chunk``'s default query chunks (chunking
    splits rows, not sums); bidirectional (``causal`` false), the
    encoder's float32 einsum softmax
    (``repro/models/encdec.py::_bidir_attention``).  Takes
    :func:`flash_attention`'s shapes, v's head dim its own (MLA); the
    function whose gradient :class:`FlashAttention` takes."""
    from ..models.attention import (bidirectional_attention,
                                    chunked_causal_attention, repeat_kv)
    if q.dim() == 3:
        return attention_math(q[:, :, None], k[:, :, None], v[:, :, None],
                              sm_scale, window, causal,
                              score_dtype)[:, :, 0]
    mask = ref.mask_of(window, causal)
    D = q.shape[3]
    if sm_scale is not None and sm_scale != D ** -0.5:
        q = q * (sm_scale * D ** 0.5)
    H = q.shape[2]
    k, v = repeat_kv(k, H), repeat_kv(v, H)
    if mask == "bidirectional":
        if score_dtype != "f32":
            raise ValueError("attention: bf16 scores are causal or windowed")
        return bidirectional_attention(q, k, v)
    return chunked_causal_attention(q, k, v, ATTN_CHUNK, window,
                                    score_dtype=score_dtype)


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward launches the flash kernel
    (the plain version for CPU tensors), the backward is the VJP of
    :func:`attention_math` at the saved inputs, under the same mask."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, window=0, causal=True,
                score_dtype="f32"):
        ctx.save_for_backward(q, k, v)
        ctx.sm_scale, ctx.window, ctx.causal = sm_scale, window, causal
        ctx.score_dtype = score_dtype
        if q.device.type == "cpu":
            return ref.flash_attention_ref(q, k, v, sm_scale, window, causal,
                                           score_dtype)
        return _fa.flash_attention(q, k, v, sm_scale, window, causal,
                                   score_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        return _vjp(lambda q, k, v: attention_math(
            q, k, v, ctx.sm_scale, ctx.window, ctx.causal, ctx.score_dtype),
            ctx.saved_tensors, ctx.needs_input_grad[:3],
            grad_out) + (None, None, None, None)


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The stride of a contiguous tensor of ``shape``, as ``torch.empty``
    gives it (a dim of size 0 strides as one of size 1), read from the
    shape alone: no tensor is made for it."""
    stride, step = [], 1
    for n in reversed(tuple(shape)):
        stride.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(stride))


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _on_shards(name: str, plain, keep_dim: int, ref_t: torch.Tensor,
               *args: torch.Tensor) -> torch.Tensor:
    """A kernel's call on DTensors: on the CPU, its plain version on each
    rank's local shards through ``local_map``, every argument placed as
    ``ref_t`` is along tensor dim ``keep_dim`` (experts, batch) and
    replicated along the others; the output placed so too.  On CUDA it
    raises: sharded execution on several cards waits for a host with more
    than one H100."""
    if ref_t.device.type != "cpu":
        raise NotImplementedError(
            f"{name} on CUDA DTensors: sharded execution on several cards "
            "is not ported (ROADMAP §A item 8 follow-ups: it waits for a "
            "host with more than one H100)")
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ref_t.device_mesh
    plc = [Shard(keep_dim) if p.is_shard() and p.dim == keep_dim
           else Replicate() for p in ref_t.placements]
    args = [a.redistribute(mesh, plc) if _is_dtensor(a) else a for a in args]
    return local_map(plain, out_placements=plc,
                     in_placements=tuple(plc if _is_dtensor(a) else None
                                         for a in args),
                     device_mesh=mesh)(*args)


def _experts_on_shards(xs: torch.Tensor, wg: torch.Tensor,
                       wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """:func:`moe_ffn` on DTensors: on the CPU, its plain version on each
    rank's local shards, mesh axis by mesh axis: where
    ``wg`` shards the experts (dim 0), every argument's experts sharded
    alike; else where ``xs`` shards its capacity rows (dim 1), ``xs``'s
    rows against whole weights, whose gradients are partial sums over
    that axis; else all replicated.  The output is placed as ``xs``.  On
    CUDA it raises, as :func:`_on_shards`."""
    ref_t = wg if _is_dtensor(wg) else xs
    if ref_t.device.type != "cpu":
        raise NotImplementedError(
            "moe_ffn on CUDA DTensors: sharded execution on several cards "
            "is not ported (ROADMAP §A item 8 follow-ups: it waits for a "
            "host with more than one H100)")
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = ref_t.device_mesh
    rep = (Replicate(),) * mesh.ndim
    wp = wg.placements if _is_dtensor(wg) else rep
    xp = xs.placements if _is_dtensor(xs) else rep
    x_plc, w_plc, g_plc = [], [], []
    for pw, px in zip(wp, xp):
        if pw.is_shard() and pw.dim == 0:
            x_plc.append(Shard(0))
            w_plc.append(Shard(0))
            g_plc.append(Shard(0))
        elif px.is_shard() and px.dim == 1:
            x_plc.append(Shard(1))
            w_plc.append(Replicate())
            g_plc.append(Partial())
        else:
            x_plc.append(Replicate())
            w_plc.append(Replicate())
            g_plc.append(Replicate())
    # Each argument's local shard (its gradient placed as ``g_plc``) and
    # the output built at ``xs``'s global shape: capacity rows that the
    # batch axes do not divide leave the shards uneven, which
    # ``local_map`` would take for even ones.
    local = [a.redistribute(mesh, plc).to_local(grad_placements=g)
             if _is_dtensor(a) else a for a, plc, g in zip(
                 (xs, wg, wu, wd), (x_plc,) + (w_plc,) * 3,
                 (x_plc,) + (g_plc,) * 3)]
    return DTensor.from_local(ref.moe_ffn_ref(*local), mesh, x_plc,
                              run_check=False, shape=xs.shape,
                              stride=contiguous_stride(xs.shape))


def moe_ffn(xs: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            wd: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU expert FFN: ``xs (E, C, D)``, ``wg``/``wu (E, D,
    F)``, ``wd (E, F, D)`` -> ``(E, C, D)`` in ``xs``'s dtype.  On CUDA
    tensors that need a gradient, through :class:`MoeFFN`.  On DTensors
    (CPU), the plain version on each rank's experts and capacity rows
    (:func:`_experts_on_shards`)."""
    if _is_dtensor(wg) or _is_dtensor(xs):
        return _experts_on_shards(xs, wg, wu, wd)
    if xs.device.type == "cpu":
        return ref.moe_ffn_ref(xs, wg, wu, wd)
    if _needs_grad(xs, wg, wu, wd):
        return MoeFFN.apply(xs, wg, wu, wd)
    return _moe.moe_ffn(xs, wg, wu, wd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None, window: int = 0,
                    causal: bool = True,
                    score_dtype: str = "f32") -> torch.Tensor:
    """Attention over ``(BH, S, D)`` q, k, v, or ``(B, S, H, D)`` q with
    ``(B, S, K, D)`` k, v (K divides H: grouped kv heads), in q's dtype
    and shape; v may have a head dim of its own (MLA), which the output
    takes.  Causal by default; ``window`` > 0 keeps each row's last
    ``window`` keys (a sliding window), ``causal`` false sees every key
    (bidirectional).  ``score_dtype="bf16"`` takes the scores in bf16
    (causal or windowed; the kernel's bf16-score build, float32 inputs
    cast to bf16 for it).  On CUDA tensors that need a gradient, through
    :class:`FlashAttention`.  On DTensors (CPU), the plain version on each
    rank's batch shard."""
    if _is_dtensor(q):
        return _on_shards("flash_attention", lambda a, b, c: (
            ref.flash_attention_ref(a, b, c, sm_scale, window, causal,
                                    score_dtype)), 0, q, q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, sm_scale, window, causal,
                                       score_dtype)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, sm_scale, window, causal,
                                    score_dtype)
    return _fa.flash_attention(q, k, v, sm_scale, window, causal,
                               score_dtype)


def approx_pass(phi: torch.Tensor, phi_i: torch.Tensor, bar: torch.Tensor,
                planes: torch.Tensor, valid: torch.Tensor,
                last_active: torch.Tensor, perm: torch.Tensor, *,
                lam: float, k0: int, outer_it: int,
                gram: Optional[torch.Tensor] = None,
                steps: Optional[int] = None,
                go: Optional[torch.Tensor] = None,
                gap: Optional[torch.Tensor] = None,
                k_stride: int = 1) -> None:
    """One approximate pass of MP-BCFW over the blocks of ``perm`` (int64,
    on the state's device), in place on the dual state ``phi (d+1,)``,
    ``phi_i (n, d+1)``, the approximate-track average ``bar (d+1,)`` (its
    count at pass start is ``k0``, advancing by ``k_stride`` per block:
    the shard engine's S) and the cache's ``last_active``
    stamps (``outer_it``).  ``steps`` selects the Sec-3.5 scheme over the
    ``gram`` leaf.  A ``go`` flag (one-element bool tensor) that is false
    makes the pass a no-op; the kernel reads it, not the host.  In the
    plain mode a ``gap`` vector (float32 ``(n,)``) takes each visited
    block's gap estimate, ``max(s - <phi_i, [w 1]>, 0)`` with ``s`` the
    chosen plane's score (0 for an empty set) and ``phi_i`` the row
    before its update; the Sec-3.5 mode refuses it.

    CUDA tensors only.  The plain version is built from the core's block
    steps, so it lives in the core (:func:`repro_torch.core.mpbcfw.
    eager_pass`), and :func:`repro_torch.core.mpbcfw.run_pass` chooses
    between the two by the state's device."""
    return _ap.approx_pass(phi, phi_i, bar, planes, valid, last_active, perm,
                           lam=lam, k0=k0, outer_it=outer_it, gram=gram,
                           steps=steps, go=go, gap=gap, k_stride=k_stride)


def load(*names: str) -> None:
    """Build, load and initialise the named kernels without launching
    them: the work before a kernel's first launch that a CUDA-graph
    capture cannot record."""
    for name in names:
        _KERNELS[name]._lib()


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def flash_attention_builds() -> Dict[str, int]:
    """:func:`flash_attention`'s launches since the last
    :func:`reset_launch_counts`, by build (``flash_attention.plan``'s
    ``build``: dtype, padded head dims and mask)."""
    return dict(_fa.launches_by_build)


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
    _fa.launches_by_build.clear()


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set the counters to ``counts`` (a :func:`launch_counts` dict)."""
    for name, mod in _KERNELS.items():
        mod.launches = counts[name]


def add_launches(counts: Dict[str, int]) -> None:
    """Count launches made outside the wrappers: a replayed CUDA graph
    runs the kernels its capture counted (:mod:`repro_torch.core.graphs`).
    """
    for name, k in counts.items():
        _KERNELS[name].launches += k
