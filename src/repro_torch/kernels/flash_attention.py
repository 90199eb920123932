"""CUDA kernel wrapper: flash attention (the backbone's prefill attention),
causal, causal within a sliding window, or bidirectional.

Replaces ``repro/kernels/flash_attention.py::flash_attention``.  The
kernel (``csrc/flash_attention.cu``) runs the TPU kernel's streaming
softmax (fp32 running max, sum and accumulator; ``p`` rounded to ``v``'s
type before ``p.v``; ``acc / max(l, 1e-30)``), one CTA per (batch x head,
64 query rows, or 32 for S <= 32), k/v blocks up to the diagonal only.
bfloat16 runs on the tensor cores (``mma.sync`` from bf16 tiles that
``cp.async`` loads into shared memory); float32 stays on plain FMAs, so
no TF32 rounding enters.  It reads q, k, v and writes the output in the
model's ``(B, S, H, hd)`` layout through strides, with grouped kv heads
read in place.  v may have a head dim of its own (MLA: q/k 192, v 128):
each (q/k, v) head-dim pair is a build of its own, and so is each mask
(:func:`plan`): causal; a window of ``W`` keys (zamba2's shared attention
under its long-context override; ``W`` a trailing kernel parameter), whose
CTAs start their k/v loop at the first block their rows can see; and
bidirectional (whisper's encoder).  ``score_dtype="bf16"`` (the model's
``attn_score_dtype``) runs a build of its own of the causal, window and
MLA builds that rounds each score to bf16 after the product and again
after the bf16 scale, as the reference's bf16 score slab; float32 inputs
are cast to bf16 for it, as the reference casts them, and the output cast
back.  Memory-bound at the backbone's shape.
See the source for the design.

This module always launches the kernel: :mod:`repro_torch.kernels.ops`
routes CPU tensors to the plain version before they reach it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._build import SMEM_LIMIT  # noqa: F401 (the plans' limit)
from .ref import mask_of

# Kernel launches since the last reset (repro_torch.kernels.ops), and the
# same launches by build (:func:`plan`'s ``build``).
launches = 0
launches_by_build: dict = {}

MAX_HEAD_DIM = 128
# The MLA build's q/k and v head dims (deepseek-v3: nope 128 + rope 64,
# v 128).
MLA_HEAD_DIMS = (192, 128)
# The masks, by their code in the C entry point.
MASKS = {"causal": 0, "window": 1, "bidirectional": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURE = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
    [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int]
SCORE_DTYPES = ("f32", "bf16")


def plan(D: int, Dv: int, S: int, dtype: torch.dtype,
         mask: str = "causal", score_dtype: str = "f32") -> dict:
    """The build a call runs (``csrc/flash_attention.cu``): ``path``
    ("mma" for bfloat16, "fma" for float32), the build's padded q/k and v
    head dims ``dq``, ``dv``, its ``warps`` (query rows / 16; the fp32
    path's 256 threads cover ``rows`` query rows), its k/v block ``bk``,
    the bf16 build's dynamic shared memory ``smem`` at two k/v stages, the
    ``mask`` and the ``build``'s name (the key of
    :data:`launches_by_build`).  The short-sequence tiles (32 rows for S
    <= 32) are the causal builds' only; a window or a bidirectional mask
    runs 64 rows at every S.  Raises ValueError for what no build takes:
    float32 D, Dv <= 128; bfloat16 D = Dv <= 128, or Dv < D <= 192 with
    Dv <= 128 (MLA, causal only).  ``score_dtype="bf16"`` plans the
    bf16-score build of the bf16 build (whatever ``dtype``: float32 inputs
    run it cast to bf16), its name ending in ``-s16``; it takes the causal
    and window masks, not the bidirectional one."""
    if mask not in MASKS:
        raise ValueError(f"flash_attention: mask {mask!r} (one of "
                         f"{sorted(MASKS)})")
    if score_dtype not in SCORE_DTYPES:
        raise ValueError(f"flash_attention: score dtype {score_dtype!r} "
                         f"(one of {SCORE_DTYPES})")
    if score_dtype == "bf16":
        if mask == "bidirectional":
            raise ValueError("flash_attention: bf16 scores are causal or "
                             "windowed (the reference's encoder attention "
                             "stays float32)")
        p = plan(D, Dv, S, torch.bfloat16, mask)
        return dict(p, score_dtype="bf16", build=p["build"] + "-s16")
    short = S <= 32 and mask == "causal"
    if dtype == torch.float32:
        if max(D, Dv) > MAX_HEAD_DIM:
            raise ValueError(f"flash_attention: head dim {max(D, Dv)} > "
                             f"{MAX_HEAD_DIM} in float32")
        rows = 32 if short else 64
        return dict(path="fma", dq=MAX_HEAD_DIM, dv=MAX_HEAD_DIM, warps=8,
                    rows=rows, bk=rows, smem=None, mask=mask,
                    build=f"f32-{mask}")
    if Dv < D <= MLA_HEAD_DIMS[0] and Dv <= MLA_HEAD_DIMS[1]:
        if mask != "causal":
            raise ValueError(f"flash_attention: the MLA build (head dims "
                             f"q/k {D}, v {Dv}) is causal only, not {mask}")
        dq, dv = MLA_HEAD_DIMS
    elif Dv == D <= MAX_HEAD_DIM:
        dq = dv = 32 if D <= 32 else 64 if D <= 64 else 128
    else:
        raise ValueError(f"flash_attention: head dims q/k {D}, v {Dv}: no "
                         f"build (D = Dv <= {MAX_HEAD_DIM}, or Dv < D <= "
                         f"{MLA_HEAD_DIMS[0]} with Dv <= {MLA_HEAD_DIMS[1]})")
    warps, bk = (2, 32) if short else (4, 64)
    smem = 2 * (16 * warps * (dq + 8) + 2 * bk * (dq + 8 + dv + 8))
    return dict(path="mma", dq=dq, dv=dv, warps=warps, rows=16 * warps,
                bk=bk, smem=smem, mask=mask, score_dtype="f32",
                build=f"bf16-{dq}x{dv}-{mask}")


def fma_smem_bytes(rows: int) -> int:
    """Dynamic shared memory of the float32 build at ``rows`` query rows
    (csrc/flash_attention.cu ``smem_bytes``): q, k and v tiles of ``rows``
    x (:data:`MAX_HEAD_DIM` + 1) floats, the scores and 3 floats a row."""
    return 4 * (3 * rows * (MAX_HEAD_DIM + 1) + rows * (rows + 1) + 3 * rows)


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        lib.flash_attention_init.restype = ctypes.c_int
        _build.check(lib.flash_attention_init(), "flash_attention (init)")
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None, window: int = 0,
                    causal: bool = True,
                    score_dtype: str = "f32") -> torch.Tensor:
    """Attention over ``(B, S, H, D)`` q, ``(B, S, K, D)`` k and ``(B, S,
    K, Dv)`` v (K divides H; head h reads kv head ``h // (H // K)``), or
    ``(BH, S, D)`` q, k and ``(BH, S, Dv)`` v: causal, causal within the
    last ``window`` keys (``window`` > 0), or bidirectional (``causal``
    false).  Unit stride over the head dims, any other strides; float32
    or bfloat16; the head dims of a build (:func:`plan`).  The scale
    defaults to ``D ** -0.5``, q's head dim.  ``score_dtype="bf16"``
    runs the bf16-score build (float32 q, k, v cast to bf16 first, the
    output cast back).  Returns a contiguous tensor of q's shape with v's
    head dim."""
    global launches
    if score_dtype == "bf16" and q.dtype != torch.bfloat16:
        return flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                               sm_scale, window, causal,
                               score_dtype).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if (q.dim() not in (3, 4) or k.dim() != q.dim()
            or v.shape[:-1] != k.shape[:-1]):
        raise ValueError("flash_attention: q (B, S, H, D) with k (B, S, K, "
                         "D) and v (B, S, K, Dv), or q, k (BH, S, D) and v "
                         "(BH, S, Dv)")
    q4, k4, v4 = ((t.unsqueeze(2) for t in (q, k, v)) if q.dim() == 3
                  else (q, k, v))
    B, S, H, D = q4.shape
    K, Dv = k4.shape[2], v4.shape[3]
    if (k4.shape[0], k4.shape[1], k4.shape[3]) != (B, S, D) or H % K:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} disagree")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} (float32 or "
                         "bfloat16)")
    mask = mask_of(window, causal)
    build = plan(D, Dv, S, q.dtype, mask, score_dtype)["build"]
    for name, t in (("q", q4), ("k", k4), ("v", v4)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be {q.dtype} "
                             f"on {q.device}")
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride "
                             "over the head dim")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: tensors on {q.device}, but the "
                         f"current device is {torch.cuda.current_device()}")
    o4 = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    out = o4.squeeze(2) if q.dim() == 3 else o4
    if B * S * H * D * Dv == 0:
        return out
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q4, k4, v4, o4) for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_attention_launch(
        _DTYPES[q.dtype], q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
        o4.data_ptr(), B, H, K, S, D, Dv, strides,
        float(sm_scale),  # repro: allow[R004] host scale
        stream, MASKS[mask], int(window), int(score_dtype == "bf16"))
    launches += 1
    launches_by_build[build] = launches_by_build.get(build, 0) + 1
    _build.check(rc, "flash_attention")
    return out
