"""Layer 3: the port's kernels against the card (the counterpart of the
reference's ``repro/analysis/hlo.py`` rules H003 and H004).

The reference proves its Pallas tiling policies (8, 128)-aligned by
sweeping the policy functions (H003) and proves every traced program
compiles (H004).  The port's kernels are hand-written CUDA whose launches
come from the ``plan()`` functions of :mod:`repro_torch.kernels`, so:

  * **H003** (on the CPU) -- every plan over a sweep of shapes (the
    reference's ``_TILE_SHAPES`` mapped onto each kernel's arguments, the
    shapes the port's paths launch, and the ten model configs' attention
    and expert shapes at published width) gives a launch that its build
    takes and that fits the card: shared memory (static + dynamic, as the
    plan reckons it) within :data:`repro_torch.kernels._build.SMEM_LIMIT`;
    every 16-byte ``cp.async``, bulk copy and TMA box, pitch and stride a
    multiple of 16 bytes; whole ``wgmma`` and ``mma.sync`` tiles; the grid,
    the block and the cluster within the card's limits (a cluster above 8
    only where the source asks for the non-portable size); the build one
    of its source's table (``csrc/builds.cuh``) that holds the call's
    dims.  Every build in a source's table must be reached by the sweep.
    A shape a plan refuses (ValueError) is no finding: it never launches.
  * **H004** (on the card) -- every build compiles for ``sm_90a``, loads,
    and holds to its plans: a launch's dynamic shared memory within the
    build's granted maximum, the card's static shared memory no more than
    the plan reckons, no local memory (a spill) that its plan module does
    not waive (``SPILL_WAIVERS``), threads within the build's maximum, at
    least one CTA (or cluster) resident; the ``-Xptxas -v`` log's
    registers and spills per function agree with the card's attributes.

H001/H002 (XLA's collectives against the jaxpr's) have their stand-in in
the program layer's J001/J002: a torch program has no compiler between it
and its collectives, and the program layer counts each one dispatched.
"""
from __future__ import annotations

import importlib
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..kernels import _build
from .findings import Finding

#: The card's limits for a launch (compute capability 9.0).
MAX_THREADS = 1024
MAX_GRID = (2 ** 31 - 1, 65535, 65535)
PORTABLE_CLUSTER = 8
MAX_CLUSTER = 16

#: The reference's H003 sweep (``repro/analysis/hlo.py``): (rows or batch,
#: width or labels) pairs, tiny, awkward and aligned; and its labels.
TILE_SHAPES = ((1, 1), (3, 7), (8, 128), (17, 129), (63, 500),
               (128, 512), (1000, 1024), (257, 4097))
LABELS = (1, 3, 26, 127, 128, 129, 500)
#: Widths beyond the reference's: one for each of the staged pass's
#: per-thread builds past 4096, the SSVM head's planes over OLMoE's
#: features, the wide plans' (Mistral-NeMo's and Qwen2.5's) and one past
#: what plane_select stages beside w.
WIDTHS = (8000, 10265, 16000, 20505, 25625, 102400)
#: Prompt lengths of a short prefill (the serving prompt, one short tile).
SHORT = (4, 32)


@dataclass(frozen=True)
class Launch:
    """One kernel launch as a plan gives it."""

    kernel: str                     # the source, csrc/<kernel>.cu
    shape: str                      # the call, for a finding's place
    build: str                      # the instantiation, "name<args>"
    threads: int
    grid: Tuple[int, int, int]
    dyn_smem: int
    static_smem: int = 0
    cluster: int = 1                # CTAs per cluster (along grid y)
    #: (what, bytes): 16-byte copies, bulk copies and TMA boxes, their
    #: shared-memory slots, pitches and global strides
    aligned: Tuple[Tuple[str, int], ...] = ()
    #: (instruction, M, N, K) of each matrix-multiply tile
    tiles: Tuple[Tuple[str, int, int, int], ...] = ()
    #: (what, the call's, the build's): the build must hold the call
    holds: Tuple[Tuple[str, int, int], ...] = ()

    @property
    def where(self) -> str:
        return f"kernels/{self.kernel}.py::plan({self.shape})"


@dataclass(frozen=True)
class Source:
    """What the checker reads from ``csrc/<name>.cu`` on the CPU."""

    name: str
    builds: Tuple[str, ...]         # the build table, in its order
    nonportable: bool               # asks for clusters above 8


def _norm(build: str) -> str:
    name, args = build.split("<", 1)
    args = [a.strip() for a in args.rstrip(">").split(",")]
    return f"{name.strip()}<{', '.join(args)}>"


def read_source(name: str, text: Optional[str] = None) -> Source:
    """The build table (``REPRO_BUILD(smem, kernel<args>)`` entries) and
    the cluster flag of ``csrc/<name>.cu`` (or of ``text``)."""
    if text is None:
        text = (_build.CSRC / f"{name}.cu").read_text()
    builds = []
    for m in re.finditer(r"\bREPRO_BUILD\(", text):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        body = text[m.end():i - 1]
        kernel = re.search(r"([A-Za-z_]\w*\s*<[^<>]*>)\s*$", body)
        if kernel:
            builds.append(_norm(kernel.group(1)))
    return Source(name, tuple(builds),
                  "cudaFuncAttributeNonPortableClusterSizeAllowed" in text)


def sources() -> Dict[str, Source]:
    return {name: read_source(name) for name in _build.SOURCES}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _flag(b: bool) -> str:
    return "true" if b else "false"


# ---------------------------------------------------------------------------
# Each kernel's launches from its plan (ValueError: refused by design)


def plane_scores_launches(n: int, d: int) -> List[Launch]:
    from ..kernels import plane_scores as m
    rows, stages = m.plan(n)
    return [Launch("plane_scores", f"n={n}, d={d}",
                   f"plane_scores_kernel<{stages}>", 32 * rows,
                   (_cdiv(n, rows), 1, 1), m.smem_bytes(rows, stages))]


def plane_select_launches(k: int, cap: int, d: int) -> List[Launch]:
    from ..kernels import plane_select as m
    how = m.plan(k, cap, d)
    slot = 4 * ((min(d, how.chunk) + 6 + 3) // 4 * 4)
    aligned = [("ring slot (bulk copy)", slot), ("layout", how.smem_bytes)]
    if how.w_shared:
        aligned.append(("w slot (bulk copy)", 4 * ((d + 6 + 3) // 4 * 4)))
    return [Launch("plane_select", f"k={k}, cap={cap}, d={d}",
                   f"plane_select_kernel<{_flag(how.w_shared)}>",
                   32 * m.WARPS, (_cdiv(k, how.rows), 1, 1),
                   how.smem_bytes, aligned=tuple(aligned))]


def viterbi_launches(B: int, L: int, C: int) -> List[Launch]:
    from ..kernels import viterbi as m
    if C > m.MAX_LABELS or L < 1 or C < 1:   # the wrapper refuses these
        raise ValueError(f"viterbi_decode: (L, C) = ({L}, {C})")
    how = m.plan(L, C)
    if C <= 32:     # one warp, candidates in groups of four
        build = f"viterbi_warp_kernel<{_cdiv(C, 4)}, {_flag(how.staged)}>"
        threads, labels = 32, 4 * _cdiv(C, 4)
    else:           # one thread a label
        build = f"viterbi_block_kernel<{_flag(how.staged)}>"
        threads = labels = _cdiv(C, 32) * 32
    return [Launch("viterbi", f"B={B}, L={L}, C={C}", build, threads,
                   (B, 1, 1), how.smem_bytes,
                   holds=(("labels", C, labels),))]


def gram_launches(n: int, d: int) -> List[Launch]:
    from ..kernels import gram as m
    tile, split = m.plan(n, d)
    t = _cdiv(n, tile)
    return [Launch("gram", f"n={n}, d={d}", f"gram_kernel<{tile}>",
                   m.THREADS, (t * (t + 1) // 2, split, 1),
                   m.smem_bytes(tile), cluster=split,
                   aligned=(("panel pitch", 4 * (tile + 4)),))]


def flash_launches(B: int, S: int, H: int, K: int, D: int, Dv: int,
                   dtype: str, mask: str, score: str) -> List[Launch]:
    """The build a call runs, from :func:`flash_attention.plan`'s build
    key (a key no build answers to names an instantiation the source's
    table lacks)."""
    import torch

    from ..kernels import flash_attention as m
    p = m.plan(D, Dv, S, getattr(torch, dtype), mask, score)
    shape = (f"B={B}, S={S}, H={H}:{K}, D={D}/{Dv}, {dtype}, {mask}, "
             f"scores {score}")
    code, rows = m.MASKS[p["mask"]], p["rows"]
    key = p["build"].split("-")
    grid = (B * H, _cdiv(S, rows), 1)
    if key[0] == "f32":
        return [Launch("flash_attention", shape,
                       f"flash_attention_kernel<float, {rows}, {code}>",
                       32 * p["warps"], grid, m.fma_smem_bytes(rows),
                       holds=(("q/k head dim", D, m.MAX_HEAD_DIM),
                              ("v head dim", Dv, m.MAX_HEAD_DIM)))]
    dq, dv = (int(x) for x in key[1].split("x"))
    s16 = _flag(key[-1] == "s16")
    w, bk = p["warps"], p["bk"]
    return [Launch(
        "flash_attention", shape,
        f"flash_attention_bf16_kernel<{dq}, {dv}, {w}, {bk}, {code}, {s16}>",
        32 * w, grid, p["smem"],
        aligned=(("q/k row pitch (16-byte cp.async)", 2 * (dq + 8)),
                 ("v row pitch (16-byte cp.async)", 2 * (dv + 8)),
                 ("k/v stage", 2 * bk * (dq + 8 + dv + 8)),
                 ("q tile", 2 * rows * (dq + 8))),
        tiles=(("mma.sync q.k", rows, bk, dq),
               ("mma.sync p.v", rows, dv, bk)),
        holds=(("q/k head dim", D, dq), ("v head dim", Dv, dv)))]


def moe_launches(E: int, C: int, D: int, F: int, dtype: str) -> List[Launch]:
    import torch

    from ..kernels import moe_ffn as m
    path, bc = m.plan(C, D, F, getattr(torch, dtype))
    shape = f"E={E}, C={C}, D={D}, F={F}, {dtype}"
    if path == "fma":
        t = "float" if dtype == "float32" else "__nv_bfloat16"
        return [Launch("moe_ffn", shape,
                       f"moe_ffn_kernel<{t}, {bc}, {2 if bc == 32 else 1}>",
                       m.FMA_THREADS, (_cdiv(C, bc), E, 1),
                       m.smem_bytes(bc, F, getattr(torch, dtype)))]
    tm, tn, tk = m.WGMMA_TILE
    boxes = (("TMA box row (128-byte swizzle)", 2 * tk),
             ("x row stride", 2 * D), ("w_gate/w_up row stride", 2 * F),
             ("h row stride", 2 * F), ("w_down row stride", 2 * D),
             ("ring stage", m.WGMMA_STAGE))
    mt = _cdiv(C, bc)
    return [Launch("moe_ffn", shape + ", gate/up", "moe_gemm_kernel<true>",
                   m.WGMMA_THREADS, (_cdiv(F, 2 * tn), mt, E), m.WGMMA_SMEM,
                   aligned=boxes, tiles=(("wgmma", tm, tn, tk),)),
            Launch("moe_ffn", shape + ", down", "moe_gemm_kernel<false>",
                   m.WGMMA_THREADS, (_cdiv(D, 4 * tn), mt, E), m.WGMMA_SMEM,
                   aligned=boxes, tiles=(("wgmma", tm, tn, tk),))]


def approx_launches(d: int, cap: int, steps: int, gap: bool,
                    stride: int) -> List[Launch]:
    from ..kernels import approx_pass as m
    how = m.plan(d, cap, steps)
    if gap and steps:                  # the wrapper refuses it
        raise ValueError("approx_pass: the gap output is the plain mode's")
    shape = (f"d={d}, cap={cap}, steps={steps}, gap={gap}, "
             f"k_stride={stride}")
    flags = f"{_flag(steps > 0)}, {_flag(gap)}, {_flag(stride > 1)}"
    if how.wide:
        return [Launch("approx_pass", shape,
                       f"approx_pass_wide_kernel<{flags}>", m.THREADS,
                       (1, 1, 1), 0, static_smem=how.smem_bytes)]
    nj = next(j for j in m.PER_THREAD if d + 1 <= j * m.THREADS)
    aligned = [("row slot (bulk copy)", 4 * m._slot(d + 1)),
               ("layout", how.smem_bytes)]
    if steps:
        aligned.append(("Gram leaf slot (bulk copy)",
                        4 * m._slot(cap * cap)))
    return [Launch("approx_pass", shape,
                   f"approx_pass_kernel<{nj}, {flags}>", m.THREADS,
                   (1, 1, 1), how.smem_bytes, aligned=tuple(aligned),
                   holds=(("d + 1", d + 1, nj * m.THREADS),))]


# ---------------------------------------------------------------------------
# The sweep

#: Shapes the port's paths launch (PERF.md's kernel table).
PATHS = {
    "plane_scores": ((64, 4004), (65, 4004), (7, 127), (4096, 4004),
                     (64 * 6877, 4004)),
    "plane_select": ((6877, 64, 4004), (64, 64, 4004), (512, 64, 4004),
                     (23, 64, 4004), (7291, 64, 2560), (512, 16, 25625),
                     (512, 16, 20505), (1024, 16, 10265)),
    "viterbi": ((1, 14, 26), (6877, 14, 26), (8, 16, 26), (8, 32, 5),
                (23, 14, 26), (1024, 32, 5), (512, 14, 5)),
    "gram": ((64, 4004), (4096, 4004), (16, 25625), (16, 20505),
             (16, 10265)),
    # (B, S, H, K, D, Dv, dtype, mask, scores)
    "flash_attention": (
        (8, 128, 14, 2, 64, 64, "bfloat16", "causal", "f32"),
        (1024, 32, 16, 16, 128, 128, "bfloat16", "causal", "f32"),
        (2, 1024, 128, 128, 192, 128, "bfloat16", "causal", "f32"),
        (2, 1024, 40, 8, 128, 128, "bfloat16", "causal", "bf16"),
        (2, 1024, 32, 32, 112, 112, "bfloat16", "causal", "f32"),
        (1, 8192, 32, 32, 112, 112, "bfloat16", "window", "f32"),
        (1, 8192, 32, 32, 112, 112, "bfloat16", "window", "bf16"),
        (2, 1500, 8, 8, 64, 64, "bfloat16", "bidirectional", "f32"),
        (2, 32, 4, 2, 16, 16, "float32", "causal", "f32"),
        (2, 12, 4, 4, 16, 16, "float32", "bidirectional", "f32")),
    "moe_ffn": ((64, 5120, 2048, 1024, "bfloat16"),
                (64, 1, 2048, 1024, "bfloat16"),
                (256, 1, 7168, 2048, "bfloat16"),
                (256, 64, 7168, 2048, "bfloat16"),
                (8, 10, 64, 32, "float32")),
    # (d, cap, steps)
    "approx_pass": ((4004, 64, 0), (4004, 64, 10), (20505, 16, 0),
                    (20505, 16, 10), (25625, 16, 0), (25625, 16, 10),
                    (4004, 4096, 0), (4004, 512, 10), (2560, 64, 0),
                    (10265, 16, 0)),
}


def _config_shapes():
    """The attention and expert calls of the ten model configs at
    published width, at each shape cell's batch and sequence (prefill
    and training run the kernel; decode runs the plain path) and at a
    short prompt's prefill."""
    from ..configs import (ARCHS, SHAPES, get_config,
                           long_context_overrides)
    from ..models.moe import capacity
    attn, experts = [], []
    cells = [SHAPES[c] for c in ("train_4k", "prefill_32k")]
    seqs = [(c.global_batch, c.seq_len) for c in cells] + [
        (SHAPES["decode_32k"].global_batch, s) for s in SHORT]
    for arch in ARCHS:
        cfg = get_config(arch)
        if cfg.mla:
            dims = (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
        else:
            dims = (cfg.hd, cfg.hd)
        masks = ["causal"]
        if cfg.sliding_window or long_context_overrides(arch).get(
                "sliding_window"):
            masks.append("window")
        if not cfg.xlstm:
            for B, S in seqs:
                for mask in masks:
                    attn.append((B, S, cfg.num_heads, cfg.num_kv_heads,
                                 *dims, mask))
            if cfg.encdec:
                attn.append((1, cfg.encoder_seq, cfg.num_heads,
                             cfg.num_kv_heads, *dims, "bidirectional"))
        if cfg.moe:
            for T in sorted({1, SHAPES["decode_32k"].global_batch,
                             *(c.seq_len for c in cells),
                             *(c.seq_len * c.global_batch for c in cells)}):
                experts.append((cfg.num_experts, capacity(cfg, T),
                                cfg.d_model, cfg.moe_d_ff))
    return attn, experts


def _reference_sweep():
    """The reference's shapes mapped onto each kernel's arguments, and
    the widths and label counts past them."""
    from ..kernels.viterbi import MAX_LABELS
    for n, d in TILE_SHAPES:
        for dd in (d, *WIDTHS):
            yield "plane_scores", (lambda n=n, d=dd:
                                   plane_scores_launches(n, d))
            for cap in (1, 16, 64):
                yield "plane_select", (lambda n=n, c=cap, d=dd:
                                       plane_select_launches(n, c, d))
            yield "gram", lambda n=n, d=dd: gram_launches(n, d)
            for steps in (0, 10):
                for gap in (False, True):
                    for stride in (1, 2):
                        yield "approx_pass", (
                            lambda d=dd, c=n, s=steps, g=gap, k=stride:
                            approx_launches(d, c, s, g, k))
        yield "viterbi", lambda n=n, d=d: viterbi_launches(n, n, d)
        yield "viterbi", lambda n=n, d=d: viterbi_launches(n, d, n)
        for dtype in ("float32", "bfloat16"):
            yield "moe_ffn", (lambda n=n, d=d, t=dtype:
                              moe_launches(8, n, d, d, t))
            for mask in ("causal", "window", "bidirectional"):
                for score in ("f32", "bf16"):
                    for S, D in ((n, d), (d, n)):
                        yield "flash_attention", (
                            lambda S=S, D=D, t=dtype, m=mask, s=score:
                            flash_launches(2, S, 4, 2, D, D, t, m, s))
    for C in (*LABELS, *range(1, 33), 64, MAX_LABELS):
        for L in (1, 14, 4096, 65536):
            yield "viterbi", lambda L=L, C=C: viterbi_launches(8, L, C)


def _path_sweep():
    """The shapes the port's paths launch; each approximate pass in every
    mode the engines run it."""
    makers = {"plane_scores": plane_scores_launches,
              "plane_select": plane_select_launches,
              "viterbi": viterbi_launches, "gram": gram_launches,
              "flash_attention": flash_launches, "moe_ffn": moe_launches}
    for name, shapes in PATHS.items():
        for shape in shapes:
            if name != "approx_pass":
                yield name, lambda fn=makers[name], a=shape: fn(*a)
                continue
            d, cap, steps = shape
            for gap in ((False, True) if not steps else (False,)):
                for stride in (1, 4):
                    yield name, (lambda d=d, c=cap, s=steps, g=gap,
                                 k=stride: approx_launches(d, c, s, g, k))


def _config_sweep():
    """The model configs' calls, in both dtypes and both score types."""
    attn, experts = _config_shapes()
    for B, S, H, K, D, Dv, mask in attn:
        for dtype in ("bfloat16", "float32"):
            for score in ("f32", "bf16"):
                yield "flash_attention", (
                    lambda a=(B, S, H, K, D, Dv, dtype, mask, score):
                    flash_launches(*a))
    for E, C, D, F in experts:
        for dtype in ("bfloat16", "float32"):
            yield "moe_ffn", lambda a=(E, C, D, F, dtype): moe_launches(*a)


#: The sweep's parts: (kernel, a thunk giving its launches) per shape.
SWEEPS = {"reference": _reference_sweep, "paths": _path_sweep,
          "configs": _config_sweep}


def plan_launches() -> Tuple[List[Launch], Dict[str, int]]:
    """Every launch of the sweep, and the shapes each kernel's plan
    refused."""
    launches, refused = [], {name: 0 for name in _build.SOURCES}
    for part in SWEEPS.values():
        for name, thunk in part():
            try:
                launches.extend(thunk())
            except ValueError:
                refused[name] += 1
    return launches, refused


# ---------------------------------------------------------------------------
# H003


def check_launch(launch: Launch, source: Source) -> List[Finding]:
    """The rule H003 findings of one launch against its source."""
    out: List[Finding] = []

    def bad(msg: str) -> None:
        out.append(Finding("H003", launch.where, f"{launch.build}: {msg}"))

    if launch.build not in source.builds:
        bad(f"no such build in csrc/{source.name}.cu's table "
            f"({len(source.builds)} builds)")
    smem = launch.static_smem + launch.dyn_smem
    if smem > _build.SMEM_LIMIT:
        bad(f"{smem} B of shared memory ({launch.static_smem} static + "
            f"{launch.dyn_smem} dynamic) > the card's {_build.SMEM_LIMIT}")
    for what, nbytes in launch.aligned:
        if nbytes % 16:
            bad(f"{what}: {nbytes} B, not a multiple of 16")
    for instr, M, N, K in launch.tiles:
        if instr.startswith("wgmma"):
            whole = M % 64 == 0 and N % 8 == 0 and N <= 256 and K % 16 == 0
            want = "M % 64, N % 8 and N <= 256, K % 16"
        else:                                  # mma.sync m16n8k16
            whole = M % 16 == 0 and N % 8 == 0 and K % 16 == 0
            want = "M % 16, N % 8, K % 16"
        if not whole or min(M, N, K) < 1:
            bad(f"{instr} tile M={M}, N={N}, K={K} is not whole ({want})")
    for what, need, built in launch.holds:
        if need > built:
            bad(f"{what} {need} > the build's {built}")
    if not 1 <= launch.threads <= MAX_THREADS or launch.threads % 32:
        bad(f"{launch.threads} threads a CTA (whole warps, at most "
            f"{MAX_THREADS})")
    for axis, (g, top) in enumerate(zip(launch.grid, MAX_GRID)):
        if not 1 <= g <= top:
            bad(f"grid {'xyz'[axis]} = {g} outside [1, {top}]")
    if launch.cluster > 1:
        top = MAX_CLUSTER if source.nonportable else PORTABLE_CLUSTER
        if launch.cluster > top:
            bad(f"cluster of {launch.cluster} CTAs > {top}"
                + ("" if source.nonportable else " (csrc/"
                   f"{source.name}.cu does not ask for the non-portable "
                   "size)"))
        if launch.grid[1] % launch.cluster:
            bad(f"grid y = {launch.grid[1]} is not whole clusters of "
                f"{launch.cluster}")
    return out


def check_plans(launches: List[Launch],
                srcs: Dict[str, Source]) -> List[Finding]:
    """H003 over ``launches``; and every build of every source reached."""
    findings: List[Finding] = []
    seen = set()
    for launch in launches:
        for f in check_launch(launch, srcs[launch.kernel]):
            if (f.where, f.message) not in seen:
                seen.add((f.where, f.message))
                findings.append(f)
    reached = {(l.kernel, l.build) for l in launches}
    for src in srcs.values():
        for build in src.builds:
            if (src.name, build) not in reached:
                findings.append(Finding(
                    "H003", f"kernels/csrc/{src.name}.cu",
                    f"{build}: no plan of the sweep reaches this build"))
        for build, why in waivers(src.name).items():
            if build not in src.builds or not why.strip():
                findings.append(Finding(
                    "H003", f"kernels/{src.name}.py::SPILL_WAIVERS",
                    f"{build}: a waiver needs a build of the source's "
                    f"table and a reason"))
    return findings


# ---------------------------------------------------------------------------
# H004


@dataclass(frozen=True)
class PtxasEntry:
    """One entry function of an ``-Xptxas -v`` log."""

    registers: int
    stack: int
    spill_stores: int
    spill_loads: int


def parse_ptxas(log: str) -> Dict[str, PtxasEntry]:
    """The ``-Xptxas -v`` log's entry functions by mangled name."""
    props: Dict[str, Tuple[int, int, int]] = {}
    regs: Dict[str, int] = {}
    entry = name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name is not None:
            props[name] = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            regs[entry] = int(m.group(1))
            entry = None
    return {fn: PtxasEntry(r, *props.get(fn, (0, 0, 0)))
            for fn, r in regs.items()}


def _mangled(build: str) -> str:
    """The part of an Itanium-mangled name that names ``build``: its
    identifier and template arguments (``kernel<8, true>`` ->
    ``6kernelILi8ELb1EE``)."""
    name, args = build[:-1].split("<", 1)
    out = []
    for a in (x.strip() for x in args.split(",")):
        if a in ("true", "false"):
            out.append(f"Lb{int(a == 'true')}E")
        elif re.fullmatch(r"-?\d+", a):
            out.append(f"Li{a.replace('-', 'n')}E")
        elif a == "float":
            out.append("f")
        else:
            out.append(f"{len(a)}{a}")
    return f"{len(name)}{name}I{''.join(out)}E"


def ptxas_entry(entries: Dict[str, PtxasEntry],
                build: str) -> Optional[PtxasEntry]:
    hits = [e for fn, e in entries.items() if _mangled(build) in fn]
    return hits[0] if len(hits) == 1 else None


def waivers(name: str) -> Dict[str, str]:
    """``kernels/<name>.py``'s ``SPILL_WAIVERS``: build -> reason."""
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    return {_norm(b): why for b, why in
            getattr(mod, "SPILL_WAIVERS", {}).items()}


def _check_build(name: str, index: int, build: str, launches: List[Launch],
                 log: Optional[PtxasEntry], waived: Dict[str, str]
                 ) -> Tuple[List[Finding], Dict[str, int]]:
    """H004 on one build: its attributes on the card against its plans'
    ``launches`` and its ``-Xptxas -v`` entry.  Returns the findings and
    the build's facts."""
    at = f"kernels/csrc/{name}.cu:{build}"
    a = _build.attributes(name, index)
    if a["rc"]:
        return [Finding("H004", at, f"cudaFuncGetAttributes failed "
                        f"(cudaError {a['rc']})")], {}
    found: List[Finding] = []

    def bad(where: str, msg: str) -> None:
        found.append(Finding("H004", where, msg))

    if a["local_bytes"] > 0 and build not in waived:
        bad(at, f"{a['local_bytes']} B of local memory a thread (a spill) "
            f"at {a['registers']} registers, not waived in "
            f"kernels/{name}.py SPILL_WAIVERS")
    if log is None:
        bad(at, "no single entry function of this build in the -Xptxas -v "
            "log")
    elif log.registers != a["registers"] or (
            (log.spill_stores or log.stack) and not a["local_bytes"]):
        bad(at, f"-Xptxas -v says {log.registers} registers, {log.stack} B "
            f"stack, {log.spill_stores} B spill stores; the card "
            f"{a['registers']} registers, {a['local_bytes']} B local")
    groups: Dict[Tuple[int, int], List[Launch]] = {}
    for l in launches:
        groups.setdefault((l.threads, l.cluster), []).append(l)
    smem, resident = 0, []
    for (threads, cluster), group in sorted(groups.items()):
        worst = max(group, key=lambda l: l.dyn_smem)
        dyn, static = worst.dyn_smem, max(l.static_smem for l in group)
        smem = max(smem, a["static_smem"] + dyn)
        if dyn > a["max_dyn_smem"]:
            bad(worst.where, f"{build}: {dyn} B of dynamic shared memory > "
                f"the {a['max_dyn_smem']} B its init grants")
        if a["static_smem"] > static or (
                a["static_smem"] + dyn > _build.SMEM_LIMIT):
            bad(worst.where, f"{build}: {a['static_smem']} B of static "
                f"shared memory on the card (the plan reckons {static}) "
                f"beside {dyn} B dynamic")
        if threads > a["max_threads"]:
            bad(worst.where, f"{build}: {threads} threads > the build's "
                f"{a['max_threads']}")
        occ = _build.attributes(name, index, threads, dyn, cluster)
        resident.append(occ["resident"])
        if occ["rc"] or occ["resident"] < 1:
            what = "clusters" if cluster > 1 else "CTAs per SM"
            bad(worst.where, f"{build}: {occ['resident']} {what} resident "
                f"at {threads} threads, {dyn} B dynamic shared memory "
                f"(cudaError {occ['rc']})")
    return found, {"registers": a["registers"], "local": a["local_bytes"],
                   "granted": a["max_dyn_smem"], "smem": smem,
                   "resident": min(resident, default=-1)}


def check_builds(launches: List[Launch], srcs: Dict[str, Source]
                 ) -> Tuple[List[Finding], Dict[str, Dict[str, object]]]:
    """H004 on the current CUDA device: build, load and read every build
    of every source, held to ``launches``.  Returns the findings and each
    source's facts: its builds, registers (min, max), the most shared
    memory a launch takes, spills (local bytes a thread), waivers, and
    ``per_build``: registers, local bytes, the granted and the most
    planned shared memory, and the fewest CTAs (clusters) resident."""
    try:
        _build.build()
    except RuntimeError as e:  # nvcc failed: every source it names
        return [Finding("H004", "kernels/csrc",
                        f"failed to compile: {str(e)[-2000:]}")], {}
    findings: List[Finding] = []
    facts: Dict[str, Dict[str, object]] = {}
    for name, src in srcs.items():
        where = f"kernels/csrc/{name}.cu"
        try:
            importlib.import_module(f"repro_torch.kernels.{name}")._lib()
        except (OSError, RuntimeError, AttributeError) as e:
            findings.append(Finding("H004", where, f"failed to load or "
                                    f"initialise: {type(e).__name__}: {e}"))
            continue
        past = _build.attributes(name, len(src.builds))
        if past["builds"] != len(src.builds) or past["rc"] == 0:
            findings.append(Finding(
                "H004", where, f"the library's table holds "
                f"{past['builds']} builds, the source's {len(src.builds)}"))
            continue
        ptxas = parse_ptxas(_build.build_log(name))
        waived = waivers(name)
        per_build: Dict[str, Dict[str, int]] = {}
        for index, build in enumerate(src.builds):
            found, per_build[build] = _check_build(
                name, index, build,
                [l for l in launches if (l.kernel, l.build) == (name, build)],
                ptxas_entry(ptxas, build), waived)
            findings.extend(found)
        regs = [b["registers"] for b in per_build.values() if b]
        spills = {b: f["local"] for b, f in per_build.items()
                  if f and f["local"] > 0}
        facts[f"kernels:{name}"] = {
            "builds": len(src.builds),
            "registers": [min(regs), max(regs)] if regs else [],
            "max_smem": max((f["smem"] for f in per_build.values() if f),
                            default=0),
            "spills": spills,
            "waived": sorted(b for b in spills if b in waived),
            "waived_without_spill": sorted(set(waived) - set(spills)),
            "per_build": per_build}
    return findings, facts


def run_kernel_layer(device="cuda"
                     ) -> Tuple[List[Finding], Dict[str, Dict[str, object]]]:
    """H003 on the CPU; then, on a CUDA ``device``, H004.  On the CPU the
    facts say that H004 did not run."""
    import torch

    srcs = sources()
    launches, refused = plan_launches()
    findings = check_plans(launches, srcs)
    summary: Dict[str, object] = {
        "h003_launches": len(launches), "h003_refused": refused,
        "builds": {n: len(s.builds) for n, s in srcs.items()}}
    facts: Dict[str, Dict[str, object]] = {"kernels": summary}
    device = torch.device(device)
    if device.type != "cuda":
        summary["h004"] = ("not run: it needs a CUDA device (this run's "
                           f"device is {device})")
        return findings, facts
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch.analysis: no CUDA device for the "
                           "kernels layer's H004; pass --device cpu to run "
                           "H003 alone")
    with torch.cuda.device(device):
        found, per_source = check_builds(launches, srcs)
        summary["h004"] = f"run on {torch.cuda.get_device_name(device)}"
    findings.extend(found)
    facts.update(per_source)
    return findings, facts


__all__ = ["Launch", "Source", "PtxasEntry", "check_builds", "check_launch",
           "check_plans", "parse_ptxas", "plan_launches", "ptxas_entry",
           "read_source", "run_kernel_layer", "sources", "waivers"]
