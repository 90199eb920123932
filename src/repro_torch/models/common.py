"""Shared model plumbing: the config, parameter specs and sharding rules,
PyTorch port of ``repro/models/common.py``.

A copy of the reference's :class:`ModelConfig` and :class:`ParamSpec`,
with ``dtype`` a ``torch.dtype``.  Parameters are a nested dict of
tensors with the reference's tree and shapes: layers stay *stacked* with
a leading L axis, so a reference parameter tree converts one to one
(:mod:`repro_torch.convert`), and the layer loops index ``l``.

Sharding: the reference's logical-axis rules (:data:`DEFAULT_RULES`,
:func:`logical_to_spec`, MaxText-style) map each parameter's logical axes
to mesh axes; :func:`param_shardings` turns them into DTensor placements
on a :class:`torch.distributed.device_mesh.DeviceMesh` (the production
meshes of :mod:`repro_torch.launch.mesh`):

  * "embed"   -> FSDP over the data axis (weights all-gathered per layer:
    :func:`gather_fsdp` at each layer's start),
  * "heads" / "mlp" / "vocab" / "experts" / "kv" -> tensor/expert parallel
    over the model axis,
  * "layers" and small axes -> replicated.

A logical axis is only sharded if its size divides the mesh axis size;
otherwise it is replicated.  The model code runs unchanged on plain
tensors; on DTensor parameters it gathers each layer's FSDP weights, and
the helpers here (:func:`replicate_dims`, :func:`as_replicated`,
:func:`local_call`) cover the rest.

``remat_wrap`` runs a layer body under ``torch.utils.checkpoint``
(``use_reentrant=False``) by ``cfg.remat_policy``.  ``scan_layers`` /
``layer_scan`` / ``set_probe_unroll`` keep the reference's API as Python
loops: the port's eager loops run (and a trace counts) every trip, so
the unrolled and the rolled form are one program here.  The layer loops
(:func:`layer_loop`) are marked for the dry-run's loop tracer
(``launch.trace_analysis``) as the reference's layer scans are while
loops, unless the probe switch unrolls them.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.oracles.chain import resolve_device
from ..launch.trace_analysis import loop


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # --- MLA (deepseek-v3) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False               # multi-token-prediction auxiliary head
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0             # zamba2: shared attn block period
    # --- xLSTM ---
    xlstm: bool = False
    slstm_every: int = 4            # every k-th block is sLSTM
    # --- enc-dec (whisper) ---
    encdec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0            # audio frame count from the stub frontend
    # --- VLM ---
    vision_tokens: int = 0          # patch embeddings prepended (stub)
    # --- attention ---
    sliding_window: int = 0
    subquadratic: bool = False      # can run the long_500k cell
    attn_chunk: int = 1024          # q-chunk of the plain chunked attention
    # --- analysis ---
    probe_unroll: bool = False      # the reference's scan probe (a no-op:
                                    # the port's layer loops are eager)
    # --- perf knobs ---
    attn_score_dtype: str = "f32"   # "bf16": the score slab in bf16
    remat_policy: str = "nothing"   # nothing | dots | selective | none
    attn_impl: str = "chunked"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def param_count(self) -> int:
        from . import registry
        return int(sum(math.prod(s.shape)
                       for s in leaves(registry.param_specs(self))))


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names (len == ndim)
    dtype: Any = torch.bfloat16
    scale: float = 0.02              # init stddev (0 => zeros, 1.0 => ones)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def leaves(tree) -> list:
    """The leaves of a nested dict, keys in sorted order (the order
    ``jax.tree_util`` flattens a dict in)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(specs, generator: torch.Generator, device=None) -> dict:
    """Tensors for a tree of specs, by the reference's rule
    (``repro/models/common.py:133``): zeros for scale 0, ones for a 1-D
    scale-1 spec, else ``normal * scale`` drawn in float32 and cast.

    ``device`` defaults to CUDA; ``generator`` must live on it.  The draws
    come from ``generator`` in the reference's leaf order, so one seed gives
    one set of weights (not the reference's: a torch generator cannot
    reproduce ``jax.random``)."""
    dev = resolve_device(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"init_params: generator on {generator.device}, "
                         f"parameters on {dev}")

    def make(s: ParamSpec) -> torch.Tensor:
        if s.scale == 0.0:
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.scale == 1.0 and len(s.shape) <= 1:
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(s.scale).to(s.dtype)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return make(tree)

    return build(specs)


def abstract_params(specs, device="meta") -> dict:
    """Tensors of each spec's shape and dtype that hold no data: on the
    ``meta`` device by default; under an active ``FakeTensorMode`` with
    ``device="cpu"``, fake CPU tensors (the dry-run's parameters)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=device), specs)


# ---------------------------------------------------------------------------
# Sharding rules

#: logical axis -> preferred mesh axis (in priority order)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "embed": ("data",),          # FSDP
    "heads": ("model",),         # TP (flattened heads*hd dims)
    "kv": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),       # EP
    "batch": ("pod", "data"),
    "seq": (),                   # SP is opt-in via perf flags
    "layers": (),
    "conv": (),
    "state": (),
}


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names``), of
    a mesh with a ``shape`` mapping (the reference's, a ``DataMesh``), or
    of such a mapping itself."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def mesh_axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def logical_to_spec(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                    mesh, rules=None,
                    batch_axes: Tuple[str, ...] = ("pod", "data")) -> tuple:
    """Map logical axes to a partition spec, replicating non-divisible
    dims: one entry per dim, a mesh axis name, a tuple of them (the batch
    over ``("pod", "data")``) or None -- the reference's
    ``PartitionSpec`` as a plain tuple."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axes(mesh)
    used = set()
    out = []
    for ax_name, dim in zip(axes, shape):
        entry: Any = None
        if ax_name is not None:
            candidates = rules.get(ax_name, ())
            if ax_name == "batch":
                # batch may shard over several mesh axes jointly
                axs = [a for a in candidates if a in sizes and a not in used]
                total = math.prod(sizes[a] for a in axs) if axs else 1
                if axs and dim % total == 0:
                    entry = tuple(axs)
                    used.update(axs)
            else:
                for cand in candidates:
                    if cand in sizes and cand not in used \
                            and dim % sizes[cand] == 0:
                        entry = cand
                        used.add(cand)
                        break
        out.append(entry)
    return tuple(out)


def spec_to_placements(spec: tuple, mesh) -> tuple:
    """A partition spec as DTensor placements, one per mesh dim: ``Shard(i)``
    on each mesh axis that dim ``i``'s entry names, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[names.index(a)] = Shard(i)
    return tuple(out)


def placements_to_spec(placements, ndim: int, mesh) -> tuple:
    """The partition spec of DTensor placements (the inverse of
    :func:`spec_to_placements`)."""
    names = tuple(mesh_axes(mesh))
    out: list = [()] * ndim
    for name, p in zip(names, placements):
        if p.is_shard():
            out[p.dim] = out[p.dim] + (name,)
    return tuple(None if not e else e[0] if len(e) == 1 else e for e in out)


def param_shardings(specs, mesh, rules=None) -> dict:
    """Each leaf's DTensor placements on ``mesh`` (a ``DeviceMesh``) by
    the rules: a tree of placement tuples."""
    return tree_map(lambda s: spec_to_placements(
        logical_to_spec(s.axes, s.shape, mesh, rules), mesh), specs)


def shard_params(params: dict, specs, mesh, rules=None) -> dict:
    """``params`` (plain tensors, the same on every rank) as DTensors on
    ``mesh``, each leaf placed by :func:`param_shardings`."""
    from torch.distributed.tensor import distribute_tensor
    plc = param_shardings(specs, mesh, rules)

    def put(t, p):
        if isinstance(t, dict):
            return {k: put(t[k], p[k]) for k in t}
        return distribute_tensor(t, mesh, p)
    return put(params, plc)


def activation_sharding(mesh, *axes: Optional[str]) -> tuple:
    """DTensor placements of an activation with the given logical axes:
    ``"batch"`` over ``("pod", "data")``, ``"model"`` over the model axis,
    the rest replicated."""
    sizes = mesh_axes(mesh)
    spec = []
    for a in axes:
        if a == "batch":
            axs = tuple(x for x in ("pod", "data") if x in sizes)
            spec.append(axs if axs else None)
        elif a == "model" and "model" in sizes:
            spec.append("model")
        else:
            spec.append(None)
    return spec_to_placements(tuple(spec), mesh)


def shard_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` with its leading (batch) dim sharded over ``("pod",
    "data")``: a DTensor redistributed, a plain tensor (the same on every
    rank) distributed.  ``mesh`` None returns ``x``."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, distribute_tensor
    plc = activation_sharding(mesh, "batch", *([None] * (x.ndim - 1)))
    if isinstance(x, DTensor):
        return x.redistribute(mesh, plc)
    return distribute_tensor(x, mesh, plc)


# ---------------------------------------------------------------------------
# The model code on DTensors

def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _replicate_where(x, drop: Callable) -> torch.Tensor:
    """``x`` (a DTensor) redistributed with every placement for which
    ``drop(mesh dim name, placement)`` holds replaced by ``Replicate()``
    (a partial sum is reduced); ``x`` itself when none does."""
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names or ()
    plc = tuple(Replicate() if drop(n, p) else p
                for n, p in zip(names, x.placements))
    return x if plc == tuple(x.placements) else x.redistribute(
        x.device_mesh, plc)


def gather_fsdp(tree):
    """A layer's weights with their FSDP ("embed" over ``data``) shards
    all-gathered: what FSDP does at each layer's start.  Plain tensors
    pass through untouched."""
    def one(t):
        if not is_dtensor(t):
            return t
        return _replicate_where(t, lambda n, p: n == "data" and p.is_shard())
    return tree_map(one, tree)


def replicate_dims(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with no mesh axis sharding tensor dims ``dims`` (negative
    counts from the end), and its partial sums reduced: all-gathered
    before a reshape that splits such a dim into heads the mesh axis does
    not divide, or a lookup along it.  Plain tensors pass through."""
    if not is_dtensor(x):
        return x
    want = {d % x.ndim for d in dims}
    return _replicate_where(x, lambda n, p: p.is_partial() or (
        p.is_shard() and p.dim in want))


def split_heads(t: torch.Tensor, *dims: int) -> torch.Tensor:
    """``t (..., prod(dims))`` reshaped to ``(..., *dims)`` (heads, head
    dim).  A DTensor whose last dim is sharded over mesh axes that do not
    divide ``dims[0]`` (qwen2's 14 heads over a 16-way model axis) has
    that dim gathered first: the reshape would split it unevenly."""
    if is_dtensor(t):
        ways = math.prod(t.device_mesh.size(i) for i, p in
                         enumerate(t.placements)
                         if p.is_shard() and p.dim == t.ndim - 1)
        if ways > 1 and dims[0] % ways:
            t = replicate_dims(t, -1)
    return t.reshape(*t.shape[:-1], *dims)


def placed_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` (a DTensor of ``ref``'s rank) redistributed to ``ref``'s
    placements, so that a product of the two finds its shards aligned
    (attention's k, v against q's heads); plain tensors as they are."""
    if not (is_dtensor(t) and is_dtensor(ref)):
        return t
    from torch.distributed.tensor import Replicate
    plc = tuple(Replicate() if p.is_partial() else p for p in ref.placements)
    return t if tuple(t.placements) == plc else t.redistribute(
        ref.device_mesh, plc)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes its gradient contiguous: a
    local region's input gradients leave it as DTensor gradients that a
    later view (a reshape's, a matmul's fold) must be able to view."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


class _GradPlacedAsInput(torch.autograd.Function):
    """The identity, whose backward places its (DTensor) gradient as its
    input was placed: after a heads merge, so that the backward's
    reshape back into heads meets the placements the forward's had."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate
        plc = tuple(Replicate() if p.is_partial() else p
                    for p in ctx.placements)
        if tuple(grad.placements) != plc:
            grad = grad.redistribute(grad.device_mesh, plc)
        return grad


def grad_placed_as_input(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose (DTensor) gradient comes back placed as ``x`` is, a
    partial sum reduced (:class:`_GradPlacedAsInput`); a plain tensor as
    it is."""
    return _GradPlacedAsInput.apply(x) if is_dtensor(x) else x


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """``o (..., H, hd)`` -> ``(..., H hd)``; on a DTensor, its gradient
    comes back placed as the merge's output was (a gradient sharded over
    the merged dim by a later product could not be split back into heads
    the mesh axis does not divide)."""
    out = o.flatten(-2)
    return _GradPlacedAsInput.apply(out) if is_dtensor(o) else out


def local_fn(fn: Callable) -> Callable:
    """``fn`` for ``local_map``: its tensor arguments that need a gradient
    pass an identity whose backward makes that gradient contiguous
    (:class:`_ContiguousGrad`)."""
    def run(*args):
        return fn(*(_ContiguousGrad.apply(a)
                    if isinstance(a, torch.Tensor) and a.requires_grad
                    else a for a in args))
    return run


def layer_input(x: torch.Tensor) -> torch.Tensor:
    """The residual stream at a layer's start: a DTensor with its batch
    over ("pod", "data") and replicated over the rest (partial sums
    reduced), so every layer of a kind starts from the same placements
    and runs the same sharded ops; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    plc = activation_sharding(x.device_mesh, "batch",
                              *([None] * (x.ndim - 1)))
    return x if tuple(x.placements) == plc else x.redistribute(
        x.device_mesh, plc)


def residual_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` for the residual stream ``x`` and a half's output ``y``
    (attention's ``wo``, the FFN's ``down``, the experts' combine, an
    out projection: on DTensors a row-parallel product, a partial sum
    over the model axis): ``y`` reduced and placed as the stream first
    (:func:`layer_input`), so the stream never holds a partial sum and
    the next half's column-parallel products (gate, up, q/k/v, the lm
    head) run on their local weight shards.  Its gradient is reduced
    alike: the stream's gradient is a partial sum (the next halves'
    column-parallel products), which would otherwise reach the
    row-parallel product's backward unreduced and gather its weight and
    input whole.  Plain tensors: ``x + y``."""
    if not is_dtensor(y):
        return x + y
    return x + _GradPlacedAsInput.apply(layer_input(y))


def row_input(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` placed for the row-parallel product ``x @ w``: on each mesh
    axis that shards ``w``'s rows (its contracted dim), ``x``'s last dim
    sharded alike, a partial sum reduce-scattered into those shards and a
    replicated one sliced, so the product runs on the local shards and
    leaves a partial sum.  Other axes and plain tensors as they are."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x
    from torch.distributed.tensor import Shard
    plc = tuple(Shard(x.ndim - 1) if pw.is_shard() and pw.dim == w.ndim - 2
                else px for px, pw in zip(x.placements, w.placements))
    return x if plc == tuple(x.placements) else x.redistribute(
        x.device_mesh, plc)


def unstack(tree, dims: int = 1):
    """A stacked parameter tree's layers, each leaf unbound once along its
    first ``dims`` dims (flattened) into a tuple: ``unstack(t)[i]`` is
    ``t[i]``, ``unstack(t, 2)[g * k + l]`` is ``t[g, l]``.  Autograd then
    stacks the layers' gradients once, where indexing the stack layer by
    layer writes a zero-filled gradient of the whole stack per layer."""
    def one(t):
        return (t.flatten(0, dims - 1) if dims > 1 else t).unbind(0)
    return tree_map(one, tree)


def per_shard(fn: Callable, ref: torch.Tensor, *args: torch.Tensor):
    """``fn(*args)`` for a function that works on each (batch, head) on
    its own (attention over unsharded sequence and head dims, tensors
    ``(B, S, H, d)``, kv heads repeated to H): on DTensors, ``fn`` run on
    every rank's local shards through ``local_map``.  Heads sharded over
    the model axis: each tensor placed like ``ref`` (:func:`placed_like`),
    the output placed as ``ref``.  Heads the model axis does not divide
    (whole on every rank): :func:`_pair_shard`.  Plain tensors:
    ``fn(*args)``."""
    if not is_dtensor(ref):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    ref = _replicate_where(ref, lambda n, p: p.is_partial())
    names = ref.device_mesh.mesh_dim_names or ()
    if "model" in names:
        m = names.index("model")
        if ref.device_mesh.size(m) > 1 and ref.placements[m].is_replicate():
            return _pair_shard(fn, ref, m, *args)
    plc = list(ref.placements)
    args = [placed_like(a, ref) for a in args]
    return local_map(local_fn(fn), out_placements=plc,
                     in_placements=tuple(plc for _ in args),
                     device_mesh=ref.device_mesh)(*args)


def _pair_shard(fn: Callable, ref: torch.Tensor, m: int, *args):
    """:func:`per_shard` over the (local batch x heads) pairs: the ``P =
    B_local H`` pairs (row-major, batch then head) split over mesh dim
    ``m`` (the model axis) in chunks of ``ceil(P / M)``, so each rank
    runs ``fn`` on its chunk alone (one head each, its kv head repeated
    beside it) and the last ranks on fewer, or none, when ``M`` does
    not divide ``P``.  The output is the chunk written into zeros: a
    partial sum over the model axis, which the row-parallel ``wo``
    reduce-scatters (:func:`row_input`); the inputs' gradients are
    partial sums over it too.  The reference splits the head dim
    instead and all-reduces its score slabs."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = ref.device_mesh
    plc = list(ref.placements)
    part = list(plc)
    part[m] = Partial()
    args = [placed_like(a, ref) for a in args]
    M, r = mesh.size(m), mesh.get_local_rank(m)

    def run(*ts):
        B, S, H = ts[0].shape[:3]
        P = B * H
        n = -(-P // M)
        lo, hi = min(r * n, P), min(r * n + n, P)
        pair = torch.arange(lo, hi, device=ts[0].device)
        b, h = pair // H, pair % H
        o = fn(*(t[b, :, h][:, :, None] for t in ts))    # (n, S, 1, d)
        o = F.pad(o[:, :, 0], (0, 0, 0, 0, lo, P - hi))   # (P, S, d)
        # contiguous, as DTensor takes a local shard to be: merging the
        # heads must view it, not let DTensor move it onto the sequence
        return o.reshape(B, H, S, o.shape[-1]).transpose(1, 2).contiguous()

    return local_map(local_fn(run), out_placements=part,
                     in_placements=tuple(plc for _ in args),
                     in_grad_placements=tuple(part for _ in args),
                     device_mesh=mesh)(*args)


def batch_local(fn: Callable, x: torch.Tensor, *rest: torch.Tensor):
    """``fn(x, *rest)`` for a function that works on each batch row of
    ``x`` alone (a lookup by token ids, a causal conv or a pad along the
    sequence): on DTensors, ``x`` sharded along its batch dim only and
    ``rest`` whole on every rank, ``fn`` run on the local rows through
    ``local_map``; the output placed as ``x``, the gradients of ``rest``
    partial sums over the mesh axes that shard the batch.  Plain
    tensors: ``fn(x, *rest)``."""
    if not is_dtensor(x):
        return fn(x, *rest)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    x = _replicate_where(x, lambda n, p: p.is_partial() or (
        p.is_shard() and p.dim != 0))
    mesh = x.device_mesh
    plc = list(x.placements)
    rep = [Replicate()] * mesh.ndim
    summed = [Partial() if p.is_shard() else Replicate() for p in plc]
    rest = [full_replicate(r) if is_dtensor(r) else as_replicated(r, x)
            for r in rest]
    return local_map(local_fn(fn), out_placements=plc,
                     in_placements=(plc,) + (rep,) * len(rest),
                     in_grad_placements=(plc,) + (summed,) * len(rest),
                     device_mesh=mesh)(x, *rest)


def local_region(shape, mesh, placements, coordinate=None):
    """``(local shape, global offset)`` of the shard this rank (or the
    mesh ``coordinate`` given) holds of a ``shape`` tensor under
    ``placements``: ``torch.chunk``'s split, mesh dim by mesh dim, as
    DTensor's ``Shard``.  Host arithmetic only (no tensor op, so it runs
    under a ``FakeTensorMode``)."""
    if coordinate is None:
        coordinate = mesh.get_coordinate()
    size, off = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            d, k = p.dim % len(shape), mesh.size(i)
            chunk = -(-size[d] // k)
            start = min(coordinate[i] * chunk, size[d])
            off[d] += start
            size[d] = max(0, min(chunk, size[d] - start))
    return tuple(size), tuple(off)


def cache_at(c: torch.Tensor, *idx: int) -> torch.Tensor:
    """``c[idx]``: one layer's entry of a stacked decode cache, a view the
    decode writes in place (:func:`cache_write`).  A DTensor cache
    sharded along an indexed (layer) dim has no such view (indexing it
    gathers a copy, and the writes would be lost): refused.  The
    reference's cache heuristic shards the first dim equal to the batch,
    so a batch equal to a layer count does this."""
    if is_dtensor(c) and any(p.is_shard() and p.dim < len(idx)
                             for p in c.placements):
        raise ValueError(f"decode cache {tuple(c.shape)} sharded along its "
                         f"layer axis ({c.placements}): a batch equal to a "
                         "layer count; choose another batch")
    return c[idx if len(idx) > 1 else idx[0]]


def cache_write(c: torch.Tensor, val: torch.Tensor, dim: Optional[int] = None,
                index: int = 0) -> None:
    """A decode cache written in place: ``c.select(dim, index)`` (every
    other dim whole) takes ``val``, or all of ``c`` with ``dim`` None.  A
    DTensor cache (placed by the dry-run's ``cache_shardings``) has each
    rank write the part it holds: all of it from a DTensor ``val``
    redistributed to the cache's placements (no rank gathers a recurrent
    state whole), one position from ``val`` gathered whole; a plain
    cache on DTensor parameters (each rank a whole copy) takes ``val``
    gathered whole."""
    if dim is None and is_dtensor(c) and is_dtensor(val):
        c.to_local().copy_(
            val.redistribute(c.device_mesh, c.placements).to_local())
        return
    if is_dtensor(val):
        val = full_replicate(val).to_local()
    if not is_dtensor(c):
        (c if dim is None else c.select(dim, index)).copy_(val)
        return
    shape, off = local_region(c.shape, c.device_mesh, c.placements)
    local = c.to_local()
    if dim is not None:
        if not off[dim] <= index < off[dim] + shape[dim]:
            return
        local = local.select(dim, index - off[dim])
        shape = tuple(shape[:dim]) + tuple(shape[dim + 1:])
        off = tuple(off[:dim]) + tuple(off[dim + 1:])
    local.copy_(val[tuple(slice(o, o + n) for o, n in zip(off, shape))])


def as_replicated(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A plain tensor (positions, masks, rope tables: the same on every
    rank) as a replicated DTensor on ``like``'s mesh, so it mixes with
    ``like``; ``x`` itself when ``like`` is a plain tensor."""
    if not is_dtensor(like) or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def full_replicate(x: torch.Tensor) -> torch.Tensor:
    """A DTensor fully replicated (every shard gathered, partial sums
    reduced); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return _replicate_where(x, lambda n, p: not p.is_replicate())


def local_call(fn: Callable, *args, n_out: int = 1):
    """``fn`` on replicated DTensor arguments, run on each rank's full
    local copy through ``local_map``, its ``n_out`` tensor outputs
    replicated DTensors: the port's way for what is global over a sharded
    dim and has no sharding rule (top-k routing, the MoE combine).
    Without a DTensor argument, ``fn(*args)``."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = dts[0].device_mesh
    rep = [Replicate()] * mesh.ndim     # a list: one output's placements
    args = [full_replicate(a) for a in args]
    return local_map(local_fn(fn),
                     out_placements=rep if n_out == 1 else (rep,) * n_out,
                     in_placements=tuple(rep if is_dtensor(a) else None
                                         for a in args),
                     device_mesh=mesh)(*args)


# ---------------------------------------------------------------------------
# Layer loops and rematerialization

def scan_layers(body, init, xs, unroll: bool = False):
    """The reference's ``lax.scan`` over stacked layer params, as a Python
    loop: ``body(carry, x_l)`` for each slice ``l`` of the leading axis of
    ``xs`` (a tensor or a nested dict of them), ``(carry, ys stacked)``,
    ys None when every ``y`` is.  ``unroll`` is the reference's probe
    switch; an eager loop runs every trip either way, so it only leaves
    the loop unmarked for the dry-run's tracer."""
    first = leaves(xs)[0] if leaves(xs) else None
    L = first.shape[0] if first is not None else 0
    carry, ys = init, []
    for i in loop("common.scan_layers", L, marked=not unroll):
        carry, y = body(carry, tree_map(lambda a: a[i], xs))
        ys.append(y)
    if not ys or all(y is None for y in ys):
        return carry, None
    return carry, _stack([y for y in ys])


def _stack(ys):
    if isinstance(ys[0], dict):
        return {k: _stack([y[k] for y in ys]) for k in ys[0]}
    return torch.stack(ys)


# Process-global probe switch (the reference's roofline prober sets it
# around lowering; kept for the API).
_PROBE_UNROLL = False


def set_probe_unroll(value: bool) -> None:
    global _PROBE_UNROLL
    _PROBE_UNROLL = bool(value)


def layer_scan(body, init, xs):
    """Module-internal alias of :func:`scan_layers` at the probe switch."""
    return scan_layers(body, init, xs, _PROBE_UNROLL)


def layer_loop(name: str, n: int):
    """``range(n)`` for a layer loop (a ``lax.scan`` over layers in the
    reference), marked ``name`` for the dry-run's loop tracer unless the
    probe switch unrolls the layers."""
    return loop(name, n, marked=not _PROBE_UNROLL)


REMAT_POLICIES = ("nothing", "dots", "selective", "none")


def _save_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of 2-D matrix products (``mm``,
    ``addmm``: products without batch dims, the projections), recompute
    the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn: Callable, context_fn=None) -> Callable:
    from torch.utils.checkpoint import checkpoint
    kw = {} if context_fn is None else {"context_fn": context_fn}

    @functools.wraps(fn)
    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def remat_wrap(cfg: "ModelConfig", fn: Callable,
               halves: bool = False) -> Callable:
    """``fn`` (a layer body) under the configured activation-checkpoint
    policy, ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``
    (values and gradients unchanged; run plainly under ``no_grad``):

    "nothing"   recompute the whole body in the backward (min live memory),
    "dots"      save the 2-D matrix products' outputs (products without
                batch dims, the reference's ``dots_with_no_batch_dims``),
    "selective" save the block's attention and FFN outputs only: a body
                with ``halves`` (a transformer block) checkpoints each
                half on its own through :func:`remat_half`; a body
                without them saves nothing, as the reference's names are
                not in it,
    "none"      no remat."""
    policy = cfg.remat_policy
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} (one of "
                         f"{REMAT_POLICIES})")
    if policy == "none" or (policy == "selective" and halves):
        return fn
    if policy == "dots":
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        return _checkpointed(fn, functools.partial(
            create_selective_checkpoint_contexts, _save_products))
    return _checkpointed(fn)


def remat_half(cfg: "ModelConfig", fn: Callable) -> Callable:
    """One half of a transformer block (attention or FFN), checkpointed
    on its own under ``"selective"`` (its output is what the backward
    keeps), as it is otherwise."""
    return _checkpointed(fn) if cfg.remat_policy == "selective" else fn
