"""Multi-pod dry-run: trace one train, prefill or decode step of an (arch x
shape x mesh) cell on DTensors over a 256- or 512-rank production mesh,
on one host, with nothing executed and nothing allocated (PyTorch port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell with XLA over 512 forced host
devices and reads XLA's cost and memory analyses.  A torch program has no
HLO; here this process is rank 0 of a fake process group of the mesh's
world size (``launch.mesh.force_host_platform_device_count``), the
parameters, optimizer state, batch and cache are DTensors of fake CPU
tensors placed by the reference's sharding rules
(``models.common.param_shardings``, :func:`batch_shardings`,
:func:`cache_shardings`), and the step runs under ``FakeTensorMode``:
every op is traced with its shapes, none computes.

What a record counts, per device (rank 0's view; the mesh is uniform):

  * ``flops``: the local ops' FLOPs (``torch.utils.flop_counter``'s
    formulas on each op that runs on a rank's shards, not the global ones
    that DTensor's sharding propagation traces); ``flops_source`` is
    ``"flop_counter"``, ``flops_by_op`` the same by aten op (``mm``,
    ``bmm``, ...);
  * ``bytes_accessed``: the sum of each local op's operand and result
    bytes (views, which move nothing, left out);
  * the ``c10d_functional`` collectives DTensor issues (result bytes, as
    the reference reads HLO result shapes), by loop placement as the
    reference's ``repro/launch/hlo_analysis.py`` splits them
    (:mod:`.trace_analysis`: the loops that are ``lax.scan`` /
    ``lax.map`` in the reference are marked, and a collective of a trip's
    forward or of the backward of a node that trip made is in the loop):
    ``collective_bytes_static``, ``collective_by_kind`` and
    ``collective_counts`` hold only the collectives outside every loop;
    ``collective_in_loop_bytes``, ``collective_in_loop_by_kind`` and
    ``collective_in_loop_counts`` one trip of each loop;
    ``while_trip_counts`` each loop site's trips.  The port also records
    ``collective_bytes_all_trips``, ``collective_all_trips_by_kind`` and
    ``collective_all_trips_counts`` (every collective of the step, which
    the roofline reads), ``collective_loops`` (each outermost loop entry's
    trips and per-trip bytes) and ``collective_uneven_trips`` (a trip
    whose collectives differ from its loop's first, named; none expected);
  * ``memory_analysis``: ``argument_size_in_bytes`` (parameters, AdamW
    state, batch or cache, each rank's shards of those an op of the step
    reads: a prefill's labels, or the MTP and vision weights outside
    training, are left out, as XLA's executable drops an argument its
    program does not use), ``output_size_in_bytes``
    and ``temp_size_in_bytes``: the rank's peak of live bytes made inside
    the step.  Each local op's output storage is counted from the op that
    made it until it is freed (a weak reference on the storage, so a view
    holds its base's bytes, and autograd's saved tensors hold the
    activations); the arguments' storages and the ops DTensor's sharding
    propagation traces on the global shapes are left out, and so is an
    op's output on the meta device (shape without storage, no rank holds
    it: it adds nothing to ``bytes_accessed`` or the temporaries, its
    FLOPs are counted as any op's).  It differs from
    XLA's ``temp_size_in_bytes``: no buffer is reused across ops (each op
    makes its outputs, as eager PyTorch and its caching allocator do), no
    argument is donated, and the step's outputs are in it (XLA lists them
    under ``output_size_in_bytes`` only), so ``argument + temp`` is the
    step's peak on one card (``chip_smoke.py``'s ``dryrun_memory`` phase
    holds it against ``torch.cuda.max_memory_allocated``).

``trace_s`` takes the place of ``lower_s`` and there is no ``compile_s``,
``hlo_bytes`` or ``cost_analysis``.  The fake tensors are CPU tensors, so
the attention and expert FFN trace their plain paths
(``chunked_causal_attention``, the expert einsums), as the reference's
CPU lowering runs them in XLA.  A count through the kernels needs fake
implementations of B5 and B6 (ROADMAP).  A mesh of one rank
(``mesh_shape=(1, 1)``) traces plain tensors, no DTensors and no group.

Records go to ``results/torch/dryrun/``.  One cell per process (the fake
group's world size is the mesh's); ``--all`` runs one subprocess per cell.

Usage:  python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
            --shape train_4k --mesh single
        python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import pathlib
import subprocess
import sys
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional

import torch

from .. import configs
from ..kernels.ops import contiguous_stride
from ..models import common, registry
from ..optim import AdamWConfig, adamw_init, adamw_update
from .trace_analysis import LoopTracer

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "results"
               / "torch" / "dryrun")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# ---------------------------------------------------------------------------
# Trees of tensors (dicts, tuples, lists, None)


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` order (dict keys sorted, None none)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


# ---------------------------------------------------------------------------
# Cell construction


def build_config(arch: str, shape_name: str, overrides: dict):
    cfg = configs.get_config(arch)
    if shape_name == "long_500k":
        cfg = dataclasses.replace(cfg, **configs.long_context_overrides(arch))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def _batch_axes(mesh):
    sizes = common.mesh_axes(mesh)
    axs = [a for a in ("pod", "data") if a in sizes]
    return axs, math.prod(sizes[a] for a in axs)


def batch_spec(shape, mesh) -> tuple:
    """A batch leaf's partition spec: the leading dim over ``("pod",
    "data")`` where it divides and is > 1."""
    spec = [None] * len(shape)
    axs, total = _batch_axes(mesh)
    if len(shape) >= 1 and axs and shape[0] % total == 0 and shape[0] > 1:
        spec[0] = tuple(axs)
    return tuple(spec)


def batch_shardings(tree, mesh):
    """Each batch leaf's DTensor placements (:func:`batch_spec`)."""
    return tree_map(lambda t: common.spec_to_placements(
        batch_spec(tuple(t.shape), mesh), mesh), tree)


def cache_spec(shape, cfg, batch: int, mesh, seq_len: int = 0,
               seq_shard: bool = True) -> tuple:
    """The reference's cache heuristic: the batch axis over ``("pod",
    "data")``, then the *sequence* axis over ``model`` (attention
    contracts over S, so softmax partials reduce with small all-reduces
    instead of gathering the cache), else a kv-head axis where it
    divides."""
    sizes = common.mesh_axes(mesh)
    model_n = sizes.get("model", 1)
    axs, dp = _batch_axes(mesh)
    spec: list = [None] * len(shape)
    done_batch = done_model = False
    for i, dim in enumerate(shape[:4]):
        if not done_batch and dim == batch and batch > 1 and dim % dp == 0:
            spec[i] = tuple(axs)
            done_batch = True
        elif done_batch and not done_model and seq_shard \
                and seq_len and dim == seq_len \
                and dim % model_n == 0 and "model" in sizes:
            spec[i] = "model"
            done_model = True
    if not done_model:
        for i, dim in enumerate(shape[:4]):
            if spec[i] is None and done_batch \
                    and dim in (cfg.num_kv_heads, cfg.num_heads) \
                    and dim % model_n == 0 and "model" in sizes:
                spec[i] = "model"
                break
    return tuple(spec)


def _whole_layers(spec: tuple) -> tuple:
    """``spec`` with the dims before the batch's (the stacked layer and
    group axes) whole: the port's decode writes each layer's entry in
    place (``models.common.cache_at``), which a sharded layer axis does
    not allow.  The reference's heuristic can put ``model`` there (a
    group count equal to a head count)."""
    b = next((i for i, e in enumerate(spec) if isinstance(e, tuple)), 0)
    return tuple(None if i < b else e for i, e in enumerate(spec))


def cache_shardings(cache, cfg, batch: int, mesh, seq_len: int = 0,
                    seq_shard: bool = True):
    """Each cache leaf's DTensor placements: :func:`cache_spec` with the
    layer axes whole (:func:`_whole_layers`)."""
    return tree_map(lambda t: common.spec_to_placements(_whole_layers(
        cache_spec(tuple(t.shape), cfg, batch, mesh, seq_len, seq_shard)),
        mesh), cache)


def as_dtensor(t: torch.Tensor, mesh, placements):
    """A DTensor of ``t``'s global shape and dtype on ``mesh``: each rank's
    local tensor is an empty one of its shard's shape (a fake tensor under
    ``FakeTensorMode``), made without a collective."""
    from torch.distributed.tensor import DTensor
    shape, _ = common.local_region(tuple(t.shape), mesh, placements)
    local = torch.empty(shape, dtype=t.dtype, device="cpu")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape,
                              stride=contiguous_stride(t.shape))


def place(tree, shardings, mesh):
    """A tree of tensors as DTensors, leaf by leaf by ``shardings``."""
    if isinstance(tree, dict):
        return {k: place(tree[k], shardings[k], mesh) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(place(t, s, mesh)
                          for t, s in zip(tree, shardings))
    return None if tree is None else as_dtensor(tree, mesh, shardings)


# ---------------------------------------------------------------------------
# Steps


def make_train_step(cfg, ocfg: AdamWConfig):
    from .train import value_and_grad

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(params, cfg, batch)
        with registry.sharded(params):
            params, opt_state, stats = adamw_update(grads, opt_state, params,
                                                    ocfg)
        return params, opt_state, loss, stats["grad_norm"]

    return train_step


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        return registry.prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg):
    def serve_step(params, cache, tokens, pos):
        return registry.decode_step(params, cfg, cache, tokens, pos)

    return serve_step


# ---------------------------------------------------------------------------
# Model-FLOPs accounting (6*N*D; MoE: active params only)


def count_params(specs) -> dict:
    total = 0
    expert = 0

    def walk(tree):
        nonlocal total, expert
        if isinstance(tree, common.ParamSpec):
            n = math.prod(tree.shape)
            total += n
            if "experts" in tree.axes:
                expert += n
            return
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)

    walk(specs)
    return {"total": total, "expert": expert}


def model_flops(cfg, counts: dict, tokens: int, kind: str) -> float:
    n_total, n_expert = counts["total"], counts["expert"]
    if cfg.moe and cfg.num_experts:
        active_frac = cfg.experts_per_token / cfg.num_experts
        n_active = n_total - n_expert * (1.0 - active_frac)
    else:
        n_active = n_total
    per_tok = 6.0 * n_active if kind == "train" else 2.0 * n_active
    return per_tok * tokens


# ---------------------------------------------------------------------------
# Per-device counting


_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_to_all_single": "all-to-all",
          "broadcast": "collective-permute"}
#: Ops of the collective namespaces that move nothing: a wait hands back
#: the same buffer, the autograd wrapper wraps one.
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
_PROPAGATING = threading.local()
#: The device query, answered by the tensor subclass itself (a fake
#: tensor's, or DTensor's): it moves nothing, and the autograd engine
#: asks it of every tensor it handles.
_DEVICE = torch.ops.prim.device.default


def _guard_propagation() -> None:
    """Mark the ops DTensor's sharding propagation traces on the global
    shapes (to learn an output's shape), so the counter leaves them out:
    they are no rank's work."""
    from torch.distributed.tensor import _sharding_prop as sp
    cls = sp.ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    fn = getattr(cls, name, None)
    if fn is None or getattr(fn, "_repro_guarded", False):
        return

    def guarded(self, *a, **k):
        depth = getattr(_PROPAGATING, "depth", 0)
        _PROPAGATING.depth = depth + 1
        try:
            return fn(self, *a, **k)
        finally:
            _PROPAGATING.depth = depth

    guarded._repro_guarded = True
    setattr(cls, name, guarded)


def _held(t) -> bool:
    """Whether a rank holds ``t``'s bytes: a tensor on the meta device
    (its device as the tensor reports it, a fake tensor's fake device)
    has shape and no storage."""
    return isinstance(t, torch.Tensor) and t.device.type != "meta"


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if _held(t) else 0


def _tensors(tree) -> list:
    """The tensors of an op's arguments or results: nested tuples, lists
    and dicts (an op's arguments nest no deeper than a list of tensors
    in a tuple), other leaves dropped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return []
    out = []
    for t in tree:
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, (tuple, list, dict)):
            out.extend(_tensors(t))
    return out


class LocalCounter:
    """A dispatch mode that counts the ops each rank runs on its local
    shards: FLOPs (``torch.utils.flop_counter``'s formulas), operand and
    result bytes, the ``c10d_functional`` collectives by kind and loop
    placement (:attr:`loops`, a :class:`.trace_analysis.LoopTracer`), and
    the peak of live bytes the ops make (:attr:`peak_bytes`).  An op on
    DTensors is handed on (DTensor runs it on the local shards, which this
    mode then sees); an op DTensor's sharding propagation traces on the
    global shapes is not counted.  Active inside ``with counter:``; the
    storages of :meth:`hold` (the step's arguments) are not counted, and
    :attr:`argument_bytes` sums those an op reads (as XLA's executable
    takes only the arguments its program uses)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary
        from ..analysis.contracts import COLLECTIVE_NAMESPACES
        counter = self
        self.flops = 0
        self.op_flops: Dict[str, int] = {}
        self.bytes = 0
        self.loops = LoopTracer()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        # storage -> its weak reference (None for a held storage)
        self._storages = WeakIdKeyDictionary()
        # held storage no op has read yet -> its bytes
        self._unread = WeakIdKeyDictionary()
        _guard_propagation()

        from torch.distributed.tensor import DTensor
        plans: Dict[Any, tuple] = {}

        def plan(func) -> tuple:
            """``(kind, flop formula or None, collective kind)`` of an op:
            kind 0 moves no bytes (a view, metadata, a ``prim`` op), 1
            counts bytes, 2 is a collective, 3 is not counted at all."""
            ns = func.namespace
            name = func._overloadpacket.__name__
            if ns in COLLECTIVE_NAMESPACES:
                if name in _NOT_COLLECTIVES:
                    return 3, None, None
                return 2, None, _KINDS.get(name, name)
            flop = flop_registry.get(func._overloadpacket)
            if ns == "prim" or not func._schema.returns or any(
                    r.alias_info is not None for r in func._schema.returns):
                return 0, flop, None
            return 1, flop, None

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if DTensor in types or func is _DEVICE:
                    return NotImplemented
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if getattr(_PROPAGATING, "depth", 0):
                    return out
                p = plans.get(func)
                if p is None:
                    p = plans[func] = plan(func)
                kind, flop, coll = p
                if kind == 3:
                    return out
                operands = _tensors((args, kwargs))
                if counter._unread:
                    counter._read(operands)
                results = _tensors(out)
                if kind == 2:
                    counter.loops.record(coll, sum(_nbytes(t)
                                                   for t in results))
                    counter._made(results)
                    return out
                if flop is not None:
                    n = flop(*args, **kwargs, out_val=out)
                    counter.flops += n
                    name = func._overloadpacket.__name__
                    counter.op_flops[name] = counter.op_flops.get(name, 0) + n
                if kind == 0:
                    return out      # views and metadata move no bytes
                counter.bytes += sum(_nbytes(t) for t in operands) \
                    + sum(_nbytes(t) for t in results)
                counter._made(results)
                return out

        self.mode = _Mode()

    def __enter__(self) -> "LocalCounter":
        self.loops.__enter__()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.mode.__exit__(*exc)
        self.loops.__exit__(*exc)

    def hold(self, tree) -> None:
        """Leave the storages of a tree's tensors (each rank's shards) out
        of the count: the step's arguments (two leaves of one storage,
        a plain step's tokens and labels, are two arguments)."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                t = t.to_local() if common.is_dtensor(t) else t
                st = t.untyped_storage()
                self._storages[st] = None
                self._unread[st] = self._unread.get(st, 0) + _nbytes(t)

    def _read(self, operands) -> None:
        """Count the held storages among an op's operands (a view of an
        argument reads its storage) that no earlier op read."""
        for t in operands:
            if _held(t):
                n = self._unread.pop(t.untyped_storage(), None)
                if n is not None:
                    self.argument_bytes += n

    def _made(self, results) -> None:
        """Count the storages of an op's outputs that no earlier op made
        (a view's, or an input's handed back, is counted already) and
        that a rank holds (not a meta tensor's)."""
        for t in results:
            if not _held(t):
                continue
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = weakref.ref(
                st, functools.partial(self._freed, n))
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed(self, n: int, _ref) -> None:
        self.live_bytes -= n


def _local_bytes(tree) -> int:
    """Each rank's bytes of a tree's tensors (its shards of DTensors)."""
    return sum(_nbytes(t.to_local() if common.is_dtensor(t) else t)
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# One cell


def cell_step(cfg, cell, mesh=None, psh=None, opt_dtype: str = "float32",
              seq_shard: bool = True):
    """``(step, args, tokens)`` of one cell: the step function, its
    arguments (parameters, AdamW state for a train step, batch or cache
    and tokens, the decode position) and the tokens it processes.  On
    ``mesh`` the tensors are DTensors placed by ``psh`` (the parameters'
    placements) and the reference's batch and cache rules; without one
    they are plain.  Made under a ``FakeTensorMode``, the tensors are
    fake; outside one, real CPU tensors of undefined values."""
    def put(tree, shardings):
        """``tree`` placed by ``shardings(tree)`` on the mesh, if any."""
        return tree if mesh is None else place(tree, shardings(tree), mesh)

    params = put(common.abstract_params(registry.param_specs(cfg), "cpu"),
                 lambda _: psh)
    if cell.kind in ("train", "prefill"):
        batch = put(registry.train_input_specs(
            cfg, cell.global_batch, cell.seq_len, "cpu"),
            lambda t: batch_shardings(t, mesh))
        args = [params, batch]
        tokens = cell.global_batch * cell.seq_len
    else:
        tok, _, cache = registry.decode_input_specs(
            cfg, cell.global_batch, cell.seq_len, "cpu")
        cache = put(cache, lambda t: cache_shardings(
            t, cfg, cell.global_batch, mesh, cell.seq_len, seq_shard))
        tok = put(tok, lambda t: batch_shardings(t, mesh))
        args = [params, cache, tok]
        tokens = cell.global_batch
    if cell.kind == "train":
        ocfg = AdamWConfig(state_dtype=_DTYPES[opt_dtype])
        opt = adamw_init(params, ocfg)
        opt = type(opt)(step=opt.step, m=put(opt.m, lambda _: psh),
                        v=put(opt.v, lambda _: psh))
        args.insert(1, opt)
        step = make_train_step(cfg, ocfg)
    elif cell.kind == "prefill":
        step = make_prefill_step(cfg)
    else:
        step = make_decode_step(cfg)
        args.append(cell.seq_len - 1)     # the last position
    return step, args, tokens


def trace_step(step, args) -> tuple:
    """Run ``step(*args)`` under a :class:`LocalCounter` that holds the
    arguments' storages: ``(counter, out, seconds)``."""
    counter = LocalCounter()
    counter.hold(args)
    t0 = time.time()
    with counter:
        out = step(*args)
    return counter, out, time.time() - t0


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: Optional[dict] = None, opt_dtype: str = "float32",
             donate: bool = True, mesh_shape: Optional[tuple] = None,
             replicate_fsdp: bool = False, cfg=None, cell=None) -> dict:
    """Trace one cell's step on the production mesh (or ``mesh_shape``,
    same chip count) of a fake group; ``cfg`` replaces the arch's config
    (the roofline's probes and the tests' reduced configs), ``cell`` (a
    ``configs.ShapeCell``) the shape's.  A ``mesh_shape`` of one rank
    traces plain tensors.  ``donate`` has no counterpart here (an eager
    step makes new tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from .mesh import force_host_platform_device_count, make_production_mesh
    del donate
    cell = cell or configs.SHAPES[shape_name]
    if cfg is None:
        cfg = build_config(arch, shape_name, overrides or {})
    if mesh_shape is not None and math.prod(mesh_shape) == 1:
        mesh = None
    elif mesh_shape is not None:
        # per-arch mesh reshaping: same chip count, another split
        axes = ("pod", "data", "model") if len(mesh_shape) == 3 \
            else ("data", "model")
        force_host_platform_device_count(math.prod(mesh_shape))
        mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                mesh_dim_names=axes)
    else:
        force_host_platform_device_count(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    shape = list(mesh_shape if mesh is None else mesh.shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "chips": math.prod(shape), "mesh_shape": shape, "ok": False}
    specs = registry.param_specs(cfg)
    counts = count_params(specs)
    rec["params_total"] = counts["total"]
    rec["params_expert"] = counts["expert"]
    rules = None
    if replicate_fsdp:
        # inference sharding profile: no optimizer state, so FSDP weight
        # all-gathers buy nothing -- replicate over data, keep TP/EP only
        rules = dict(common.DEFAULT_RULES, embed=())
    psh = None if mesh is None else common.param_shardings(specs, mesh,
                                                            rules)
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args, tokens = cell_step(
            cfg, cell, mesh, psh, opt_dtype,
            bool((overrides or {}).get("seq_shard_cache", True)))
        counter, out, seconds = trace_step(step, args)
        rec["trace_s"] = round(seconds, 2)
        out_bytes = _local_bytes(out)
    rec["memory_analysis"] = {"argument_size_in_bytes":
                              int(counter.argument_bytes),
                              "output_size_in_bytes": int(out_bytes),
                              "temp_size_in_bytes": int(counter.peak_bytes)}
    rec["model_flops"] = model_flops(cfg, counts, tokens, cell.kind)
    rec["flops"] = float(counter.flops)
    rec["flops_source"] = "flop_counter"
    rec["flops_by_op"] = dict(counter.op_flops)
    rec["bytes_accessed"] = float(counter.bytes)
    coll = counter.loops.stats()
    # Static: outside every loop; in_loop: one trip of each loop (the
    # reference's meanings); all_trips: every collective the step issued.
    rec["collective_bytes_static"] = coll.total_bytes
    rec["collective_by_kind"] = coll.bytes_by_kind
    rec["collective_counts"] = coll.count_by_kind
    rec["collective_in_loop_bytes"] = coll.total_in_loop_bytes
    rec["collective_in_loop_by_kind"] = coll.in_loop_bytes_by_kind
    rec["collective_in_loop_counts"] = coll.in_loop_count_by_kind
    rec["while_trip_counts"] = counter.loops.trip_counts()
    rec["collective_bytes_all_trips"] = coll.total_all_trips_bytes
    rec["collective_all_trips_by_kind"] = coll.all_trips_bytes_by_kind
    rec["collective_all_trips_counts"] = coll.all_trips_count_by_kind
    rec["collective_loops"] = coll.loops
    rec["collective_uneven_trips"] = coll.uneven
    rec["tokens"] = tokens
    rec["ok"] = True
    return rec


# ---------------------------------------------------------------------------
# The sweep (one subprocess per cell: the fake group is per process)


def all_cells():
    for arch in configs.ARCHS:
        cfg = configs.get_config(arch)
        for shape in configs.supported_shapes(cfg):
            yield arch, shape


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. attn_chunk=2048")
    ap.add_argument("--opt-dtype", default="float32")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 32,8 -- chips must still multiply to 256/512")
    ap.add_argument("--replicate-fsdp", action="store_true",
                    help="inference profile: weights replicated over data")
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args(argv)
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split(","))
                  if args.mesh_shape else None)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        failures = 0
        for arch, shape in all_cells():
            for mesh in args.meshes.split(","):
                tag = f"{arch}_{shape}_{mesh}_{args.tag}"
                path = outdir / f"{tag}.json"
                if path.exists() and json.loads(path.read_text()).get("ok"):
                    print(f"[skip] {tag}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh,
                       "--out", str(outdir), "--tag", args.tag,
                       "--opt-dtype", args.opt_dtype]
                for ov in args.override:
                    cmd += ["--override", ov]
                print(f"[run ] {tag}", flush=True)
                try:
                    subprocess.run(cmd, check=True, timeout=args.timeout)
                except Exception as e:
                    failures += 1
                    path.write_text(json.dumps(
                        {"arch": arch, "shape": shape, "mesh": mesh,
                         "ok": False, "error": f"subprocess: {e}"}))
                    print(f"[FAIL] {tag}: {e}", flush=True)
        print(f"sweep done, failures={failures}")
        sys.exit(1 if failures else 0)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    tag = f"{args.arch}_{args.shape}_{args.mesh}_{args.tag}"
    path = outdir / f"{tag}.json"
    try:
        rec = run_cell(args.arch, args.shape, args.mesh == "multi",
                       overrides, args.opt_dtype, mesh_shape=mesh_shape,
                       replicate_fsdp=args.replicate_fsdp)
    except Exception as e:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "ok": False, "error": repr(e),
               "traceback": traceback.format_exc()}
    path.write_text(json.dumps(rec, indent=2))
    status = "OK" if rec.get("ok") else f"ERROR: {rec.get('error')}"
    print(f"{tag}: {status}  (trace {rec.get('trace_s', '?')}s, "
          f"flops {rec.get('flops', 0):.3e})")
    if not rec.get("ok"):
        print(rec.get("traceback", ""))
        sys.exit(1)


if __name__ == "__main__":
    main()
