"""Carry optimizer state and chain data across from numpy.

:func:`mp_state_from_numpy` turns an MP-BCFW state held as numpy arrays,
in the reference's ``MPState`` layout (``inner.phi_i``, ``inner.phi``,
``inner.n_exact``, ``inner.n_approx``, ``cache.planes``, ``cache.valid``,
``cache.last_active``, ``cache.gram`` (None without Gram blocks),
``cache.gap`` (None without a gap vector),
``avg.bar_exact``, ``avg.bar_approx``,
``avg.k_exact``, ``avg.k_approx``, ``outer_it``), into the port's
:class:`~repro_torch.core.mpbcfw.MPState` on a device.  A reference state
fetched to the host mid-run, with a part-filled cache, can then be run
forward by both packages from the same point.  :func:`mp_state_to_numpy`
goes the other way, into a flat dict of the same field names.
:func:`async_state_from_numpy` and :func:`async_state_to_numpy` do the
same for the pipelined engine's ``AsyncMPState``: the ``mp`` fields plus
the pending buffer ``pending.{ids, planes, done, live}``.
:func:`lm_params_from_numpy` and :func:`lm_params_to_numpy` carry an LM's
parameter tree (a nested dict, the reference's layout) across;
:func:`adamw_state_from_numpy` and :func:`adamw_state_to_numpy` its AdamW
state (``step``, ``m``, ``v``), and :func:`lm_train_state_from_numpy` and
:func:`lm_train_state_to_numpy` the trainer's whole state, ``{"params",
"opt"}``, as ``repro.launch.train`` keeps it.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .cache.state import PlaneCache
from .core.mpbcfw import AsyncMPState, MPState, PendingOracle
from .core.oracles import chain
from .core.types import AveragingState, BCFWState, SSVMProblem


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                       dtype=dtype)


def mp_state_from_numpy(tree: Any, device) -> MPState:
    """The port's state from a reference ``MPState`` of numpy arrays."""
    f32, dev = torch.float32, torch.device(device)
    inner, cache, avg = tree.inner, tree.cache, tree.avg
    gram = getattr(cache, "gram", None)
    gap = getattr(cache, "gap", None)
    return MPState(
        inner=BCFWState(phi_i=_t(inner.phi_i, f32, dev),
                        phi=_t(inner.phi, f32, dev),
                        n_exact=int(inner.n_exact),
                        n_approx=int(inner.n_approx)),
        cache=PlaneCache(planes=_t(cache.planes, f32, dev),
                         valid=_t(cache.valid, torch.bool, dev),
                         last_active=_t(cache.last_active, torch.int32, dev),
                         gram=None if gram is None else _t(gram, f32, dev),
                         gap=None if gap is None else _t(gap, f32, dev)),
        avg=AveragingState(bar_exact=_t(avg.bar_exact, f32, dev),
                           bar_approx=_t(avg.bar_approx, f32, dev),
                           k_exact=int(avg.k_exact),
                           k_approx=int(avg.k_approx)),
        outer_it=int(tree.outer_it))


def mp_state_to_numpy(mp: MPState) -> Dict[str, Any]:
    """Flat dict of numpy arrays and ints, keyed by field name."""
    def host(t):
        return t.detach().cpu().numpy()
    return {"phi_i": host(mp.inner.phi_i), "phi": host(mp.inner.phi),
            "n_exact": mp.inner.n_exact, "n_approx": mp.inner.n_approx,
            "planes": host(mp.cache.planes), "valid": host(mp.cache.valid),
            "last_active": host(mp.cache.last_active),
            "gram": (None if mp.cache.gram is None
                     else host(mp.cache.gram)),
            "gap": None if mp.cache.gap is None else host(mp.cache.gap),
            "bar_exact": host(mp.avg.bar_exact),
            "bar_approx": host(mp.avg.bar_approx),
            "k_exact": mp.avg.k_exact, "k_approx": mp.avg.k_approx,
            "outer_it": mp.outer_it}


def async_state_from_numpy(tree: Any, device) -> AsyncMPState:
    """The port's pipelined state from a reference ``AsyncMPState`` of
    numpy arrays.  The pending ``ids`` and ``done`` stay host arrays."""
    p = tree.pending
    return AsyncMPState(
        mp=mp_state_from_numpy(tree.mp, device),
        pending=PendingOracle(
            ids=np.array(p.ids, dtype=np.int64),
            planes=_t(p.planes, torch.float32, torch.device(device)),
            done=np.array(p.done, dtype=bool), live=bool(p.live)))


def async_state_to_numpy(state: AsyncMPState) -> Dict[str, Any]:
    """:func:`mp_state_to_numpy` of ``state.mp``, with the pending buffer
    under ``"pending"`` (``ids``, ``planes``, ``done``, ``live``)."""
    p = state.pending
    return {**mp_state_to_numpy(state.mp), "pending": {
        "ids": np.array(p.ids, dtype=np.int64),
        "planes": p.planes.detach().cpu().numpy(),
        "done": np.array(p.done, dtype=bool), "live": bool(p.live)}}


def lm_params_from_numpy(tree: Any, cfg, device,
                         dtype: Any = None) -> Dict[str, Any]:
    """The port's parameters from a reference parameter tree of numpy
    arrays (``jax.device_get(params)``), in each spec's dtype (or
    ``dtype``) on ``device``.

    JAX's bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
    ``torch.from_numpy`` rejects; they go through float32, which holds
    every bfloat16 value exactly, and are cast back."""
    from .models import registry
    specs = registry.param_specs(cfg)

    def walk(spec, leaf, path):
        if isinstance(spec, dict):
            if not isinstance(leaf, dict) or set(leaf) != set(spec):
                raise ValueError(f"lm_params_from_numpy: keys at {path!r} "
                                 "differ from the config's specs")
            return {k: walk(spec[k], leaf[k], f"{path}/{k}") for k in spec}
        a = np.asarray(leaf)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"lm_params_from_numpy: {path} has shape "
                             f"{a.shape}, the spec {spec.shape}")
        return _t(a.astype(np.float32), dtype or spec.dtype,
                  torch.device(device))
    return walk(specs, tree, "")


def lm_params_to_numpy(params: Any) -> Any:
    """The parameter tree as float32 numpy arrays (exact for bfloat16)."""
    if isinstance(params, dict):
        return {k: lm_params_to_numpy(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()


def adamw_state_from_numpy(tree: Any, cfg, device,
                           state_dtype: Any = torch.float32):
    """The port's :class:`~repro_torch.optim.AdamWState` from a reference
    ``AdamWState`` of numpy arrays: the step counter a host int, the
    moments trees of the config's parameter layout in ``state_dtype``."""
    from .optim import AdamWState
    return AdamWState(
        step=int(tree.step),
        m=lm_params_from_numpy(tree.m, cfg, device, state_dtype),
        v=lm_params_from_numpy(tree.v, cfg, device, state_dtype))


def adamw_state_to_numpy(state) -> Dict[str, Any]:
    """``{"step": int, "m", "v"}``, the moments as float32 numpy trees."""
    return {"step": int(state.step), "m": lm_params_to_numpy(state.m),
            "v": lm_params_to_numpy(state.v)}


def lm_train_state_from_numpy(tree: Any, cfg, device,
                              state_dtype: Any = torch.float32) -> dict:
    """The trainer's ``{"params", "opt"}`` from the reference's, fetched
    to the host (``jax.device_get(state)``)."""
    return {"params": lm_params_from_numpy(tree["params"], cfg, device),
            "opt": adamw_state_from_numpy(tree["opt"], cfg, device,
                                          state_dtype)}


def lm_train_state_to_numpy(state: dict) -> dict:
    """The trainer's state as ``{"params", "opt"}`` of float32 numpy
    trees (:func:`lm_params_to_numpy`, :func:`adamw_state_to_numpy`)."""
    return {"params": lm_params_to_numpy(state["params"]),
            "opt": adamw_state_to_numpy(state["opt"])}


def problem_from_numpy(features: np.ndarray, labels: np.ndarray,
                       mask: np.ndarray, num_labels: int,
                       device) -> SSVMProblem:
    """The chain problem of the reference's ``chain.make_problem`` inputs
    (numpy ``x (n, L, f)``, ``y (n, L)``, ``mask (n, L)``) on ``device``."""
    return chain.make_problem(np.asarray(features), np.asarray(labels),
                              np.asarray(mask), num_labels, device=device)
