"""Carry optimizer state and chain data across from numpy.

:func:`mp_state_from_numpy` turns an MP-BCFW state held as numpy arrays,
in the reference's ``MPState`` layout (``inner.phi_i``, ``inner.phi``,
``inner.n_exact``, ``inner.n_approx``, ``cache.planes``, ``cache.valid``,
``cache.last_active``, ``avg.bar_exact``, ``avg.bar_approx``,
``avg.k_exact``, ``avg.k_approx``, ``outer_it``), into the port's
:class:`~repro_torch.core.mpbcfw.MPState` on a device.  A reference state
fetched to the host mid-run, with a part-filled cache, can then be run
forward by both packages from the same point.  :func:`mp_state_to_numpy`
goes the other way, into a flat dict of the same field names.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .cache.state import PlaneCache
from .core.mpbcfw import MPState
from .core.oracles import chain
from .core.types import AveragingState, BCFWState, SSVMProblem


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                       dtype=dtype)


def mp_state_from_numpy(tree: Any, device) -> MPState:
    """The port's state from a reference ``MPState`` of numpy arrays."""
    f32, dev = torch.float32, torch.device(device)
    inner, cache, avg = tree.inner, tree.cache, tree.avg
    if getattr(cache, "gram", None) is not None or \
            getattr(cache, "gap", None) is not None:
        raise NotImplementedError("gram and gap cache fields are not ported "
                                  "yet (ROADMAP A5, A6)")
    return MPState(
        inner=BCFWState(phi_i=_t(inner.phi_i, f32, dev),
                        phi=_t(inner.phi, f32, dev),
                        n_exact=int(inner.n_exact),
                        n_approx=int(inner.n_approx)),
        cache=PlaneCache(planes=_t(cache.planes, f32, dev),
                         valid=_t(cache.valid, torch.bool, dev),
                         last_active=_t(cache.last_active, torch.int32, dev)),
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
            "bar_exact": host(mp.avg.bar_exact),
            "bar_approx": host(mp.avg.bar_approx),
            "k_exact": mp.avg.k_exact, "k_approx": mp.avg.k_approx,
            "outer_it": mp.outer_it}


def problem_from_numpy(features: np.ndarray, labels: np.ndarray,
                       mask: np.ndarray, num_labels: int,
                       device) -> SSVMProblem:
    """The chain problem of the reference's ``chain.make_problem`` inputs
    (numpy ``x (n, L, f)``, ``y (n, L)``, ``mask (n, L)``) on ``device``."""
    return chain.make_problem(np.asarray(features), np.asarray(labels),
                              np.asarray(mask), num_labels, device=device)
