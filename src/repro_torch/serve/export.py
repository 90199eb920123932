"""Train -> serve export: :class:`ServableModel` and spec serialization
(PyTorch port of ``repro/serve/export.py``).

A deployed structural SVM is a weight vector ``w`` plus the task's
:class:`~repro_torch.api.oracle.OracleSpec`: a request runs the same
``spec.decode`` the max-oracle ran in training (Viterbi, ICM, an argmax).
:meth:`ServableModel.save` and :meth:`ServableModel.load` ride
:class:`repro_torch.checkpoint.CheckpointManager` in the reference's
format: ``w`` in the npz, the spec's kind and constructor parameters in
the manifest's ``extra["servable"]``, key for key as the reference
writes them, so an export of either package loads in the other.

Specs (de)serialize through a small registry: the three shipped specs are
``"chain"``, ``"multiclass"`` and ``"graph"``; a third-party spec becomes
servable with one :func:`register_servable_spec` call (a dataclass whose
fields round-trip through JSON).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np
import torch

from ..api.oracle import OracleSpec
from ..checkpoint.manager import CheckpointManager
from ..core.oracles.chain import resolve_device

#: kind -> spec class (load side); class -> kind is the reverse lookup.
_SPEC_KINDS: Dict[str, Type[OracleSpec]] = {}


def register_servable_spec(kind: str, spec_cls: Type[OracleSpec]) -> None:
    """Make ``spec_cls`` exportable and loadable under the name ``kind``.

    The class must be constructible from its ``dataclasses.asdict``
    parameters.  Re-registering a kind replaces it (latest wins).
    """
    _SPEC_KINDS[kind] = spec_cls


def unregister_servable_spec(kind: str) -> None:
    _SPEC_KINDS.pop(kind, None)


def servable_spec_kinds() -> Tuple[str, ...]:
    return tuple(sorted(_SPEC_KINDS))


def spec_kind(spec: OracleSpec) -> str:
    """The registered kind of ``spec`` (exact class match)."""
    for kind, cls in _SPEC_KINDS.items():
        if type(spec) is cls:
            return kind
    raise KeyError(
        f"{type(spec).__name__} is not a registered servable spec; call "
        "repro_torch.serve.register_servable_spec(kind, cls) to export it")


def _spec_params(spec: OracleSpec) -> dict:
    if dataclasses.is_dataclass(spec):
        return dataclasses.asdict(spec)
    return {}


def _load_spec(kind: str, params: dict) -> OracleSpec:
    cls = _SPEC_KINDS.get(kind)
    if cls is None:
        raise KeyError(
            f"servable spec kind {kind!r} is not registered in this "
            f"process (known: {list(servable_spec_kinds())}); import or "
            "register_servable_spec the task module before loading")
    return cls(**params)


def _register_builtin_specs() -> None:
    from ..core.oracles.chain import ChainSpec
    from ..core.oracles.graph import GraphSpec
    from ..core.oracles.multiclass import MulticlassSpec

    register_servable_spec("chain", ChainSpec)
    register_servable_spec("multiclass", MulticlassSpec)
    register_servable_spec("graph", GraphSpec)


_register_builtin_specs()


def _as_batch_of_one(example: Dict[str, Any], device) -> Dict[str, Any]:
    def leaf(v):
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        return t.to(device)[None]
    return {k: leaf(v) for k, v in example.items()}


@dataclass
class ServableModel:
    """A trained SSVM ready to serve: ``(spec, w, meta)``.

    ``w`` is a float32 tensor; its device is where the model decodes.
    :meth:`decode` is the train-time oracle decode of one example; the
    batched serving path (:mod:`repro_torch.serve.engine`,
    :class:`repro_torch.serve.batcher.StructuredServer`) is held to it
    label for label.
    """

    spec: OracleSpec
    w: torch.Tensor
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def d(self) -> int:
        return int(self.w.shape[0])

    def decode(self, example: Dict[str, Any]) -> torch.Tensor:
        """Per-example structured decode, the train-time oracle: the
        spec's batched decode of ``example`` (a dict of host arrays or
        tensors, no batch axis) as a batch of one, on ``w``'s device."""
        return self.spec.decode(self.w,
                                _as_batch_of_one(example, self.w.device))[0]

    # -- provenance ---------------------------------------------------------

    @classmethod
    def from_solver(cls, solver, *, averaged: bool = False,
                    meta: Optional[dict] = None) -> "ServableModel":
        """Export the solver's current weights, on the device of its
        problem's data (see also :meth:`repro_torch.api.Solver.servable`).
        """
        spec = getattr(solver.problem, "spec", None)
        if spec is None:
            raise ValueError(
                "the solver's problem was not built from an OracleSpec "
                "(problem.spec is None); construct the problem via "
                "repro_torch.api.build_problem to make it servable")
        w, w_avg = solver.engine.extract(solver.state)
        if averaged and w_avg is None:
            raise ValueError(f"algo {solver.cfg.algo!r} keeps no averaged "
                             "iterate; export with averaged=False")
        base = {
            "algo": solver.cfg.algo,
            "iteration": int(solver.iteration),
            "n": int(solver.problem.n),
            "averaged": bool(averaged),
        }
        row = getattr(solver, "_last_row", None)
        if row is not None:
            base["train_gap"] = float(row.gap)
        base.update(meta or {})
        device = next(iter(solver.problem.data.values())).device
        weights = torch.as_tensor(np.asarray(w_avg if averaged else w),
                                  dtype=torch.float32, device=device)
        return cls(spec=spec, w=weights, meta=base)

    # -- persistence (rides the checkpoint manifest) ------------------------

    def save(self, manager: CheckpointManager, step: int = 0) -> int:
        """Write ``w`` and the serialized spec as one atomic checkpoint."""
        extra = {
            "servable": {
                "kind": spec_kind(self.spec),
                "params": _spec_params(self.spec),
                "meta": dict(self.meta),
                "d": self.d,
            },
        }
        manager.save(step, {"w": self.w}, extra=extra)
        return step

    @classmethod
    def load(cls, manager: CheckpointManager, step: Optional[int] = None,
             *, device: Optional[Any] = None) -> "ServableModel":
        """Rebuild spec and weights from a servable checkpoint, with ``w``
        on ``device`` (CUDA unless the caller asks for the CPU).  The
        manifest is checked before the npz is read."""
        dev = resolve_device(device)
        if step is None:
            step = manager.latest_step()
        manifest = manager.load_manifest(step)
        sv = manifest.get("extra", {}).get("servable")
        if sv is None:
            raise ValueError(
                f"checkpoint step {step} in {manager.dir} is not a "
                "servable export (no extra['servable'] manifest entry); "
                "save one with ServableModel.save")
        spec = _load_spec(sv["kind"], sv.get("params", {}))
        leaf = manifest["leaves"]["w"]
        dtype = torch.from_numpy(np.empty(0, leaf["dtype"])).dtype
        template = {"w": torch.empty(tuple(leaf["shape"]), dtype=dtype,
                                     device=dev)}
        tree, _ = manager.restore(template, step)
        return cls(spec=spec, w=tree["w"], meta=dict(sv.get("meta", {})))
