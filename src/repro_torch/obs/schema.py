"""The run-trace JSONL schema, one JSON object per line (a copy of
``repro/obs/schema.py``, which the port does not import: both packages
write and read the same files).

Record types (``"type"`` discriminates):

  * ``meta``    — once, first line: schema version, algo, problem shape,
                  the engine's declared contract budgets, time mode.
  * ``row``     — one per outer iteration: the full
                  :class:`~repro_torch.api.config.TraceRow` plus the ledger's
                  cumulative collective count/bytes.  ``oracle_overlap``
                  is the pipelining column: the fraction of the modeled
                  oracle time the async engines hid behind the concurrent
                  cache program this iteration (0.0 on serial engines;
                  two programs per iteration).
  * ``span``    — a timed phase ``[t0, t1)``: ``outer_iteration``,
                  ``exact_pass``, ``approx_passes``, ``checkpoint_save``,
                  ``checkpoint_restore``.  ``timebase`` says which clock
                  the endpoints are on: ``run`` (the solver's wall or
                  CostModel clock) or ``host`` (recorder wall time).
  * ``event``   — a point occurrence: ``cache_evict`` (count > 0),
                  ``collectives`` (per-iteration totals on mesh engines),
                  ``profile_step`` etc.
  * ``summary`` — once, last line: the final
                  :meth:`~repro_torch.obs.MetricsRegistry.snapshot`.

Validation is hand-rolled (no external jsonschema dependency): each
record must carry its required fields with the right JSON types.  NaN
and +-Inf are not valid JSON — the recorder writes them as ``null``, and
the validator rejects raw NaN on the wire.
"""
from __future__ import annotations

import json
import math
from typing import Iterable, List, Tuple

SCHEMA_VERSION = 1

_NUM = (int, float)
# type -> {field: allowed python types}; None in the tuple = nullable.
_REQUIRED = {
    "meta": {"schema": (int,), "algo": (str,), "n": (int,), "d": (int,),
             "time_mode": (str,), "engine_budgets": (dict,)},
    "row": {"iteration": (int,), "n_exact": (int,), "n_approx": (int,),
            "time": _NUM, "primal": _NUM + (type(None),),
            "dual": _NUM + (type(None),), "gap": _NUM + (type(None),),
            "ws_mean": _NUM, "approx_passes": (int,),
            "host_syncs": (int,), "dispatches": (int,),
            "cache_hit_rate": _NUM, "planes_evicted": (int,),
            "oracle_share": _NUM, "oracle_overlap": _NUM,
            "gap_total": _NUM + (type(None),), "gap_sampled": (int,),
            "collectives": (int,), "collective_bytes": (int,)},
    "span": {"name": (str,), "t0": _NUM, "t1": _NUM, "timebase": (str,)},
    "event": {"name": (str,), "t": _NUM},
    "summary": {"metrics": (dict,)},
}


def sanitize(value):
    """Make ``value`` strictly JSON-serializable: NaN/Inf -> null,
    recursively through dicts/lists/tuples."""
    if isinstance(value, float) and not math.isfinite(value):
        return None
    if isinstance(value, dict):
        return {k: sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [sanitize(v) for v in value]
    return value


def validate_record(obj) -> List[str]:
    """Schema errors of one decoded record ([] when valid)."""
    if not isinstance(obj, dict):
        return [f"record is {type(obj).__name__}, not an object"]
    rtype = obj.get("type")
    spec = _REQUIRED.get(rtype)
    if spec is None:
        return [f"unknown record type {rtype!r}"]
    errs = []
    for field, types in spec.items():
        if field not in obj:
            errs.append(f"{rtype}: missing field {field!r}")
        elif not isinstance(obj[field], tuple(types)) or (
                isinstance(obj[field], bool) and bool not in types):
            errs.append(f"{rtype}.{field}: {type(obj[field]).__name__} "
                        f"is not one of {[t.__name__ for t in types]}")
        elif (isinstance(obj[field], float)
              and not math.isfinite(obj[field])):
            errs.append(f"{rtype}.{field}: non-finite float on the wire "
                        "(the writer must null NaN/Inf)")
    return errs


def validate_lines(lines: Iterable[str]) -> Tuple[int, List[str]]:
    """Validate decoded-line stream; returns (n_records, errors)."""
    errs: List[str] = []
    count = 0
    saw_meta = False
    for lineno, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        count += 1
        try:
            obj = json.loads(line)
        except ValueError as e:
            errs.append(f"line {lineno}: not JSON ({e})")
            continue
        for e in validate_record(obj):
            errs.append(f"line {lineno}: {e}")
        if isinstance(obj, dict) and obj.get("type") == "meta":
            if lineno > 1 and saw_meta:
                errs.append(f"line {lineno}: duplicate meta record")
            saw_meta = True
    if count and not saw_meta:
        errs.append("no meta record")
    return count, errs


def validate_file(path) -> Tuple[int, List[str]]:
    """Validate a run JSONL file; returns (n_records, errors)."""
    with open(path, "r", encoding="utf-8") as fh:
        return validate_lines(fh)
