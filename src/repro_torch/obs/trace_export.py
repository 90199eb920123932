"""Chrome-trace / Perfetto export of a run JSONL (a copy of
``repro/obs/trace_export.py``, which the port does not import).

``to_chrome_trace`` maps the schema onto the Trace Event Format that
both ``chrome://tracing`` and https://ui.perfetto.dev load directly:

  * ``span``  -> complete events (``ph: "X"``) — one row (tid) per span
    name, run-clock and host-clock spans on separate tids;
  * ``event`` -> instant events (``ph: "i"``);
  * ``row``   -> counter tracks (``ph: "C"``) for dual/gap/hit-rate/
    working-set so convergence is visible on the same timeline.

Timestamps are microseconds as the format requires; run-clock seconds
(wall or CostModel-virtual) scale by 1e6 either way — under a CostModel
the timeline is the *virtual* schedule, which is exactly the paper's
deterministic accounting.
"""
from __future__ import annotations

import json
from typing import Dict, List

_US = 1e6
_PID = 1
# Stable tid layout: known span rows first, counters implicit, host rows
# offset so checkpoint spans never interleave with run-clock phases.
_TIDS = {"outer_iteration": 1, "exact_pass": 2, "approx_passes": 3}
_HOST_TID = 10


def to_chrome_trace(records: List[dict]) -> dict:
    """Trace Event Format dict from decoded run records."""
    events = []
    meta = next((r for r in records if r.get("type") == "meta"), {})
    next_tid = [_HOST_TID + 1]
    tids: Dict[str, int] = dict(_TIDS)

    def tid_for(name: str, timebase: str) -> int:
        if timebase == "host":
            return _HOST_TID
        if name not in tids:
            tids[name] = next_tid[0]
            next_tid[0] += 1
        return tids[name]

    for r in records:
        rtype = r.get("type")
        if rtype == "span":
            t0, t1 = float(r["t0"]), float(r["t1"])
            args = {k: v for k, v in r.items()
                    if k not in ("type", "name", "t0", "t1", "timebase")}
            events.append({
                "name": r["name"], "ph": "X", "pid": _PID,
                "tid": tid_for(r["name"], r.get("timebase", "run")),
                "ts": t0 * _US, "dur": max(t1 - t0, 0.0) * _US,
                "args": args,
            })
        elif rtype == "event":
            args = {k: v for k, v in r.items()
                    if k not in ("type", "name", "t")}
            events.append({
                "name": r["name"], "ph": "i", "s": "p", "pid": _PID,
                "tid": tid_for(r["name"], "run"),
                "ts": float(r["t"]) * _US, "args": args,
            })
        elif rtype == "row":
            ts = float(r["time"]) * _US
            for key in ("dual", "gap", "cache_hit_rate", "ws_mean",
                        "gap_total"):
                val = r.get(key)
                if val is None:
                    continue
                events.append({"name": key, "ph": "C", "pid": _PID,
                               "ts": ts, "args": {key: val}})
    for name, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                       "tid": tid, "args": {"name": name}})
    events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                   "tid": _HOST_TID, "args": {"name": "host (checkpoint)"}})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"algo": meta.get("algo"),
                      "time_mode": meta.get("time_mode"),
                      "schema": meta.get("schema")},
    }


def export_chrome_trace(run_path, out_path) -> int:
    """Write the Perfetto-loadable trace JSON; returns #traceEvents."""
    from .summary import read_records

    trace = to_chrome_trace(read_records(run_path))
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(trace, fh)
    return len(trace["traceEvents"])
