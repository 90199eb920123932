"""Run summaries and run-vs-run diffs over the obs JSONL schema (a copy
of ``repro/obs/summary.py``, which the port does not import).

``summarize`` condenses a run into the paper's own accounting: exact
oracle calls to reach gap targets (the Fig. 4-6 statistic), cache
hit/evict rates, the host-sync / dispatch / collective ledger versus the
engine's declared budgets, and a per-phase time breakdown from the
spans.  ``diff_runs`` compares two summaries for regression checks — the
CLI (`python -m repro_torch.obs`) prints both.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

# Gap thresholds (fractions of the first iteration's gap) for the
# "oracle calls to target" table; relative, so every scenario reports.
_GAP_FRACTIONS = (0.5, 0.2, 0.1)


def read_records(path) -> List[dict]:
    """Decode a run JSONL file into a record list (blank lines skipped)."""
    out = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def load_run(path) -> dict:
    """Group a run's records by type: meta/rows/spans/events/summary."""
    records = read_records(path)
    run = {"meta": {}, "rows": [], "spans": [], "events": [],
           "summary": {}}
    for r in records:
        t = r.get("type")
        if t == "meta":
            run["meta"] = r
        elif t == "row":
            run["rows"].append(r)
        elif t == "span":
            run["spans"].append(r)
        elif t == "event":
            run["events"].append(r)
        elif t == "summary":
            run["summary"] = r.get("metrics", {})
    return run


def _calls_to_gap_targets(rows: List[dict]) -> Dict[str, Optional[int]]:
    """Exact-oracle calls needed to first reach each gap target."""
    out: Dict[str, Optional[int]] = {}
    gaps = [r.get("gap") for r in rows]
    first = next((g for g in gaps if g is not None), None)
    if first is None or first <= 0:
        return out
    for frac in _GAP_FRACTIONS:
        target = first * frac
        key = f"gap<={frac}*g0"
        out[key] = next((r["n_exact"] for r, g in zip(rows, gaps)
                         if g is not None and g <= target), None)
    return out


def summarize(run: dict) -> dict:
    """Condense one loaded run into the headline accounting dict."""
    rows = run["rows"]
    meta = run["meta"]
    s: dict = {"algo": meta.get("algo"), "n": meta.get("n"),
               "time_mode": meta.get("time_mode"),
               "iterations": len(rows)}
    if not rows:
        return s
    last = rows[-1]
    s["final_gap"] = last.get("gap")
    s["final_dual"] = last.get("dual")
    s["oracle_calls"] = last.get("n_exact")
    s["approx_calls"] = last.get("n_approx")
    s["total_time"] = last.get("time")
    s["calls_to_gap"] = _calls_to_gap_targets(rows)

    # Cache economics (the paper's whole premise: trade cached-plane
    # passes for oracle calls).
    hits = [r.get("cache_hit_rate", 0.0) for r in rows]
    s["cache_hit_rate_mean"] = sum(hits) / len(hits)
    s["planes_evicted_total"] = sum(r.get("planes_evicted", 0)
                                    for r in rows)
    s["approx_passes_mean"] = (sum(r.get("approx_passes", 0)
                                   for r in rows) / len(rows))
    shares = [r.get("oracle_share", 1.0) for r in rows]
    s["oracle_share_mean"] = sum(shares) / len(shares)
    # Pipelining efficiency (async engines; 0.0 everywhere else):
    # fraction of modeled oracle time hidden behind the cache program.
    overlaps = [r.get("oracle_overlap", 0.0) for r in rows]
    s["oracle_overlap_mean"] = sum(overlaps) / len(overlaps)

    # Sync/dispatch/collective ledger vs the engine's declared budgets.
    budgets = meta.get("engine_budgets", {})
    sync_max = max(r.get("host_syncs", 0) for r in rows)
    disp_max = max(r.get("dispatches", 0) for r in rows)
    coll_total = max((r.get("collectives", 0) for r in rows), default=0)
    bytes_total = max((r.get("collective_bytes", 0) for r in rows),
                      default=0)
    s["contract"] = {
        "host_syncs_per_iter_max": sync_max,
        "dispatches_per_iter_max": disp_max,
        "collectives_total": coll_total,
        "collective_bytes_total": bytes_total,
        "declared_budgets": budgets,
        # Collectives may only appear on engines that declared a
        # collective budget; everything else must report zero.
        "within_budget": bool(
            budgets.get("collectives_per_pass", 0) > 0 or coll_total == 0),
    }

    # Per-phase time breakdown from the spans (run timebase).
    phase: Dict[str, float] = {}
    for sp in run["spans"]:
        if sp.get("timebase") != "run" or sp["name"] == "outer_iteration":
            continue
        phase[sp["name"]] = (phase.get(sp["name"], 0.0)
                             + max(sp["t1"] - sp["t0"], 0.0))
    host_phase: Dict[str, float] = {}
    for sp in run["spans"]:
        if sp.get("timebase") == "host":
            host_phase[sp["name"]] = (host_phase.get(sp["name"], 0.0)
                                      + max(sp["t1"] - sp["t0"], 0.0))
    s["phase_time"] = phase
    s["host_phase_time"] = host_phase
    return s


def summarize_run(path) -> dict:
    """One-call convenience: ``summarize(load_run(path))``."""
    return summarize(load_run(path))


def format_summary(s: dict) -> str:
    lines = [
        f"run: algo={s.get('algo')} n={s.get('n')} "
        f"time_mode={s.get('time_mode')}",
        f"iterations:        {s.get('iterations', 0)}",
    ]
    if s.get("iterations"):
        lines += [
            f"oracle calls:      {s.get('oracle_calls')}"
            f"   approx calls: {s.get('approx_calls')}",
            f"final gap:         {_fmt(s.get('final_gap'))}"
            f"   final dual: {_fmt(s.get('final_dual'))}",
            f"total time:        {_fmt(s.get('total_time'))} s "
            f"({s.get('time_mode')})",
        ]
        for key, calls in (s.get("calls_to_gap") or {}).items():
            lines.append(f"  oracle calls to {key}: "
                         f"{calls if calls is not None else 'not reached'}")
        lines += [
            f"cache hit rate:    {_fmt(s.get('cache_hit_rate_mean'))} "
            f"(mean)   planes evicted: {s.get('planes_evicted_total')}",
            f"approx passes:     {_fmt(s.get('approx_passes_mean'))} "
            f"per iteration (mean)",
            f"oracle wall share: {_fmt(s.get('oracle_share_mean'))} (mean)",
            f"oracle overlap:    {_fmt(s.get('oracle_overlap_mean'))} "
            f"(mean, async pipelining)",
        ]
        c = s.get("contract", {})
        lines += [
            "contract: "
            f"host_syncs/iter<={c.get('host_syncs_per_iter_max')} "
            f"dispatches/iter<={c.get('dispatches_per_iter_max')} "
            f"collectives={c.get('collectives_total')} "
            f"bytes={c.get('collective_bytes_total')}",
            f"  declared budgets: {c.get('declared_budgets')}",
        ]
        for name, t in sorted((s.get("phase_time") or {}).items()):
            lines.append(f"  phase {name}: {_fmt(t)} s")
        for name, t in sorted((s.get("host_phase_time") or {}).items()):
            lines.append(f"  host phase {name}: {_fmt(t)} s")
    return "\n".join(lines)


def _fmt(v) -> str:
    if v is None:
        return "n/a"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


# -- run-vs-run diff ---------------------------------------------------------

_DIFF_KEYS = ("iterations", "oracle_calls", "approx_calls", "final_gap",
              "final_dual", "total_time", "cache_hit_rate_mean",
              "planes_evicted_total", "approx_passes_mean",
              "oracle_share_mean", "oracle_overlap_mean")


def diff_runs(run_a: dict, run_b: dict) -> dict:
    """Headline metric deltas of two loaded runs (b relative to a)."""
    sa, sb = summarize(run_a), summarize(run_b)
    out = {"a": {"algo": sa.get("algo")}, "b": {"algo": sb.get("algo")},
           "deltas": {}}
    for key in _DIFF_KEYS:
        va, vb = sa.get(key), sb.get(key)
        entry = {"a": va, "b": vb}
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            entry["delta"] = vb - va
            if va:
                entry["ratio"] = vb / va
        out["deltas"][key] = entry
    ca = sa.get("contract", {}) or {}
    cb = sb.get("contract", {}) or {}
    out["contract"] = {
        "host_syncs_per_iter_max":
            {"a": ca.get("host_syncs_per_iter_max"),
             "b": cb.get("host_syncs_per_iter_max")},
        "collectives_total": {"a": ca.get("collectives_total"),
                              "b": cb.get("collectives_total")},
    }
    return out


def format_diff(d: dict) -> str:
    lines = [f"diff: a(algo={d['a'].get('algo')}) vs "
             f"b(algo={d['b'].get('algo')})"]
    for key, entry in d["deltas"].items():
        va, vb = _fmt(entry.get("a")), _fmt(entry.get("b"))
        extra = ""
        if "delta" in entry:
            extra = f"   delta={_fmt(entry['delta'])}"
            if "ratio" in entry:
                extra += f" (x{_fmt(entry['ratio'])})"
        lines.append(f"  {key:24s} a={va:>12s} b={vb:>12s}{extra}")
    c = d.get("contract", {})
    for key, entry in c.items():
        lines.append(f"  {key:24s} a={_fmt(entry.get('a')):>12s} "
                     f"b={_fmt(entry.get('b')):>12s}")
    return "\n".join(lines)
