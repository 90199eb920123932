"""device_idle: the share of the traced window (one whole outer
iteration, its record_function span) in which no kernel or copy ran on
the card: 1 - (union of the device records' intervals) / window, in %.
Overlapping records (two streams) count once.  Device trace.  The window
is the traced iteration's, so its idle share includes what the profiler
costs the host (a callback per op and per launch): an upper bound on an
untraced iteration's.  Nothing where the trace lost a record of the
port's named kernels."""

from bench import counting


def read(run):
    if not run.trace_complete:
        return None
    tr = run.trace
    if tr is None or tr.window is None or not tr.device_events:
        return None
    if run.cell.spec.get("trace_scope", "iteration") != "iteration":
        return None
    s, e = tr.window
    busy = counting.union_seconds((a, b) for _, a, b in tr.device_events)
    return 100.0 * (1.0 - busy / (e - s))
