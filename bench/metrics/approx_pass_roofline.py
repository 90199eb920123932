"""approx_pass_roofline: the least time of the bytes and FLOPs the traced
iteration's approximate passes need (bench/counting.py::approx_pass_work
on the valid planes the row reports, times the passes that ran) over the
device time of the approx_pass kernels, in %.  Device trace; nothing
where the trace holds no approx_pass kernel or lost a record of the
port's named kernels (harness.dropped)."""

from bench import counting


def read(run):
    if not run.trace_complete:
        return None
    tr, row = run.trace, run.traced_row
    if tr is None or row is None or row.approx_passes <= 0:
        return None
    if run.cell.spec.get("trace_scope", "iteration") != "iteration":
        return None
    dev = sum(e - s for name, s, e in tr.kernels()
              if "approx_pass" in name) * 1e-9
    if dev <= 0:
        return None
    planes = int(round(row.ws_mean * run.n))
    nbytes, flops = counting.approx_pass_work(run.n, run.d, run.cap, planes)
    least = row.approx_passes * counting.least_time(nbytes, flops)
    return 100.0 * least / dev
