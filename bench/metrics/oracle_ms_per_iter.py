"""oracle_ms_per_iter: device milliseconds of the Viterbi kernels
(kernels/viterbi.py, name holds "viterbi") in the traced outer iteration:
the exact pass's B = 1 decodes and the evaluation's B = n one.  Device
trace; nothing where the trace holds no such kernel or lost a record
of the port's named kernels (harness.dropped)."""


def read(run):
    if not run.trace_complete:
        return None
    tr = run.trace
    if tr is None or run.cell.spec.get("trace_scope",
                                       "iteration") != "iteration":
        return None
    hits = [(e - s) for name, s, e in tr.kernels() if "viterbi" in name]
    if not hits:
        return None
    return sum(hits) * 1e-6
