"""device_ops_per_block: kernel records of the traced outer iteration
(exact pass, approximate passes, evaluation) per exact block step of it
(the n_exact delta).  Device trace; a run whose trace does not hold the
whole iteration, or lost a record of the port's named kernels
(harness.dropped), reads nothing."""


def read(run):
    if not run.trace_complete:
        return None
    tr, row, prev = run.trace, run.traced_row, run.traced_prev_row
    if tr is None or row is None or prev is None:
        return None
    if run.cell.spec.get("trace_scope", "iteration") != "iteration":
        return None
    steps = row.n_exact - prev.n_exact
    if steps <= 0:
        return None
    return len(tr.kernels()) / steps
