"""host_syncs_per_iter: device-to-host syncs of the control loop per outer
iteration (TraceRow.host_syncs, the engine's SyncLedger), over the
window's iterations.  Program counter."""


def read(run):
    if not run.iterations:
        return None
    return (sum(it.row.host_syncs for it in run.iterations)
            / len(run.iterations))
