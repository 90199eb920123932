"""iter_s: wall seconds per outer iteration over the window: the summed
wall time of its iterations (each ending at the loop's own sync, its
evaluation sweep included) over their count.  Host clock."""


def read(run):
    its = run.untraced()
    if not its:
        return None
    return sum(it.wall for it in its) / len(its)
