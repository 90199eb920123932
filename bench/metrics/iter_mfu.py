"""iter_mfu: the whole outer iteration's share of the card's roofline:
the least time of the bytes and FLOPs its exact steps, approximate passes
and evaluation need (bench/counting.py, counted from the iteration's
row) over its measured wall time, summed over the window's untraced
iterations, in %.  Host clock over counted work."""


def read(run):
    its = run.untraced()
    wall = sum(it.wall for it in its)
    if not its or wall <= 0:
        return None
    return 100.0 * sum(run.iteration_least_time(it.row) for it in its) / wall
