"""The engine's mean slot occupancy over the window's ticks, in %, from the
program's ``Metrics.tick_occupancy`` sums."""


def read(run):
    n = run.counters["occ_ticks"]
    return 100.0 * run.counters["occ_sum"] / n if n else None
