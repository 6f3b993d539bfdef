"""The nearest-rank 85th percentile of time to first token over every
request due in the window, timed from its due time; a request that failed
or never had a first token is a miss (infinite)."""
import math

from portbench.yardstick import percentile


def read(run):
    t = [math.inf if r["failed"] else 1e3 * (r["first"] - r["due"]) for r in run.requests]
    v = percentile(t, 85)
    return None if math.isnan(v) else min(v, 1e12)
