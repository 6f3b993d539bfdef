"""The median time from a request's due time to the start of its prefill
(``portbench``'s span around the engine's prefill call), in ms."""
import math

from portbench.yardstick import percentile


def read(run):
    w = [1e3 * (r["admit"] - r["due"]) for r in run.requests if not math.isnan(r["admit"])]
    return percentile(w, 50) if w else None
