"""The engine's own host work in a tick (scheduling, token staging,
bookkeeping): the mean host ms of the program's ``engine.step`` spans less
their ``engine.prefill``, ``engine.decode`` and ``engine.readback``
children."""
from portbench.program_spans import named, records

CALLS = ("engine.prefill", "engine.decode", "engine.readback")


def read(run):
    recs = records(run)
    steps = named(recs, "engine.step")
    if not steps:
        return None
    inner = {}
    for r in recs:
        if r.name in CALLS:
            inner[r.parent] = inner.get(r.parent, 0.0) + r.host_ms
    return sum(s.host_ms - inner.get(s.id, 0.0) for s in steps) / len(steps)
