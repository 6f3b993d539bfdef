"""The batcher's host staging of a chunk (``np.zeros``, the per-image copy,
``mark_admit``): the mean host ms of the program's ``batcher.stage`` spans."""
from portbench.program_spans import named, records


def read(run):
    s = named(records(run), "batcher.stage")
    return sum(r.host_ms for r in s) / len(s) if s else None
