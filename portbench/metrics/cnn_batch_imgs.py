"""Images per forward: images answered over the change in the program's
``CnnBatcher.n_batches`` over the window."""


def read(run):
    b = run.counters["batches"]
    return run.counters["images"] / b if b else None
