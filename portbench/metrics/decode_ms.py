"""The mean time of the engine's decode calls in the window, in ms:
``portbench``'s spans around them (the traced run waits for the device at
each span's end)."""


def read(run):
    s = run.spans.within("decode", run.t0, run.t1)
    return 1e3 * sum(t1 - t0 for _, t0, t1, _ in s) / len(s) if s else None
