"""Milliseconds of prefill per thousand real prompt tokens: ``portbench``'s
spans around the engine's prefill calls in the window (the traced run waits
for the device at each span's end), over the prompts' real lengths."""


def read(run):
    s = run.spans.within("prefill", run.t0, run.t1)
    n = sum(a["n"] for _, _, _, a in s)
    return 1e6 * sum(t1 - t0 for _, t0, t1, _ in s) / n if n else None
