"""Decode attention over the KV cache in a tick: the device ms of the
program's ``attn.decode`` spans under ``engine.decode``, over the decode
ticks."""
from portbench.program_spans import device_ms_per


def read(run):
    return device_ms_per(run, "attn.decode", "engine.decode", under="engine.decode")
