"""The KV-cache writes of a decode tick: the device ms of the program's
``attn.kv_write`` spans under ``engine.decode`` (a prefill's are left out),
over the decode ticks."""
from portbench.program_spans import device_ms_per


def read(run):
    return device_ms_per(run, "attn.kv_write", "engine.decode", under="engine.decode")
