"""The readings a cell's output limits are set from, on the card.

    python3 portbench/limits.py --workload <name> --seeds 11,12,13 --seconds 10 \
        [--control N]

For each seed, in one process: the cell's set-up with that seed, a window
of ``--seconds`` at the cell's own load, then the program's numbers as a
run's check reads them, and for the first ``N`` seeds the control's: the
reference put in the program's place one precision below the
configuration's (TF32 for f32, float8 e4m3 for bf16), read the same way,
and for a training cell the reference on half of each batch's rows.
Prints one JSON line a seed.  The benchmark's own runs never run this.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# the precision one below each configuration's, for its control
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def readings(cell, cfg, mix, limits, seed, seconds, device, control: bool) -> dict:
    import torch

    from portbench import harness
    from portbench.reference.precision import ROUNDINGS

    run = harness.Run(cell, cfg, mix, limits, seed, seconds, False, torch.device(device))
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    driver.setup(run)
    driver.window(run)
    driver.free(run)
    if run.cuda:
        torch.cuda.empty_cache()
    out = {"seed": seed, "attempted": run.attempted, "checks": driver.check(run)}
    if control:
        out["control"] = driver.control(run, ROUNDINGS[CONTROL[cfg["dtype"]]])
        if hasattr(driver, "half_batch"):  # a training cell's planted fault
            out["half_batch"] = driver.half_batch(run)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    a = ap.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell, cfg, mix, limits = harness.load_cell(harness.manifest(), a.workload)
    for i, s in enumerate(int(x) for x in a.seeds.split(",")):
        t = time.perf_counter()
        r = readings(cell, cfg, mix, limits, s, a.seconds, "cuda:0", i < a.control)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
