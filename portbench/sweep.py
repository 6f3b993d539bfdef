"""Find the highest arrival rate an open-loop LM cell sustains, once, on the card.

    python3 portbench/sweep.py --workload <name> --seed <n> --seconds 30 \
        --rates 4,6,8,10 [--write]

One set-up, then for each rate a window of ``--seconds`` at that rate
(the engine drained between rates).  A rate is sustained when the queue at
the window's close holds no more than one second of its arrivals: above
the knee the queue grows through the whole window.  Prints one JSON row a
rate.  ``--write`` puts 0.8 × the highest rate sustained at and below which
every rate was sustained into the cell's traffic file (``gap.rate``) with
the sweep's rows.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

LOAD = 0.8  # the cell runs at this share of the highest sustained rate


def sweep(cell, cfg, mix, limits, seed, seconds, rates, device) -> list:
    import torch

    from portbench import harness
    from portbench.drivers import lm_serve
    from portbench.yardstick import percentile

    base = harness.Run(cell, cfg, mix, limits, seed, seconds, False, torch.device(device))
    lm_serve.setup(base)
    rows = []
    for rate in rates:
        m = dict(mix, gap={"dist": "exponential", "rate": rate})
        run = harness.Run(cell, cfg, m, limits, seed, seconds, False, torch.device(device))
        run.state = base.state
        lm_serve.window(run)
        run.state["engine"].run_until_drained(max_ticks=100000)
        ttft = [math.inf if r["failed"] else 1e3 * (r["first"] - r["due"]) for r in run.requests]
        q = run.counters["queue_at_close"]
        rows.append({"rate": rate, "arrivals": len(run.requests), "queue_at_close": q,
                     "sustained": q <= max(1.0, rate),
                     "ttft_p50_ms": percentile(ttft, 50), "ttft_p95_ms": percentile(ttft, 95),
                     "late_max_ms": run.counters.get("late_max_ms", 0.0),
                     "tok_per_s": run.counters["tokens"] / run.window_s})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True, help="comma-separated requests per second")
    ap.add_argument("--write", action="store_true")
    a = ap.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell, cfg, mix, limits = harness.load_cell(harness.manifest(), a.workload)
    rates = sorted(float(x) for x in a.rates.split(","))
    rows = sweep(cell, cfg, mix, limits, a.seed, a.seconds, rates, "cuda:0")
    knee = 0.0
    for r in rows:
        if not r["sustained"]:
            break
        knee = r["rate"]
    print(json.dumps({"highest_sustained": knee, "cell_rate": LOAD * knee,
                      "card": harness.nvidia_smi()}), flush=True)
    if a.write and knee:
        path = harness.HERE / "traffic" / f"{cell['traffic']}.json"
        doc = json.loads(path.read_text())
        doc["gap"] = {"dist": "exponential", "rate": round(LOAD * knee, 3)}
        doc["sweep"] = {"seed": a.seed, "seconds": a.seconds, "highest_sustained": knee,
                        "rows": rows}
        path.write_text(json.dumps(doc, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
