"""One run of one benchmark cell on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints progress on standard error, each
number the output check compared beside its limit as the last lines there,
and the result as one JSON object, the last line of standard output.  Exits
non-zero with no result when the card is missing, when the program or the
manifest is missing, or when JAX or the JAX package was loaded.
"""
import time

T_PROC0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# every cache the program or its libraries keep stays inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T_PROC0))
