import os
import sys
from pathlib import Path

# tests run on ONE device (the dry-run alone forces 512 placeholders)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

SRC = Path(__file__).resolve().parent.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))


def pytest_configure(config):
    # tests that need an NVIDIA card; they decide inside a fixture whether
    # one is present and skip otherwise (run them with `-m gpu` on the card)
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one)")
