#!/usr/bin/env bash
# CI for the PyTorch port on a CPU host (no card, no nvcc): the port's
# parity tests against the JAX package (tests/test_torch_*.py; the tests
# marked `gpu` skip here), the four examples on the kernels' plain
# versions, and a dry run of three production cells (rank 0's step on meta
# tensors under a fake process group of 256 ranks).
#
#   bash scripts/ci_torch.sh
#
# On the card, `python3 chip_smoke.py` builds and holds the kernels and runs
# the examples there (phase 18); `python -m pytest -q -m gpu
# tests/test_torch_gpu.py tests/test_torch_decode_attention.py` runs the
# kernel-vs-plain tests.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
export JAX_PLATFORMS=cpu

python -m pytest -q tests/test_torch_*.py

for ex in quickstart paper_conv train_lm; do
  python examples/torch/$ex.py --device cpu --smoke
done
python examples/torch/serve_pasm.py --device cpu

out=$(mktemp -d)
trap 'rm -rf "$out"' EXIT
python -m repro_torch.launch.dryrun --arch qwen3-32b --shape decode_32k --out "$out"
python -m repro_torch.launch.dryrun --arch mamba2-130m --shape train_4k --out "$out"
python -m repro_torch.launch.dryrun --arch stablelm-3b --shape train_4k --out "$out"
test "$(ls "$out"/*.json | wc -l)" -eq 3
echo "ci_torch: OK"
