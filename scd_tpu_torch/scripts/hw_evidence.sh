#!/usr/bin/env bash
# Capture a round's hardware evidence on the card: the gpu-marked kernel
# suite's outcome goes to GPU_SUITE_r<N>.txt and a chip_smoke.py run to
# CHIP_SMOKE_r<N>.txt (both listed in .gitignore).  The counterpart of
# scripts/hw_evidence.sh.  Usage: scd_tpu_torch/scripts/hw_evidence.sh
# <round-number>
set -uo pipefail
R="${1:?usage: scd_tpu_torch/scripts/hw_evidence.sh <round-number>}"
cd "$(dirname "$0")/../.."

{
  echo "== gpu suite $(date -u +%FT%TZ) =="
  # every hand-written kernel against its plain version on the card
  # (tests/conftest.py imports JAX, which the card's machine need not have)
  timeout 3600 python -m pytest -m gpu --noconftest tests/test_torch_gpu.py \
      tests/test_torch_graft_entry.py -q -rA 2>&1
  echo "exit=$?"
} | tee "GPU_SUITE_r${R}.txt"

{
  echo "== chip_smoke $(date -u +%FT%TZ) =="
  timeout 3600 python3 chip_smoke.py 2>&1
  echo "exit=$?"
} | tee "CHIP_SMOKE_r${R}.txt"

# The JAX script's third step, a bench run, waits for the port's benchmark
# harness, which does not exist yet; nothing stands in for it here.
