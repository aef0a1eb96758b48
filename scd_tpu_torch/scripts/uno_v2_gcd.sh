#!/usr/bin/env bash
# UNO v2 baseline (reference gcd/bash_scripts/uno_v2_gcd.sh).  The port's
# counterpart of scripts/uno_v2_gcd.sh; DEVICE=cpu runs it off the card.
set -e
python -m scd_tpu_torch.train.run_baseline --method uno \
    --features "${FEATURES:?set FEATURES}" \
    --n_labeled "${N_LABELED:?set N_LABELED}" \
    ${DEVICE:+--device "$DEVICE"} \
    "$@"
# End-to-end (trunk finetuning) variant, reference train loop parity:
#   python -m scd_tpu_torch.train.run_baseline_e2e --method uno --dataset_name <ds> ...
