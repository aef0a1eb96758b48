#!/usr/bin/env bash
# AutoNovel baseline (reference gcd/bash_scripts/autonovel_gcd.sh).  The
# port's counterpart of scripts/autonovel_gcd.sh; DEVICE=cpu runs it off
# the card.
set -e
python -m scd_tpu_torch.train.run_baseline --method autonovel \
    --features "${FEATURES:?set FEATURES}" \
    --n_labeled "${N_LABELED:?set N_LABELED}" \
    ${DEVICE:+--device "$DEVICE"} \
    "$@"
# End-to-end (trunk finetuning) variant, reference train loop parity:
#   python -m scd_tpu_torch.train.run_baseline_e2e --method autonovel --dataset_name <ds> ...
