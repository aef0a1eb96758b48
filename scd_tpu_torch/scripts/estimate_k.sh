#!/usr/bin/env bash
# Estimate the number of clusters (reference gcd/bash_scripts/estimate_k.sh).
# The port's counterpart of scripts/estimate_k.sh; DEVICE=cpu runs it off
# the card.
set -e
python -m scd_tpu_torch.cluster.estimate_k \
    ${FEATURES:+--features "$FEATURES"} \
    --min_k "${MIN_K:-10}" \
    --max_k "${MAX_K:-1000}" \
    --search_mode "${SEARCH_MODE:-brent}" \
    ${DEVICE:+--device "$DEVICE"} \
    "$@"
