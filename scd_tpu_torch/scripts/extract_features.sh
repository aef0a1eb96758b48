#!/usr/bin/env bash
# Offline feature extraction (reference gcd/bash_scripts/extract_features.sh).
# The port's counterpart of scripts/extract_features.sh; DEVICE=cpu runs it
# off the card.
set -e
python -m scd_tpu_torch.pipelines.extract \
    --dataset_name "${DATASET:-synthetic}" \
    --feat_model "${FEAT_MODEL:-synthetic}" \
    --root_dir "${ROOT_DIR:-/data}" \
    --save_dir "${SAVE_DIR:-features}" \
    ${DEVICE:+--device "$DEVICE"} \
    "$@"
