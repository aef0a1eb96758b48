#!/usr/bin/env bash
# SSB-stratified semi-sup k-means eval (reference k_means_stratified.py CLI).
# The port's counterpart of scripts/k_means_stratified.sh; DEVICE=cpu runs
# it off the card.
set -e
python -m scd_tpu_torch.cluster.runners \
    --features "${FEATURES:?set FEATURES}" \
    --n_train_classes "${N_TRAIN_CLASSES:?set N_TRAIN_CLASSES}" \
    --dataset_name "${DATASET:?set DATASET (cub|scars|aircraft)}" \
    --ssb_dir "${SSB_DIR:?set SSB_DIR}" \
    ${DEVICE:+--device "$DEVICE"} \
    "$@"
