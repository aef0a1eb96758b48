#!/usr/bin/env bash
# (Semi-sup) k-means over extracted features (reference gcd/bash_scripts/k_means.sh).
# The port's counterpart of scripts/k_means.sh; DEVICE=cpu runs it off the
# card.
set -e
python -m scd_tpu_torch.cluster.runners \
    --features "${FEATURES:?set FEATURES=path/to/features_packed.npz}" \
    --n_train_classes "${N_TRAIN_CLASSES:?set N_TRAIN_CLASSES}" \
    --semi_sup \
    ${DEVICE:+--device "$DEVICE"} \
    "$@"
