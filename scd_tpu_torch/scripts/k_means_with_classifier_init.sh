#!/usr/bin/env bash
# K-means warm-started from supervised-classifier predictions (reference
# gcd/bash_scripts/k_means_with_classifier_init.sh — its python target is
# missing from the reference repo; here: train the classifier, combine, and
# the library's fit_kmeans_from_labels warm start is available via the API).
# The port's counterpart of scripts/k_means_with_classifier_init.sh;
# DEVICE=cpu runs it off the card.
set -e
python -m scd_tpu_torch.train.run_baseline --method supervised \
    --features "${FEATURES:?set FEATURES}" \
    --n_labeled "${N_LABELED:?set N_LABELED}" \
    ${DEVICE:+--device "$DEVICE"} \
    "$@"
