#!/usr/bin/env bash
# Supervised classifier + combine-with-kmeans (reference
# gcd/bash_scripts/train_supervised_classifer.sh + combine_classifier_and_kmeans.py).
# The port's counterpart of scripts/train_supervised_classifier.sh;
# DEVICE=cpu runs it off the card.
set -e
python -m scd_tpu_torch.train.run_baseline --method supervised \
    --features "${FEATURES:?set FEATURES}" \
    --n_labeled "${N_LABELED:?set N_LABELED}" \
    ${DEVICE:+--device "$DEVICE"} \
    "$@"
