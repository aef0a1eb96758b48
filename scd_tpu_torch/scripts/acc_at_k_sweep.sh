#!/usr/bin/env bash
# ACC-vs-K sweep (reference gcd/bash_scripts/acc_at_k_sweep.sh): run plain
# k-means at each K in the list and report ACC.  The port's counterpart of
# scripts/acc_at_k_sweep.sh; DEVICE=cpu runs it off the card.
set -e
FEATURES="${FEATURES:?set FEATURES}"
N_TRAIN_CLASSES="${N_TRAIN_CLASSES:?set N_TRAIN_CLASSES}"
for K in ${K_LIST:-10 20 50 100 200}; do
    echo "== K=$K =="
    python -m scd_tpu_torch.cluster.runners \
        --features "$FEATURES" --n_train_classes "$N_TRAIN_CLASSES" \
        --K "$K" ${DEVICE:+--device "$DEVICE"} "$@"
done
