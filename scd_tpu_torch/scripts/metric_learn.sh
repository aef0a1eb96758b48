#!/usr/bin/env bash
# GCD contrastive finetuning (reference gcd/bash_scripts/metric_learn.sh /
# metric_learn_v2.sh): SGD, cosine LR, grad_from_block 11, sup_con_weight 0.35.
# The port's counterpart of scripts/metric_learn.sh; DEVICE=cpu runs it off
# the card.
set -e
python -m scd_tpu_torch.train.metric_learn \
    --dataset_name "${DATASET:-synthetic}" \
    --root_dir "${ROOT_DIR:-/data}" \
    --epochs "${EPOCHS:-200}" \
    --lr 0.1 \
    --grad_from_block 11 \
    --sup_con_weight 0.35 \
    ${DEVICE:+--device "$DEVICE"} \
    "$@"
