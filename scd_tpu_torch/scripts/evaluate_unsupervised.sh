#!/usr/bin/env bash
# Unsupervised SCD evaluation (reference scripts/evaluate_unsupervised.sh).
# Synthetic defaults run with no assets; point --root_dir / weight flags at
# real data for imagenet_100 / sdogs / cub.  The port's counterpart of
# scripts/evaluate_unsupervised.sh; DEVICE=cpu runs it off the card.
set -e
python -m scd_tpu_torch.pipelines.unsup \
    --batch_size 32 \
    --root_dir "${ROOT_DIR:-/data}" \
    --dataset_name "${DATASET:-synthetic}" \
    --feat_model "${FEAT_MODEL:-synthetic}" \
    --cluster "${CLUSTER:-KM}" \
    --n_cluster "${N_CLUSTER:-10}" \
    --topk "${TOPK:-3}" \
    --num_common_vote "${NUM_COMMON_VOTE:-10}" \
    --num_common_linear "${NUM_COMMON_LINEAR:-2}" \
    ${DEVICE:+--device "$DEVICE"} \
    "$@"
