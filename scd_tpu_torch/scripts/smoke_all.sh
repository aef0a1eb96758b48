#!/usr/bin/env bash
# End-to-end smoke of every CLI of the port on the synthetic dataset (no
# assets): the counterpart of scripts/smoke_all.sh.  DEVICE=cpu (the
# default, as the JAX smoke defaults SCD_PLATFORM=cpu) runs every CLI off
# the card; DEVICE=cuda runs them on it and then the card's kernel suite
# (the gpu-marked tests) in place of the TPU suite.  Run from the repo root.
set -ex
export DEVICE="${DEVICE:-cpu}"
TMP=$(mktemp -d)
trap "rm -rf $TMP" EXIT

python -m scd_tpu_torch.pipelines.unsup --dataset_name synthetic \
    --cluster SSKM --n_cluster 10 --te --cache_dir "$TMP/cache" \
    --device "$DEVICE"
python -m scd_tpu_torch.pipelines.ptsup --dataset_name synthetic \
    --cluster ConSSKM --n_cluster 10 --cluster_size_min 5 \
    --cluster_size_max 50 --cache_dir "$TMP/cache" --device "$DEVICE"
python -m scd_tpu_torch.pipelines.extract --dataset_name synthetic \
    --feat_model synthetic --save_dir "$TMP/feats" --device "$DEVICE"
python -m scd_tpu_torch.cluster.runners \
    --features "$TMP/feats/train/features_packed.npz" \
    --n_train_classes 5 --semi_sup --K 10 --n_init 3 --device "$DEVICE"
python -m scd_tpu_torch.cluster.estimate_k --min_k 10 --max_k 1000 \
    --device "$DEVICE"
python -m scd_tpu_torch.train.run_baseline --method uno \
    --features "$TMP/feats/train/features_packed.npz" --n_labeled 5 \
    --epochs 2 --batch_size 64 --device "$DEVICE"
python -m scd_tpu_torch.train.run_baseline --method supervised \
    --features "$TMP/feats/train/features_packed.npz" --n_labeled 5 \
    --epochs 3 --device "$DEVICE"
python -m scd_tpu_torch.train.metric_learn --dataset_name synthetic \
    --epochs 1 --vit micro --image_size 32 --batch_size 8 \
    --steps_per_epoch 2 --proj_dim 32 --grad_from_block 0 \
    --max_kmeans_iter 10 --exp_root "$TMP/runs" --device "$DEVICE"
python -m scd_tpu_torch.train.run_baseline_e2e --method uno \
    --dataset_name synthetic --vit micro --image_size 32 --epochs 1 \
    --batch_size 32 --num_heads 2 --device "$DEVICE"
python -m scd_tpu_torch.pipelines.infer --dataset_name synthetic --topk 3 \
    --device "$DEVICE"
if [ "$DEVICE" != "cpu" ] && [ "${SMOKE_GPU_SUITE:-1}" != "0" ]; then
    # the hand-written kernels against their plain versions on the card
    # (tests/conftest.py imports JAX, which the card's machine need not have)
    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py -q
fi
echo "ALL CLIS OK"
