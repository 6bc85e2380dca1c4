#!/bin/bash
# SWAG multiple-choice finetune + eval on the PyTorch / CUDA port, the JAX
# script's recipe (scripts/run_swag.sh: lr 2e-5, 3 epochs, warmup 0.1).
# The runner trains on one GPU. Run from the repository root.
set -euo pipefail
SWAG_DIR=${SWAG_DIR:-data/download/swag}
python -m bert_pytorch_tpu_torch.run_swag \
    --train_file "$SWAG_DIR/train.csv" \
    --val_file "$SWAG_DIR/val.csv" \
    --model_config_file configs/bert_large_uncased_config.json \
    --init_checkpoint "${INIT_CKPT:?set INIT_CKPT to a pretraining checkpoint}" \
    --output_dir results/swag \
    --lr 2e-5 --epochs 3 --warmup_proportion 0.1 \
    --batch_size 16 --max_seq_len 128
