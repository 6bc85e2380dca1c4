#!/bin/bash
# SQuAD finetune + eval on the PyTorch / CUDA port, the JAX script's recipe
# (scripts/run_squad.sh: lr 3e-5, 2 epochs, seq 384, doc_stride 128).
# NPROC GPUs of one host train data-parallel (--mesh_data follows the
# world size); rank 0 predicts and evaluates. Run from the repository root.
set -euo pipefail
SQUAD_DIR=${SQUAD_DIR:-data/download/squad/v1.1}
torchrun --standalone --nproc_per_node "${NPROC:-1}" \
    -m bert_pytorch_tpu_torch.run_squad \
    --do_train --do_predict --do_eval --do_lower_case \
    --train_file "$SQUAD_DIR/train-v1.1.json" \
    --predict_file "$SQUAD_DIR/dev-v1.1.json" \
    --eval_script "$SQUAD_DIR/evaluate-v1.1.py" \
    --config_file configs/bert_large_uncased_config.json \
    --init_checkpoint "${INIT_CKPT:?set INIT_CKPT to a pretraining checkpoint}" \
    --output_dir results/squad \
    --learning_rate 3e-5 --num_train_epochs 2 \
    --max_seq_length 384 --doc_stride 128 --train_batch_size 32
