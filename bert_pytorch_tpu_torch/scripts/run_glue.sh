#!/bin/bash
# GLUE finetune + eval on the PyTorch / CUDA port, the JAX script's recipe
# (scripts/run_glue.sh: lr 2e-5, 3 epochs, warmup 0.1, seq 128). The
# runner trains on one GPU. Run from the repository root:
#   TASK=mrpc GLUE_DIR=data/download/glue ./bert_pytorch_tpu_torch/scripts/run_glue.sh
set -euo pipefail
TASK=${TASK:-mrpc}
GLUE_DIR=${GLUE_DIR:-data/download/glue}
declare -A DIRS=(
    [cola]=CoLA [sst-2]=SST-2 [mrpc]=MRPC [sts-b]=STS-B [qqp]=QQP
    [mnli]=MNLI [mnli-mm]=MNLI [qnli]=QNLI [rte]=RTE [wnli]=WNLI
)
python -m bert_pytorch_tpu_torch.run_glue \
    --task "$TASK" \
    --data_dir "$GLUE_DIR/${DIRS[$TASK]}" \
    --model_config_file configs/bert_large_uncased_config.json \
    --init_checkpoint "${INIT_CKPT:?set INIT_CKPT to a pretraining checkpoint}" \
    --output_dir "results/glue_$TASK" \
    --lr 2e-5 --epochs 3 --warmup_proportion 0.1 \
    --batch_size 32 --max_seq_len 128
