#!/bin/bash
# NER finetune on CoNLL-style datasets on the PyTorch / CUDA port, the JAX
# script's recipe and label sets (scripts/run_ner.sh). The runner trains
# on one GPU. Run from the repository root.
set -euo pipefail
DATASET=${DATASET:-CoNLL-2003}
case "$DATASET" in
  CoNLL-2003) LABELS="O B-PER I-PER B-ORG I-ORG B-MISC I-MISC B-LOC I-LOC" ;;
  JNLPBA) LABELS="O I-DNA B-DNA I-RNA B-RNA I-cell_line B-cell_line I-protein B-protein I-cell_type B-cell_type" ;;
  NCBI) LABELS="O B-Disease I-Disease" ;;
  BC5CDR) LABELS="O B-Entity I-Entity" ;;
  *) echo "Unknown dataset $DATASET"; exit 1 ;;
esac
DATA_DIR=${DATA_DIR:?set DATA_DIR to the CoNLL data directory}
python -m bert_pytorch_tpu_torch.run_ner \
    --train_file "$DATA_DIR/train.txt" \
    --val_file "$DATA_DIR/dev.txt" \
    --test_file "$DATA_DIR/test.txt" \
    --labels $LABELS \
    --model_config_file configs/bert_large_uncased_config.json \
    --model_checkpoint "${INIT_CKPT:?set INIT_CKPT}" \
    --lr 5e-6 --epochs 5 --batch_size 32 --max_seq_len 128 --uppercase
