"""Time ``chip_smoke.py``'s phases 9, 10 and 11 at several depths, in one
process on one card: what the smoke's cut of their depth saves.

    python -m bert_pytorch_tpu_torch.tools.time_smoke_depth [--layers 6 24] \\
        [--out FILE]

For each depth in turn, ``chip_smoke.py``'s own drivers run with
``HANDOFF_LAYERS`` and ``KFAC_LAYERS`` set to it: ``drive_handoff``
(phase 9: the phase-1 to phase-2 hand-off, its saves, resume and
walk-back), ``drive_finetune`` (phase 10: GLUE, NER, SWAG and the served
GLUE checkpoint, from phase 9's) and ``drive_kfac`` (phase 11), with
every check they make. Prints one JSON line (and writes it to ``--out``):
the card's name and power limit and each depth's seconds per phase.
Needs a CUDA card and the repo's checkout (it imports ``chip_smoke.py``
from the root).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--layers", type=int, nargs="+", default=[6, 24])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke
    from bert_pytorch_tpu_torch.ops.kernels import attention, build
    from bert_pytorch_tpu_torch.ops.kernels.layernorm import layer_norm_fwd
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        write_trace_vocab)

    # As chip_smoke.main: fp32 GEMMs without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    kernels = {name: getattr(attention, name) for name in (
        "flash_attention_infer", "flash_attention_infer_int8",
        "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")}
    kernels["layer_norm_fwd"] = layer_norm_fwd
    card = chip_smoke.card_line()
    seconds = {}
    for layers in args.layers:
        chip_smoke.HANDOFF_LAYERS = chip_smoke.KFAC_LAYERS = layers
        with tempfile.TemporaryDirectory() as tmp:
            vocab = write_trace_vocab(os.path.join(tmp, "vocab.txt"))
            t0 = time.perf_counter()
            handoff = chip_smoke.drive_handoff(kernels, tmp, card)
            t1 = time.perf_counter()
            chip_smoke.drive_finetune(vocab, tmp, handoff["init_checkpoint"],
                                      handoff["config"], kernels, card)
            t2 = time.perf_counter()
            shutil.rmtree(os.path.join(tmp, "pretrain"))
            chip_smoke.drive_kfac(kernels, tmp, card)
            t3 = time.perf_counter()
        seconds[str(layers)] = {"handoff": t1 - t0, "finetune": t2 - t1,
                                "kfac": t3 - t2}
    line = json.dumps({"card": card, "seconds": seconds})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
