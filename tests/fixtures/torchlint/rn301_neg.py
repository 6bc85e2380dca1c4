"""RN301 negative: a seed derived per site (_sub_seed reads its layer seed
without consuming it), seeds drawn anew every step, one consumption per
branch, and a generator seeded once outside the loop."""
import torch

from bert_pytorch_tpu_torch.models.bert import (_sub_seed,
                                                draw_dropout_seeds,
                                                fold_dropout_seeds)
from bert_pytorch_tpu_torch.ops.dropout import dropout


def layer(x, y, layer_seed, rate):
    a = dropout(x, rate, _sub_seed(layer_seed, 0))
    b = dropout(y, rate, _sub_seed(layer_seed, 1))
    return a, b


def train(model, batches, generator, num_layers, rank):
    losses = []
    for batch in batches:
        seeds = draw_dropout_seeds(generator, num_layers)
        seeds = fold_dropout_seeds(seeds, rank)
        losses.append(model(batch, dropout_seeds=seeds))
    return losses


def branches(x, layer_seed, rate, flag):
    seed = _sub_seed(layer_seed, 2)
    if flag:
        return dropout(x, rate, seed)
    else:
        return dropout(x * 2, rate, seed)


def sample(shape, steps):
    gen = torch.Generator().manual_seed(0)
    return [torch.rand(shape, generator=gen) for _ in range(steps)]
