"""RN301 positive: the same dropout seed consumed twice (the same Philox
mask on two tensors), and seeds drawn outside a loop consumed inside it
(the same dropout masks every step)."""
from bert_pytorch_tpu_torch.models.bert import _sub_seed, draw_dropout_seeds
from bert_pytorch_tpu_torch.ops.dropout import dropout


def layer(x, y, layer_seed, rate):
    seed = _sub_seed(layer_seed, 0)
    a = dropout(x, rate, seed)
    b = dropout(y, rate, seed)
    return a, b


def train(model, batches, generator, num_layers):
    seeds = draw_dropout_seeds(generator, num_layers)
    losses = []
    for batch in batches:
        losses.append(model(batch, dropout_seeds=seeds))
    return losses
