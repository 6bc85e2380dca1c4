"""TL401 positive: tensors still attached to autograd stored on self in a
forward, and on a global in an instrumented step function — each pins the
step's graph and activations past the step."""
from torch import nn

_last_loss = None


class Head(nn.Module):
    def __init__(self, hidden):
        super().__init__()
        self.dense = nn.Linear(hidden, hidden)

    def forward(self, x):
        y = self.dense(x)
        self.cache = y
        return y


def train_step(model, batch):
    global _last_loss
    loss = model(batch).sum()
    loss.backward()
    _last_loss = loss * 0.5
    return loss


def build(tele):
    return tele.instrument(train_step, "train_step")
