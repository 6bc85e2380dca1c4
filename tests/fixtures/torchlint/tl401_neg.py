"""TL401 negative: state leaves a forward through its return value;
detached values, host scalars and constants may be stored; writes under
torch.no_grad() hold no graph; methods that are not forwards may cache."""
import torch
from torch import nn

_last_loss = None


class Head(nn.Module):
    def __init__(self, hidden):
        super().__init__()
        self.dense = nn.Linear(hidden, hidden)
        self.calls = 0

    def forward(self, x):
        y = self.dense(x)
        self.calls += 1
        self.last_norm = y.detach().norm()
        self.compiled = True
        with torch.no_grad():
            self.running = y.mean()
        return y

    def cache_result(self, x):
        self.cache = self.forward(x)
        return self.cache


def train_step(model, batch):
    global _last_loss
    loss = model(batch).sum()
    loss.backward()
    _last_loss = loss.item()
    return loss


def build(tele):
    return tele.instrument(train_step, "train_step")
