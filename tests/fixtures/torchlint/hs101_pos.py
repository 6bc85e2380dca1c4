"""HS101 positive: blocking device->host syncs inside a tele.timed step
loop, including one reached through same-module call propagation and one
in a # torchlint: hot marked function."""
import numpy as np
import torch


def fetch_norm(metrics):
    # Reached from the hot loop below by bare-name call: hot by
    # propagation.
    return metrics["grad_norm"].item()


# torchlint: hot
def consume_outputs(outputs):
    return np.asarray(outputs)


def train(tele, loader, train_step, model):
    losses = []
    for batch in tele.timed(iter(loader)):
        metrics = train_step(model, batch)
        tele.step_done(1, metrics)
        losses.append(float(metrics["loss"]))
        grad_norm = fetch_norm(metrics)
        torch.cuda.synchronize()
    return losses, grad_norm
