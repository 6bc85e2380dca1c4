"""DN701 positive: a tensor read while an async collective still owns it
(before work.wait()), and the destination of a non-blocking
device->host copy read before any sync."""
import torch.distributed as dist


def reduce_then_read(flat, group):
    work = dist.all_reduce(flat, group=group, async_op=True)
    norm = flat.norm()  # the collective may still be writing flat
    work.wait()
    return norm


def fetch_loss(loss):
    host = loss.to("cpu", non_blocking=True)
    return host.tolist()  # the copy may not have landed yet
