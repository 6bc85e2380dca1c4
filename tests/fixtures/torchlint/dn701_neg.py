"""DN701 negative: reads after work.wait(), a tensor handed on with its
work handle (the receiver waits), a rebind before any read, reads after a
stream or event sync, and host->device copies (the card reads the host
buffer, ordered on the copying stream)."""
import torch
import torch.distributed as dist


def reduce_wait(flat, group):
    work = dist.all_reduce(flat, group=group, async_op=True)
    work.wait()
    return flat.norm()


def launch(flat, pending):
    work = dist.all_reduce(flat, async_op=True)
    pending.append((work, flat))


def rebind(flat, fresh):
    work = dist.all_reduce(flat, async_op=True)
    flat = fresh
    return work, flat.norm()


def fetch_synced(loss):
    host = loss.to("cpu", non_blocking=True)
    torch.cuda.synchronize()
    return host.tolist()


def fetch_event(loss):
    pinned = torch.empty(loss.shape, pin_memory=True)
    pinned.copy_(loss, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    event.synchronize()
    return pinned.tolist()


def stage(batch, device):
    pinned = torch.from_numpy(batch).pin_memory()
    return pinned.to(device, non_blocking=True)
