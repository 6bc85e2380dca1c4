"""HS101 negative: every fetch sits at a declared sync-cadence site
(modulus gate, last_step_synced guard, once-per-run equality gate) or is
host-safe (shape metadata, len, args scalars), and the copies to the card
and into pinned memory do not block."""
import torch


def evaluate(model, batches):
    # Not reachable from a timed loop and not marked hot: eval loops
    # sync per batch by design.
    return [float(model(b).mean()) for b in batches]


def train(tele, loader, train_step, model, args, device):
    step = 0
    for batch in tele.timed(iter(loader)):
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        metrics = train_step(model, batch)
        step += 1
        seq_len = int(batch["input_ids"].shape[-1])
        rows = int(batch["input_ids"].size(0))
        n = len(batch)
        lr = float(args.lr)
        if step == 1:
            torch.cuda.synchronize()
        if step % args.log_steps == 0:
            loss = float(metrics["loss"])
        if tele.last_step_synced:
            grad_norm = metrics["grad_norm"].item()
        staged = metrics["loss"].to("cpu", non_blocking=True)
        tele.step_done(step, metrics)
    return seq_len, rows, n, lr, loss, grad_norm, staged
