"""Measured tile geometry for the serving attention kernels on Hopper: the
port of the JAX package's ``ops/pallas/autotune.py``.

The tensor-core route of kernels #4 and #5 (csrc/flash_infer_wgmma.cuh) is
a template on its tile geometry ``(block_q, block_k, bh_block)``:

* ``block_q`` — query rows per thread block: 64 (one consumer warpgroup)
  or 128 (two warpgroups sharing each K/V stage of the TMA ring);
* ``block_k`` — keys per TMA stage, the N of the score ``wgmma``: 64 or
  128;
* ``bh_block`` — (batch*head) slices one thread block walks in turn, the
  grid being ``(B*H / bh_block, ceil(S / block_q))`` as the JAX grid is.

The default (64, 64, 1) is the geometry the kernels had before this
module, and the only one of the CUDA-core route. Which geometry is
fastest shifts with the sequence length and B*H, so serving measures it
once (:func:`measure`), keeps the winner in a small JSON file beside the
kernel build directory (:func:`save_winners` / :func:`load_winners`), and
reloads it on restart. The kernels consult :func:`lookup` on every call
(the port has no trace time: a winner loaded before a forward applies to
it).

The rules are the JAX module's: the registry is keyed by (kernel, seq,
bh), process-global and guarded by a lock; the file stamps the platform —
``"cuda:<device name>"`` on the card, so winners measured on another GPU
model are ignored, and ``"cpu"`` with ``interpret: true`` on the CPU,
where the plain version stands in for the kernel as interpret mode does
in JAX; a missing file or one from another platform loads nothing, a
malformed one raises ``ValueError``; :func:`name_digest` hashes the same
text as JAX's, so one winner has one digest in both packages, and a
winners file written here passes the JAX ``validate_winners``.

Module-level imports are the standard library's alone, as in the JAX
file, so a lint can load this module by path; ``torch`` and the kernels
are imported inside :func:`measure` and the platform stamp.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import threading
from typing import Dict, List, Optional, Tuple

WINNERS_VERSION = 1

# Serving kernel variants the registry keys on (ops/kernels/attention.py).
KERNELS = ("infer", "infer_int8")

# The geometry every shape can take: the kernels' own before measurement,
# valid for ragged sequence lengths too.
DEFAULT_GEOMETRY = (64, 64, 1)

# (block_q, block_k) tiles the tensor-core route instantiates, per head
# dim, for both kernels (csrc/flash_attention_infer.cu and
# flash_attention_infer_int8.cu `dispatch_geometry`). Head dim 64 (BERT-
# base and -large, RoBERTa) takes the whole grid; 32 and 128 only the
# default, to keep the cold build's nvcc time down (ROADMAP.md).
TILES = {32: ((64, 64),),
         64: ((64, 64), (64, 128), (128, 64), (128, 128)),
         128: ((64, 64),)}
# The largest bh_block a candidate takes: thread blocks walk at most this
# many (batch*head) slices.
MAX_BH_BLOCK = 8

# (kernel, seq, bh) -> {"block_q": int, "block_k": int, "bh_block": int,
#                       "measured_ms": float, "spread_ms": float}
_winners: Dict[Tuple[str, int, int], dict] = {}
_lock = threading.Lock()


def _key(kernel: str, seq: int, bh: int) -> str:
    """The file spelling of a registry key."""
    return f"{kernel}:s{int(seq)}:bh{int(bh)}"


def _parse_key(key: str) -> Optional[Tuple[str, int, int]]:
    parts = key.split(":")
    if len(parts) != 3 or not parts[1].startswith("s") \
            or not parts[2].startswith("bh"):
        return None
    try:
        return parts[0], int(parts[1][1:]), int(parts[2][2:])
    except ValueError:
        return None


def lookup(kernel: str, seq: int, bh: int) -> Optional[Tuple[int, int, int]]:
    """The recorded winner ``(block_q, block_k, bh_block)`` or None (the
    caller takes :data:`DEFAULT_GEOMETRY`)."""
    with _lock:
        entry = _winners.get((kernel, int(seq), int(bh)))
    if entry is None:
        return None
    return entry["block_q"], entry["block_k"], entry["bh_block"]


def record_winner(kernel: str, seq: int, bh: int, block_q: int,
                  block_k: int, bh_block: int,
                  measured_ms: Optional[float] = None,
                  spread_ms: Optional[float] = None) -> None:
    entry = {"block_q": int(block_q), "block_k": int(block_k),
             "bh_block": int(bh_block)}
    if measured_ms is not None:
        entry["measured_ms"] = round(float(measured_ms), 4)
    if spread_ms is not None:
        entry["spread_ms"] = round(float(spread_ms), 4)
    with _lock:
        _winners[(kernel, int(seq), int(bh))] = entry


def clear_winners() -> None:
    """Reset the process-global registry (tests)."""
    with _lock:
        _winners.clear()


def name_digest(kernel: str, seq: int, bh: int) -> str:
    """Short digest of the recorded winner geometry, or "" when none: the
    JAX package's text hashed the same way, so a winner has one digest in
    both packages. The serve engine appends it to its per-bucket forward
    names (``..._g<digest>``), so the names say which geometry ran."""
    geom = lookup(kernel, seq, bh)
    if geom is None:
        return ""
    text = f"{kernel}:{seq}:{bh}:{geom[0]}x{geom[1]}g{geom[2]}"
    return hashlib.sha1(text.encode()).hexdigest()[:6]


# -- persistence ------------------------------------------------------------


def platform_stamp(device=None) -> Tuple[str, bool]:
    """(platform, interpret) of the device the winners are measured and
    served on: ``("cuda:<device name>", False)`` for a CUDA device,
    ``("cpu", True)`` for the CPU. ``device`` (a ``torch.device`` or its
    name) defaults to the card where there is one."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}", False
    return "cpu", True


def save_winners(path: str, device=None) -> int:
    """Write the registry to ``path`` (atomic rename), stamped with the
    platform of ``device`` (:func:`platform_stamp`); returns the entry
    count."""
    platform, interpret = platform_stamp(device)
    with _lock:
        body = {_key(k, s, b): dict(entry)
                for (k, s, b), entry in sorted(_winners.items())}
    payload = {"version": WINNERS_VERSION, "platform": platform,
               "interpret": interpret, "winners": body}
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return len(body)


def load_winners(path: str, device=None) -> int:
    """Merge a winners file into the registry; returns how many entries
    loaded. A missing file loads 0 (a fresh start); a file stamped with
    another platform than ``device``'s loads 0 (its timings rank another
    card or the plain version); a malformed file raises ``ValueError``: a
    corrupt cache must fail loudly, not quietly detune."""
    if not os.path.exists(path):
        return 0
    with open(path, "r", encoding="utf-8") as f:
        payload = json.load(f)
    errors = validate_winners(payload)
    if errors:
        raise ValueError(
            f"autotune winners file {path} is malformed: {errors[0]}")
    platform, interpret = platform_stamp(device)
    if payload["platform"] != platform or \
            bool(payload.get("interpret")) != interpret:
        return 0
    loaded = 0
    with _lock:
        for key, entry in payload["winners"].items():
            parsed = _parse_key(key)
            if parsed is None:
                continue
            _winners[parsed] = {
                k: entry[k] for k in
                ("block_q", "block_k", "bh_block", "measured_ms", "spread_ms")
                if k in entry}
            loaded += 1
    return loaded


def _non_negative(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) and v >= 0


def validate_winners(payload) -> List[str]:
    """Format errors of a decoded winners file (an empty list is valid):
    the JAX package's rules, plus ``spread_ms`` as a non-negative number
    where present."""
    if not isinstance(payload, dict):
        return [f"winners file is {type(payload).__name__}, not an object"]
    errors = []
    if payload.get("version") != WINNERS_VERSION:
        errors.append(f"unknown version {payload.get('version')!r}")
    if not isinstance(payload.get("platform"), str) \
            or not payload.get("platform"):
        errors.append("platform must be a non-empty string")
    if not isinstance(payload.get("interpret"), bool):
        errors.append("interpret must be a boolean")
    winners = payload.get("winners")
    if not isinstance(winners, dict):
        return errors + ["winners must be an object"]
    for key, entry in winners.items():
        parsed = _parse_key(key)
        if parsed is None:
            errors.append(f"winner key {key!r} is not "
                          "<kernel>:s<seq>:bh<bh>")
            continue
        kernel, seq, bh = parsed
        if kernel not in KERNELS:
            errors.append(f"winner key {key!r}: unknown kernel "
                          f"{kernel!r} (known: {KERNELS})")
        if not isinstance(entry, dict):
            errors.append(f"winner {key!r} must be an object")
            continue
        for field in ("block_q", "block_k", "bh_block"):
            v = entry.get(field)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                errors.append(
                    f"winner {key!r}.{field} must be a positive integer, "
                    f"got {v!r}")
                continue
            if field.startswith("block") and seq % v != 0:
                errors.append(
                    f"winner {key!r}.{field}={v} does not divide "
                    f"seq {seq} — the kernel grid would be ragged")
            if field == "bh_block" and bh % v != 0:
                errors.append(
                    f"winner {key!r}.bh_block={v} does not divide "
                    f"bh {bh} — the kernel grid would be ragged")
        for field in ("measured_ms", "spread_ms"):
            v = entry.get(field)
            if v is not None and not _non_negative(v):
                errors.append(
                    f"winner {key!r}.{field} must be a non-negative "
                    f"number, got {v!r}")
    return errors


def validate_winners_file(path: str) -> List[str]:
    """File-level wrapper for a lint: parse, then validate."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            payload = json.load(f)
    except OSError as exc:
        return [f"unreadable: {exc}"]
    except ValueError as exc:
        return [f"not valid JSON: {exc}"]
    return validate_winners(payload)


# -- measurement ------------------------------------------------------------


def candidates(seq: int, bh: int, depth: int, kernel: str = "infer"
               ) -> List[Tuple[int, int, int]]:
    """The candidate ``(block_q, block_k, bh_block)`` grid of one shape on
    the tensor-core route: the (block_q, block_k) tiles the library
    instantiates for ``depth`` (:data:`TILES`; both kernels instantiate the
    same, so ``kernel`` only checks its name) whose blocks divide ``seq``,
    as the JAX grid keeps only dividing blocks, crossed with every power
    of two up to :data:`MAX_BH_BLOCK` that divides ``bh``. The default
    (64, 64, 1) is always in the grid, first, whatever ``seq``: it runs
    ragged lengths too. Head dims the route does not take have only the
    default."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    groups = []
    g = 1
    while g <= min(bh, MAX_BH_BLOCK):
        if bh % g == 0:
            groups.append(g)
        g *= 2
    grid = [DEFAULT_GEOMETRY]
    for block_q, block_k in TILES.get(int(depth), ()):
        if seq % block_q or seq % block_k:
            continue
        grid += [(block_q, block_k, g) for g in groups
                 if (block_q, block_k, g) != DEFAULT_GEOMETRY]
    return grid


def _inputs(kernel: str, seq: int, bh: int, depth: int, heads: int, dtype,
            device):
    """Seeded inputs of the serving forward's shape ([bh / heads, seq,
    heads, depth], a zero key bias as the padded forward passes) and the
    call of one candidate on them: the fp kernel's wrapper, or the int8
    kernel's on q and k quantized once (the quantization is the same for
    every candidate)."""
    import numpy as np
    import torch

    from bert_pytorch_tpu_torch.ops.kernels import attention

    rng = np.random.default_rng(0)
    shape = (bh // heads, seq, heads, depth)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(device=device, dtype=dtype) for _ in range(3))
    key_bias = torch.zeros(shape[0], seq, dtype=torch.float32, device=device)
    if kernel == "infer":
        bias = key_bias[:, None, None, :]
        return lambda g: attention.flash_attention_infer(
            q, k, v, bias=bias, geometry=g)
    q8, q_scale, k8, k_scale = attention.quantize_qk(q, k)
    return lambda g: attention.flash_attention_infer_int8_prequantized(
        q8, k8, q_scale, k_scale, v, key_bias, None, geometry=g)


def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card,
    read once with CUDA events."""
    import torch

    cycles = 10_000_000
    torch.cuda._sleep(cycles // 10)  # untimed
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / max(start.elapsed_time(end), 1e-3)


def time_rounds(calls: list, launches: int, rounds: int, cuda: bool,
                 clock) -> List[List[float]]:
    """Per call, ``rounds`` times per launch in ms, the calls taken in turns
    within each round. On the card: CUDA events around ``launches``
    back-to-back launches, queued behind a ``torch.cuda._sleep`` long
    enough for the host to issue them all, so the events time the card and
    not the host's issue rate (a short kernel is faster than one
    wrapper call). On the CPU: the host clock around ``launches`` calls."""
    times: List[List[float]] = [[] for _ in calls]
    if not cuda:
        for _ in range(rounds):
            for i, call in enumerate(calls):
                t0 = clock()
                for _ in range(launches):
                    call()
                times[i].append((clock() - t0) * 1e3 / launches)
        return times
    import torch

    per_ms = _sleep_cycles_per_ms()
    t0 = clock()
    for call in calls:
        for _ in range(launches):
            call()
    torch.cuda.synchronize()
    issue_ms = (clock() - t0) * 1e3 / len(calls)
    sleep = int(per_ms * (2.0 * issue_ms + 1.0))
    for _ in range(rounds):
        events = []
        for call in calls:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda._sleep(sleep)
            start.record()
            for _ in range(launches):
                call()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        for i, (start, end) in enumerate(events):
            times[i].append(start.elapsed_time(end) / launches)
    return times


def tiles(geometry, seq: int, bh: int) -> bool:
    """Whether ``geometry`` cuts ``seq`` and ``bh`` into whole blocks (the
    rule of a recorded winner, and of a forced or loaded geometry)."""
    block_q, block_k, g = geometry
    return not (seq % block_q or seq % block_k or bh % g)


def measure(kernel: str, seq: int, bh: int, depth: int, heads: int = 1,
            dtype=None, device=None, rounds: int = 5,
            launches: Optional[int] = None,
            max_launches: Optional[int] = None, clock=None) -> dict:
    """Time every candidate geometry (:func:`candidates`) of one serving
    kernel at one shape and record the winner; returns what was measured.

    Each candidate is called once untimed (its library's build and load,
    and a launch check), then timed in ``rounds`` rounds of ``launches``
    launches (:func:`time_rounds`: CUDA events on the card, the host
    clock on the CPU, where the plain version runs), the candidates in
    turns within a round so drift falls on all of them. The median round
    ranks a candidate; its spread is the max minus the min of its rounds.
    While the winner's gap to the runner-up is not larger than both their
    spreads, the launches double, up to ``max_launches``; ``resolved``
    says whether the gap was larger in the end. A candidate that fails
    (its call raises: a geometry the route does not take, a launch the
    card refuses) is kept out of the ranking and counted in ``failed``; if
    every one fails, ``RuntimeError`` is raised from the last failure.

    ``heads`` splits ``bh`` into [bh / heads, seq, heads, depth] inputs
    (the serving forward's layout); ``dtype`` defaults to bf16 on the card
    and fp32 on the CPU; ``device`` to the card where there is one;
    ``launches`` to 50 on the card (doubling up to ``max_launches``, 200)
    and 1 on the CPU (no doubling: the plain version's time ranks
    nothing). The winner is recorded only where it tiles the shape
    (:func:`tiles`): on a ragged length the default, the only candidate,
    is the kernels' own choice already (``recorded`` False).
    """
    import time as _time

    import torch

    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if bh % heads:
        raise ValueError(f"bh {bh} is not a multiple of heads {heads}")
    clock = clock or _time.perf_counter
    device = torch.device(device or ("cuda" if torch.cuda.is_available()
                                     else "cpu"))
    cuda = device.type == "cuda"
    dtype = dtype or (torch.bfloat16 if cuda else torch.float32)
    launches = launches or (50 if cuda else 1)
    max_launches = max_launches or (200 if cuda else launches)
    call = _inputs(kernel, seq, bh, depth, heads, dtype, device)
    grid = candidates(seq, bh, depth, kernel)
    live, failed = [], 0
    last_exc: Optional[Exception] = None
    for geom in grid:
        try:
            call(geom)
            if cuda:
                torch.cuda.synchronize(device)
            live.append(geom)
        except Exception as exc:  # kept out of the ranking, and counted
            last_exc = exc
            failed += 1
    if not live:
        raise RuntimeError(
            f"autotune: no candidate geometry for {kernel} seq={seq} "
            f"bh={bh} survived measurement") from last_exc
    calls = [lambda g=g: call(g) for g in live]
    while True:
        rows = time_rounds(calls, launches, rounds, cuda, clock)
        ranked = sorted((statistics.median(r), max(r) - min(r), g)
                        for r, g in zip(rows, live))
        best_ms, best_spread, best = ranked[0]
        resolved = True
        if len(ranked) > 1:
            gap = ranked[1][0] - best_ms
            resolved = gap > max(best_spread, ranked[1][1])
        if resolved or launches * 2 > max_launches:
            break
        launches *= 2
    recorded = tiles(best, seq, bh)
    if recorded:
        record_winner(kernel, seq, bh, *best, measured_ms=best_ms,
                      spread_ms=best_spread)
    platform, interpret = platform_stamp(device)
    return {"kernel": kernel, "seq": int(seq), "bh": int(bh),
            "winner": {"block_q": best[0], "block_k": best[1],
                       "bh_block": best[2]},
            "candidates": len(live), "failed": failed,
            "measured_ms": round(best_ms, 4),
            "spread_ms": round(best_spread, 4), "launches": launches,
            "rounds": rounds, "resolved": resolved, "recorded": recorded,
            "times_ms": {f"{g[0]}x{g[1]}g{g[2]}": round(ms, 5)
                         for ms, _, g in ranked},
            "platform": platform, "interpret": interpret}
