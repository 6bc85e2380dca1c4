"""Shared retry/backoff policy: a copy of the JAX package's
``utils/retry.py``, kept rule for rule (``tests/test_torch_fleet.py``
holds its schedules to the original's). The fleet's supervisor and
router use it.

Design constraints, all test-driven:

* **stdlib-only** — the fleet's parent process loads this by file path
  (``tools/_bootstrap.py``) and must never import torch, numpy or a
  package ``__init__`` chain that does;
* **deterministic under test** — the jitter source, sleep function, and
  clock are injectable, so unit tests assert exact delay sequences with
  a fake clock instead of sleeping;
* **bounded** — attempts are finite and the per-delay cap is explicit;
  an exhausted policy re-raises the LAST error (with context), never
  swallows it.

Jitter is "full jitter" scaled: ``delay = backoff * (1 - jitter + jitter
* u)`` with ``u ~ U[0, 1)`` — at the default ``jitter=0.5`` delays land
in ``[0.5, 1.0) * backoff``, decorrelating retry herds (every host of a
multi-host job hitting the same flaky filer) while keeping the expected
wait predictable.

Two opt-in extensions (the serving router's requirements — both OFF by
default, so the default delay sequence is the plain scaled jitter):

* ``full_jitter=True`` — the AWS "full jitter" scheme: ``delay = backoff
  * u`` with ``u ~ U[0, 1)``. A router retrying a failed replica wants
  maximal decorrelation (many concurrent requests fail over at the same
  instant when a replica dies) and a LOW expected wait, not a
  predictable one — half the raw backoff on average, spread over the
  whole interval;
* ``max_elapsed_s`` — a wall-clock budget over the WHOLE retry loop
  (measured by the injectable ``clock``): once the next sleep would
  land past the budget, :func:`retry_call` stops retrying and raises.
  Per-request deadlines make "attempts" the wrong unit alone — a
  deadline-bound caller needs the loop bounded in seconds too.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type


class RetryError(RuntimeError):
    """All attempts exhausted; ``__cause__`` is the last underlying error."""


class RetryPolicy:
    """Exponential backoff with jitter, bounded attempts.

    ``attempts`` counts TOTAL calls (1 = no retries). ``base_delay_s`` is
    the pre-jitter delay before the first retry, doubling (``multiplier``)
    per retry up to ``max_delay_s``. ``jitter`` in [0, 1] is the fraction
    of each delay that is randomized (0 = deterministic, for tests and
    for callers that already decorrelate externally).

    ``full_jitter=True`` switches to ``delay = raw * u`` (``jitter`` is
    then ignored); ``max_elapsed_s`` bounds the whole retry loop in
    wall-clock seconds (:func:`retry_call` checks it against ``clock``
    before every sleep). Both default off — see the module docstring.
    """

    def __init__(
        self,
        attempts: int = 3,
        base_delay_s: float = 0.5,
        max_delay_s: float = 30.0,
        multiplier: float = 2.0,
        jitter: float = 0.5,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
        full_jitter: bool = False,
        max_elapsed_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        if base_delay_s < 0 or max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if multiplier < 1:
            raise ValueError(f"multiplier must be >= 1, got {multiplier}")
        if not 0 <= jitter <= 1:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        if max_elapsed_s is not None and max_elapsed_s < 0:
            raise ValueError(
                f"max_elapsed_s must be >= 0, got {max_elapsed_s}")
        self.attempts = int(attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.sleep = sleep
        self.rng = rng if rng is not None else random.Random()
        self.full_jitter = bool(full_jitter)
        self.max_elapsed_s = (None if max_elapsed_s is None
                              else float(max_elapsed_s))
        self.clock = clock

    def backoff_s(self, retry_index: int) -> float:
        """Jittered delay before retry ``retry_index`` (0-based: the delay
        after the first failed attempt is ``backoff_s(0)``)."""
        raw = min(self.max_delay_s,
                  self.base_delay_s * self.multiplier ** retry_index)
        if self.full_jitter:
            return raw * self.rng.random()
        if self.jitter == 0:
            return raw
        return raw * (1.0 - self.jitter + self.jitter * self.rng.random())

    def delays(self) -> Iterator[float]:
        """The policy's ``attempts - 1`` jittered retry delays, in order."""
        for i in range(self.attempts - 1):
            yield self.backoff_s(i)


def retry_call(
    fn: Callable,
    *args,
    policy: Optional[RetryPolicy] = None,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    description: str = "",
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, retrying ``retry_on`` errors per
    ``policy``.

    ``on_retry(attempt, error, delay_s)`` fires before each backoff sleep
    (attempt is 1-based) — the hook call sites use to emit ``fault``
    telemetry records / warnings without this module knowing about either.
    Exhausted attempts raise :class:`RetryError` from the last error;
    non-``retry_on`` errors propagate immediately (a genuine bug must not
    burn the retry budget looking transient). With ``policy.max_elapsed_s``
    set, a retry whose backoff sleep would end past the budget (measured
    by ``policy.clock`` from this call's entry) is abandoned the same way
    an exhausted attempt count is.
    """
    policy = policy or RetryPolicy()
    t0 = policy.clock() if policy.max_elapsed_s is not None else 0.0
    last: Optional[BaseException] = None
    exhausted_by = ""
    for attempt in range(1, policy.attempts + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as exc:
            last = exc
            if attempt >= policy.attempts:
                exhausted_by = f"after {policy.attempts} attempt(s)"
                break
            delay = policy.backoff_s(attempt - 1)
            if policy.max_elapsed_s is not None and (
                    policy.clock() - t0 + delay > policy.max_elapsed_s):
                exhausted_by = (
                    f"after {attempt} attempt(s): next {delay:.3f}s "
                    f"backoff exceeds the {policy.max_elapsed_s:g}s "
                    "elapsed budget")
                break
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            policy.sleep(delay)
    what = description or getattr(fn, "__name__", "call")
    raise RetryError(
        f"{what} failed {exhausted_by}: "
        f"{type(last).__name__}: {last}") from last
