"""Jittered exponential backoff around transient I/O failures.

Port of ``dalle_tpu/utils/retry.py``, with the same names, schedule and
telemetry. A checkpoint write that races a filesystem hiccup costs a few
milliseconds of backoff instead of the run:

* **Budget.** At most ``attempts`` tries; exhaustion raises
  :class:`RetryBudgetExceeded` chained onto the last real error, so the
  caller still sees the root cause as ``__cause__``.
* **Backoff.** Delay ``min(base·2ⁱ, max)`` scaled by ``1 ± jitter``,
  drawn from ``random.Random(seed)``: for one seed the schedule equals
  the JAX package's.
* **Telemetry** (the port's ``obs``): every retried failure adds to
  ``retry.attempts_total{op=}``, exhaustion to
  ``retry.exhausted_total{op=}``, a success after a failure to
  ``retry.recovered_total{op=}``; each wait is a ``retry/backoff`` span
  with the op, the attempt and the delay.

Only :data:`TRANSIENT` classes are retried (``OSError`` and its
``ConnectionError``/``TimeoutError``; the chaos harness's injected faults
subclass ``OSError`` and ride the same path). A ``ValueError`` from a
corrupt checkpoint propagates at once.
"""

from __future__ import annotations

import functools
import random
import time
from typing import Callable, Optional, Tuple, Type

from ..obs import counter_add, span

TRANSIENT: Tuple[Type[BaseException], ...] = (OSError, ConnectionError, TimeoutError)


class RetryBudgetExceeded(RuntimeError):
    """Raised when every attempt failed; ``__cause__`` is the last error."""

    def __init__(self, op: str, attempts: int, last: BaseException):
        super().__init__(f"retry budget exhausted for {op!r}: {attempts} attempts, "
                         f"last error: {last!r}")
        self.op = op
        self.attempts = attempts
        self.last = last


def backoff_delays(attempts: int, *, base_delay_s: float = 0.05, max_delay_s: float = 2.0,
                   jitter: float = 0.5, seed: Optional[int] = None):
    """The schedule: ``attempts - 1`` delays (none after the last failure),
    each ``min(base·2ⁱ, max)`` scaled uniformly in ``[1-jitter, 1+jitter]``."""
    rng = random.Random(seed)
    out = []
    for i in range(max(attempts - 1, 0)):
        d = min(base_delay_s * (2.0 ** i), max_delay_s)
        out.append(d * (1.0 + jitter * (2.0 * rng.random() - 1.0)))
    return out


def retry(op: str, *, attempts: int = 5, base_delay_s: float = 0.05,
          max_delay_s: float = 2.0, jitter: float = 0.5,
          retry_on: Tuple[Type[BaseException], ...] = TRANSIENT,
          seed: Optional[int] = None, sleep: Callable[[float], None] = time.sleep,
          log=None):
    """Decorator factory: ``@retry("ckpt_save")`` makes the callable absorb
    up to ``attempts - 1`` transient failures, backing off between tries.
    ``sleep`` is injectable, so tests check the schedule without waiting."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            delays = backoff_delays(attempts, base_delay_s=base_delay_s,
                                    max_delay_s=max_delay_s, jitter=jitter, seed=seed)
            last: Optional[BaseException] = None
            for attempt in range(attempts):
                try:
                    out = fn(*args, **kwargs)
                except retry_on as exc:
                    last = exc
                    counter_add("retry.attempts_total", 1.0, labels={"op": op})
                    if attempt + 1 >= attempts:
                        break
                    delay = delays[attempt]
                    if log is not None:
                        log(f"[retry] {op}: attempt {attempt + 1}/{attempts} failed "
                            f"({exc!r}); retrying in {delay * 1e3:.0f} ms")
                    with span("retry/backoff", op=op, attempt=attempt + 1, delay_s=delay):
                        sleep(delay)
                else:
                    if attempt > 0:
                        counter_add("retry.recovered_total", 1.0, labels={"op": op})
                    return out
            counter_add("retry.exhausted_total", 1.0, labels={"op": op})
            raise RetryBudgetExceeded(op, attempts, last) from last
        return wrapped

    return deco


def with_retry(op: str, fn: Callable, *args, retry_kw: Optional[dict] = None, **kwargs):
    """The call-site form: ``with_retry("ckpt_restore", load, path)`` under
    :func:`retry`'s policy; ``retry_kw`` overrides it (attempts, delays,
    seed, sleep)."""
    return retry(op, **(retry_kw or {}))(fn)(*args, **kwargs)
