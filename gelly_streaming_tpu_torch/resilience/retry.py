"""Bounded exponential backoff + the serving tier's retry policy (the
port's copy of ``gelly_streaming_tpu/resilience/retry.py``).

One shared delay rule (:func:`exp_backoff`) feeds every retry loop in
the resilience layer — supervisor restarts, socket reconnects, and
client-side :class:`RetryPolicy` for ``Overloaded`` serving rejections —
so the backoff shape is tested once and read the same everywhere:
``min(max_s, base_s * 2**attempt)``, plus multiplicative jitter where a
thundering herd is possible.

Jitter is DETERMINISTIC per ``(seed, attempt)``: chaos runs must replay
identically, so nothing here reads global randomness or the clock.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional


def exp_backoff(attempt: int, base_s: float, max_s: float) -> float:
    """Capped exponential delay for the ``attempt``-th retry (0-based)."""
    return min(float(max_s), float(base_s) * (2.0 ** int(attempt)))


def jittered(delay_s: float, jitter: float, seed: int, attempt: int) -> float:
    """Multiply ``delay_s`` by ``1 + jitter * u`` with ``u`` drawn
    deterministically from ``(seed, attempt)`` — spread without losing
    replayability (int-tuple hashes are not salted across processes)."""
    if jitter <= 0:
        return delay_s
    u = random.Random(hash((int(seed), int(attempt)))).random()
    return delay_s * (1.0 + float(jitter) * u)


@dataclass(frozen=True)
class RetryPolicy:
    """Client-side retry budget for :class:`~gelly_streaming_tpu_torch.serving.server.Overloaded`.

    ``attempts`` is the number of RETRIES after the first try; each
    waits ``exp_backoff(i, base_s, max_s)`` (jittered) before re-asking
    admission. Shed rejections (:class:`~gelly_streaming_tpu_torch.serving.server.Shed`)
    are never retried — shedding exists to LOSE that traffic, and a
    retrying client would defeat it.
    """

    attempts: int = 3
    base_s: float = 0.01
    max_s: float = 0.5
    jitter: float = 0.5
    seed: int = 0

    def delay_s(self, attempt: int) -> Optional[float]:
        """Delay before retry ``attempt`` (0-based), or None when the
        budget is spent."""
        if attempt >= self.attempts:
            return None
        return jittered(
            exp_backoff(attempt, self.base_s, self.max_s),
            self.jitter, self.seed, attempt,
        )

    def delay_before(
        self, attempt: int, remaining_s: Optional[float] = None
    ) -> Optional[float]:
        """:meth:`delay_s` clamped to a remaining deadline budget.

        The RPC client retries ``Overloaded`` wire rejections under a
        per-query deadline; sleeping past the budget would turn a
        would-be answer into a guaranteed ``DeadlineExceeded``, so the
        delay is capped at ``remaining_s`` and a spent budget returns
        None (give up NOW, fail the deadline cleanly) — same contract
        shape as :meth:`delay_s`."""
        d = self.delay_s(attempt)
        if d is None or remaining_s is None:
            return d
        if remaining_s <= 0:
            return None
        return min(d, float(remaining_s))
