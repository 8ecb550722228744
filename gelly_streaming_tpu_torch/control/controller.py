"""The self-tuning control plane (the port's copy of
``gelly_streaming_tpu/control/controller.py``): three knob tuners sharing
one decision discipline.

- :class:`AutoK`: superbatch sizing (``superbatch="auto"``), a guarded
  hill-climb on measured group throughput over a power-of-``step`` K
  ladder, with a window-size-shift detector that re-enters the climb when
  the stream's shape changes mid-run.
- :class:`PrefetchTuner`: prefetch queue depth
  (:func:`~gelly_streaming_tpu_torch.core.pipeline.prefetch`) from the
  producer-blocked and consumer-idle shares of each decision window.
- :class:`AdmissionTuner`: serving admission + shed watermarks from
  measured queue wait against the deadline budgets queries carry (a host
  class; wiring it into the server and the router comes with ROADMAP
  Queue 1, slice 9).

The shared discipline:

- **Bounded step**: every retune moves the knob one rung.
- **Hysteresis**: moves need the signal past a threshold by a margin, a
  refused probe is remembered with the throughput band it failed against
  and is not retried until the landscape changes materially
  (``reprobe_band``), and every revert starts a cooldown.
- **Decisions are events**: every knob move logs a
  ``control.retune{knob,from,to,signal}`` registry counter when obs is on,
  and the tuners keep a bounded in-object ``history`` either way.

The tuners decide from the taps they are given: the drive loop times a
group with ``summaries/groupfold.py``'s ``_clock`` (which a test replaces
with a stub), and a test may instead feed :meth:`AutoK.tap_group`
directly. Nothing here reads the clock, except :class:`PrefetchTuner`
through its own replaceable ``_clock``.
"""

from __future__ import annotations

from typing import Optional

from ..obs import trace as _trace
from ..obs.registry import get_registry
from .signals import SignalReader

#: bounded length of every tuner's in-object decision history
HISTORY_MAX = 256


def log_retune(knob: str, old, new, signal: str) -> None:
    """One knob move as a registry counter.
    Gated: with obs disabled a retune still HAPPENS (the tuners run on
    direct taps), it just is not logged."""
    if _trace.on():
        get_registry().counter(
            "control.retune", knob=knob,
            **{"from": str(old), "to": str(new), "signal": signal},
        ).inc()


class _HistoryMixin:
    def _record(self, knob: str, old, new, signal: str) -> None:
        h = self.history
        h.append((old, new, signal))
        if len(h) > HISTORY_MAX:
            del h[: len(h) - HISTORY_MAX]
        log_retune(knob, old, new, signal)


class AutoK(_HistoryMixin):
    """Superbatch-K tuner: guarded hill-climb over a power-of-``step``
    ladder, driven by per-group throughput taps from the drive loop.

    The drive loop calls :meth:`tap_group` once per folded group (host
    wall seconds per group — cadence-rate, works with obs off). Every
    ``decide_groups`` groups at the CURRENT K the tuner decides:

    - climbing up, a probe must IMPROVE throughput by ``improve``
      (default 8%) or it reverts — per-dispatch fixed cost already
      amortized means bigger groups only add memory and latency grain;
    - climbing down, a probe may KEEP throughput within ``keep``
      (default 5% loss) — the tuner prefers the smallest K inside the
      throughput band, so converged K carries the least emission
      latency and checkpoint granularity the plateau allows;
    - a refused rung is remembered against the throughput it lost to
      and not retried until throughput at the held K moves by more than
      ``reprobe_band`` (no oscillation between adjacent rungs under
      noisy measurements);
    - a window-size shift of ``shift_factor`` or more (mean edges per
      window vs the anchor the current ladder was learned at) clears
      that memory and re-enters the climb toward the new optimum —
      DOWN when windows grew (less fusion needed per dispatch), UP when
      they shrank.

    With obs enabled, the ``engine.superbatch_dispatch`` vs
    ``window.superbatch_pack``/``window.pack`` span ratio breaks a hold:
    dispatch seconds per window far above pack seconds per window means
    per-dispatch fixed cost still dominates, so the tuner re-probes up
    even though held throughput has not moved. ``pipeline.consumer_idle_s``
    rides into the decision log as evidence. Obs off, the hill-climb
    alone converges; the spans only speed it up.
    """

    def __init__(
        self,
        *,
        k0: int = 1,
        k_max: int = 256,
        step: int = 4,
        decide_groups: int = 1,
        improve: float = 1.08,
        keep: float = 0.95,
        reprobe_band: float = 0.25,
        shift_factor: float = 2.0,
        cooldown: int = 2,
        dispatch_ratio_hi: float = 4.0,
        signals: Optional[SignalReader] = None,
        knob: str = "superbatch_k",
    ):
        if step < 2:
            raise ValueError(f"step must be >= 2, got {step}")
        self.k = max(1, int(k0))
        self.k_max = max(1, int(k_max))
        self.step = int(step)
        self.decide_groups = max(1, int(decide_groups))
        self.improve = float(improve)
        self.keep = float(keep)
        self.reprobe_band = float(reprobe_band)
        self.shift_factor = float(shift_factor)
        self.cooldown = max(0, int(cooldown))
        self.dispatch_ratio_hi = float(dispatch_ratio_hi)
        self.signals = signals if signals is not None else SignalReader()
        self.knob = knob
        #: (old_k, new_k, signal) per decision that moved the knob
        self.history: list = []
        # decision state
        self._stats: dict = {}     # k -> [groups, edges, seconds, windows]
        self._base: Optional[tuple] = None   # (k, eps) accepted point
        self._probing: Optional[str] = None  # "up" | "down" | None
        self._hold_eps: Optional[float] = None
        self._cool = 0
        self._failed: dict = {}    # refused k -> base eps it lost to
        self._w_anchor: Optional[float] = None

    # -- drive-loop surface -------------------------------------------- #
    def current_k(self) -> int:
        """The K the packer should tile the NEXT group at (the drive
        loop's ``k_fn``; read from the prefetch producer thread — a
        plain int read, no lock needed)."""
        return self.k

    def tap_group(self, n_windows: int, n_edges: int, wall_s: float) -> int:
        """One folded group's measurement. Attribution is by the
        group's OWN window count: groups packed at the previous K are
        still in flight for a prefetch depth after a retune, and a
        final partial group never reaches ``decide_groups`` at its odd
        size — both stay honest without special cases. Seconds credited
        as FOREIGN by the consumer (a checkpoint barrier landing inside
        this group's yields —
        :func:`~gelly_streaming_tpu_torch.control.signals.add_excluded_s`)
        are subtracted so a rare out-of-band stall cannot masquerade as
        a throughput collapse at the current K. Returns the K for
        upcoming groups."""
        from .signals import take_excluded_s

        wall_s -= take_excluded_s()
        if n_windows <= 0 or wall_s <= 0:
            return self.k
        st = self._stats.get(n_windows)
        if st is None:
            st = self._stats[n_windows] = [0, 0.0, 0.0, 0]
        st[0] += 1
        st[1] += float(n_edges)
        st[2] += float(wall_s)
        st[3] += int(n_windows)
        cur = self._stats.get(self.k)
        if cur is not None and cur[0] >= self.decide_groups:
            eps = cur[1] / cur[2]
            w_mean = cur[1] / max(1, cur[3])
            del self._stats[self.k]
            self._decide(eps, w_mean)
        return self.k

    # -- decision core -------------------------------------------------- #
    def _rung(self, direction: str) -> int:
        nxt = self.k * self.step if direction == "up" else \
            self.k // self.step
        return max(1, min(self.k_max, nxt))

    def _move(self, new_k: int, signal: str) -> None:
        if new_k != self.k:
            self._record(self.knob, self.k, new_k, signal)
            self.k = new_k
            # drop any stale accumulation at the new rung: a leftover
            # bucket from an earlier visit (or from same-count groups of
            # a different window size) must not decide the fresh probe
            self._stats.pop(new_k, None)

    def _enter_hold(self, eps: float) -> None:
        self._probing = None
        self._hold_eps = eps

    def _probe(self, direction: str, signal: str) -> bool:
        """Move one rung if it exists and is not band-refused."""
        nxt = self._rung(direction)
        if nxt == self.k:
            return False
        base_eps = self._base[1] if self._base else None
        refused = self._failed.get(nxt)
        if refused is not None and base_eps is not None and \
                abs(base_eps - refused) <= self.reprobe_band * refused:
            return False  # the landscape it failed against still holds
        self._failed.pop(nxt, None)
        self._probing = direction
        self._move(nxt, signal)
        return True

    def _decide(self, eps: float, w_mean: float) -> None:
        # window-size shift: the ladder was learned at another window
        # shape — forget refusals and re-climb toward the new optimum
        if self._w_anchor is None:
            self._w_anchor = w_mean
        elif w_mean >= self.shift_factor * self._w_anchor or \
                w_mean * self.shift_factor <= self._w_anchor:
            grew = w_mean > self._w_anchor
            self._w_anchor = w_mean
            self._failed.clear()
            # in-flight groups packed at the OLD window size share a
            # window count with post-shift groups; their mixed
            # edges/seconds must not feed post-shift decisions
            self._stats.clear()
            self._cool = 0
            self._base = (self.k, eps)
            if self._probe("down" if grew else "up", "window-shift"):
                return
            self._enter_hold(eps)
            return
        if self._probing is not None and self._base is not None:
            base_k, base_eps = self._base
            ok = (
                eps >= self.improve * base_eps
                if self._probing == "up"
                else eps >= self.keep * base_eps
            )
            if ok:
                direction = self._probing
                self._base = (self.k, eps)
                if not self._probe(direction, "eps-" + (
                        "improved" if direction == "up" else "held")):
                    self._enter_hold(eps)
            else:
                self._failed[self.k] = base_eps
                self._move(base_k, "probe-reverted")
                self._enter_hold(base_eps)
                self._cool = self.cooldown
            return
        if self._base is None:
            # first decision: adopt the measured point, start climbing
            self._base = (self.k, eps)
            if not self._probe("up", "initial-climb"):
                self._enter_hold(eps)
            return
        # holding
        if self._cool > 0:
            self._cool -= 1
            self._hold_eps = eps if self._hold_eps is None else \
                0.8 * self._hold_eps + 0.2 * eps
            return
        held = self._hold_eps if self._hold_eps is not None else eps
        if held > 0 and abs(eps - held) > self.reprobe_band * held:
            # the landscape moved materially: re-learn from here
            self._failed.clear()
            self._base = (self.k, eps)
            direction = "up" if self.k < self.k_max else "down"
            if self._probe(direction, "eps-shift"):
                return
            self._enter_hold(eps)
            return
        if self._span_hint() and self._base is not None:
            self._base = (self.k, eps)
            if self._probe("up", "dispatch-share"):
                return
        self._hold_eps = 0.8 * held + 0.2 * eps

    def _span_hint(self) -> bool:
        """Obs-on climb hint: dispatch seconds per window dwarfing pack
        seconds per window means per-dispatch fixed cost still
        dominates at the held K."""
        dn, ds = self.signals.span_delta("engine.superbatch_dispatch")
        dn2, ds2 = self.signals.span_delta("engine.dispatch")
        pn, ps = self.signals.span_delta("window.superbatch_pack")
        pn2, ps2 = self.signals.span_delta("window.pack")
        # consumed so the next window starts fresh even when unused
        self.signals.counter_delta("pipeline.consumer_idle_s")
        disp_windows = dn * self.k + dn2
        pack_windows = pn * self.k + pn2
        if disp_windows <= 0 or pack_windows <= 0:
            return False
        disp_pw = (ds + ds2) / disp_windows
        pack_pw = (ps + ps2) / pack_windows
        return pack_pw > 0 and disp_pw > self.dispatch_ratio_hi * pack_pw


class PrefetchTuner(_HistoryMixin):
    """Prefetch-depth tuner for
    :func:`~gelly_streaming_tpu_torch.core.pipeline.prefetch`.

    The prefetch loop taps it per item (one clock subtraction each on
    the put and get paths — opting into tuning opts into that cost);
    every ``decide_items`` items it compares the decision window's
    producer-blocked and consumer-idle SHARES of wall time:

    - consumer idle above ``hi``: the producer is the bottleneck and
      bursty — deepen the queue one rung (x2) so lookahead absorbs the
      bursts, up to ``depth_max``;
    - producer blocked above ``hi`` with the consumer never idle: the
      consumer is the bottleneck and the queue is pure ballast — shrink
      one rung toward ``depth_min`` (same throughput, less memory
      pinned in queued blocks);
    - anything between the bands holds (hysteresis), and every move
      starts a ``cooldown`` so one noisy window cannot thrash the depth.
    """

    def __init__(
        self,
        *,
        depth: int = 2,
        depth_min: int = 1,
        depth_max: int = 16,
        decide_items: int = 32,
        hi: float = 0.25,
        lo: float = 0.05,
        cooldown: int = 2,
        knob: str = "prefetch_depth",
    ):
        self.depth = max(1, int(depth))
        self.depth_min = max(1, int(depth_min))
        self.depth_max = max(self.depth_min, int(depth_max))
        self.depth = min(max(self.depth, self.depth_min), self.depth_max)
        self.decide_items = max(1, int(decide_items))
        self.hi = float(hi)
        self.lo = float(lo)
        self.cooldown = max(0, int(cooldown))
        self.knob = knob
        self.history: list = []
        import threading
        import time as _time

        self._lock = threading.Lock()
        self._clock = _time.perf_counter
        self._blocked = 0.0
        self._idle = 0.0
        self._items = 0
        self._t0: Optional[float] = None
        self._cool = 0

    def tap_put(self, blocked_s: float) -> None:
        """Producer-side: seconds this put spent over the soft depth cap
        (0.0 for an immediate put)."""
        if blocked_s > 0:
            with self._lock:
                self._blocked += blocked_s

    def tap_get(self, idle_s: float) -> None:
        """Consumer-side: seconds this pull waited on an empty queue."""
        with self._lock:
            if idle_s > 0:
                self._idle += idle_s
            self._items += 1
            now = self._clock()
            if self._t0 is None:
                self._t0 = now
                return
            if self._items < self.decide_items:
                return
            wall = max(1e-9, now - self._t0)
            blocked_share = self._blocked / wall
            idle_share = self._idle / wall
            self._blocked = 0.0
            self._idle = 0.0
            self._items = 0
            self._t0 = now
        self._decide(blocked_share, idle_share)

    def _decide(self, blocked_share: float, idle_share: float) -> None:
        if self._cool > 0:
            self._cool -= 1
            return
        old = self.depth
        if idle_share > self.hi and self.depth < self.depth_max:
            self.depth = min(self.depth_max, self.depth * 2)
            self._record(self.knob, old, self.depth, "consumer-idle")
            self._cool = self.cooldown
        elif blocked_share > self.hi and idle_share < self.lo \
                and self.depth > self.depth_min:
            self.depth = max(self.depth_min, self.depth // 2)
            self._record(self.knob, old, self.depth, "producer-blocked")
            self._cool = self.cooldown


class AdmissionTuner(_HistoryMixin):
    """Admission/shed tuner for the serving tier.

    The serving worker taps it once per answered sweep with the sweep's
    oldest queue wait (the leading signal: waits grow before answer
    latency breaches anyone's deadline) and the tightest deadline
    budget the sweep's queries carried. Every ``decide_sweeps`` sweeps:

    - worst wait above ``hi`` of the budget: shed earlier — shrink
      ``max_pending`` one multiplicative notch (``step``) and pull the
      shed watermark down with it, never below ``floor_frac`` of the
      configured ceiling;
    - worst wait below ``lo`` of the budget with headroom shed away:
      recover one notch toward the CONFIGURED ceiling (the operator's
      limit is the contract; the tuner only moves inside it);
    - between the bands: hold. Every move starts a ``cooldown``.

    With no deadlines in the traffic and no ``target_wait_s``
    configured there is no budget to compare against, so the tuner
    holds — admission then behaves exactly as the hand-set constants.
    """

    def __init__(
        self,
        *,
        max_pending: int,
        shed_watermark: float = 0.8,
        target_wait_s: Optional[float] = None,
        hi: float = 0.5,
        lo: float = 0.2,
        step: float = 0.7,
        floor_frac: float = 0.1,
        decide_sweeps: int = 8,
        cooldown: int = 2,
        knob: str = "max_pending",
    ):
        self.ceiling = max(1, int(max_pending))
        self.max_pending = self.ceiling
        self.shed_watermark_ceiling = float(shed_watermark)
        self.shed_watermark = float(shed_watermark)
        self.target_wait_s = target_wait_s
        self.hi = float(hi)
        self.lo = float(lo)
        self.step = float(step)
        self.floor = max(1, int(floor_frac * self.ceiling))
        self.decide_sweeps = max(1, int(decide_sweeps))
        self.cooldown = max(0, int(cooldown))
        self.knob = knob
        self.history: list = []
        self._sweeps = 0
        self._worst_wait = 0.0
        self._min_budget: Optional[float] = None
        self._cool = 0

    def shed_level(self) -> int:
        """The absolute shed watermark the server applies (recomputed
        from the tuned fraction and tuned admission limit)."""
        return max(1, int(self.shed_watermark * self.max_pending))

    def tap_entries(self, queue_wait_s: float, entries) -> bool:
        """One sweep's evidence from raw ``(t0, deadline_abs|None)``
        pairs: computes the tightest budget and defers to
        :meth:`tap_sweep` — THE one leading-signal computation both
        serving tiers call (StreamServer's worker sweep and the
        router's drain sweep), so budget selection can never drift
        between them. Returns True when the knobs moved."""
        budget = None
        for t0, dl in entries:
            if dl is not None:
                b = dl - t0
                if budget is None or b < budget:
                    budget = b
        return self.tap_sweep(queue_wait_s, budget)

    def tap_sweep(self, queue_wait_s: float,
                  min_budget_s: Optional[float]) -> bool:
        """One answered sweep's evidence; returns True when the knobs
        moved (the caller re-applies them to its admission fields)."""
        self._sweeps += 1
        if queue_wait_s > self._worst_wait:
            self._worst_wait = queue_wait_s
        if min_budget_s is not None and (
                self._min_budget is None or min_budget_s < self._min_budget):
            self._min_budget = min_budget_s
        if self._sweeps < self.decide_sweeps:
            return False
        worst = self._worst_wait
        budget = self._min_budget if self._min_budget is not None \
            else self.target_wait_s
        self._sweeps = 0
        self._worst_wait = 0.0
        self._min_budget = None
        if budget is None or budget <= 0:
            return False
        if self._cool > 0:
            self._cool -= 1
            return False
        frac = worst / budget
        old = self.max_pending
        if frac > self.hi and self.max_pending > self.floor:
            self.max_pending = max(
                self.floor, int(self.max_pending * self.step)
            )
            self.shed_watermark = max(
                0.25, self.shed_watermark * self.step
            )
            self._record(self.knob, old, self.max_pending, "queue-wait")
            self._cool = self.cooldown
            return True
        if frac < self.lo and self.max_pending < self.ceiling:
            self.max_pending = min(
                self.ceiling, max(self.max_pending + 1,
                                  int(self.max_pending / self.step))
            )
            self.shed_watermark = min(
                self.shed_watermark_ceiling,
                self.shed_watermark / self.step,
            )
            self._record(self.knob, old, self.max_pending, "wait-recovered")
            self._cool = self.cooldown
            return True
        return False


class ControlPlane:
    """One run's bundle of tuners sharing a
    :class:`~gelly_streaming_tpu_torch.control.signals.SignalReader` — what
    the drive loop / server carries around instead of three loose
    objects. Any slot may be None (the loop only exercises the knobs it
    owns)."""

    def __init__(self, *, autok: Optional[AutoK] = None,
                 prefetch: Optional[PrefetchTuner] = None,
                 admission: Optional[AdmissionTuner] = None,
                 signals: Optional[SignalReader] = None):
        self.signals = signals if signals is not None else SignalReader()
        self.autok = autok
        self.prefetch = prefetch
        self.admission = admission


def default_plane(k0: int = 1) -> ControlPlane:
    """The stock ``superbatch="auto"`` plane every group-folded run
    builds unless one was injected: AutoK from ``k0`` + an adaptive
    group-prefetch tuner over ONE shared SignalReader. Lives here so
    the engine/CC/bipartiteness run loops cannot drift apart on the
    default-plane shape."""
    signals = SignalReader()
    return ControlPlane(
        autok=AutoK(k0=max(1, int(k0)), signals=signals),
        prefetch=PrefetchTuner(),
        signals=signals,
    )
