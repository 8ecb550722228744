"""Multi-host cadence agreement: one elected K per epoch.

(The port's copy of ``gelly_streaming_tpu/fabric/agreement.py``.)

The control plane makes superbatch K a LEARNED quantity — and the
coordinated layer would reject it, because each process learning its own K
tiles its windows differently and nothing guaranteed the barriers'
window ordinals still lined up. The fix is not to synchronize the
learners; it is to make the OPERATING K an agreed value: at each epoch
boundary every process proposes its locally-learned K under one
election tag and the transport's
:meth:`~gelly_streaming_tpu_torch.fabric.base.Transport.elect` picks exactly
one winner for everyone.

WHERE the election runs matters. The drive loop prefetches groups on a
background thread (``prefetch_groups``), so the packer samples its
``k_fn`` at wall-clock times unrelated to the commit loop — any scheme
that swaps K "at commit time" hands different processes different K
for the same group and the tilings diverge. Instead :class:`ElectedK`
is driven entirely FROM the packer's own call sequence: the dynamic
packer calls ``current_k()`` exactly once per group it forms, so the
adapter can replicate the run loop's barrier rule purely from its call
history — it tracks the window ordinal where the next group starts
(``_index``) and opens a new epoch the first time a group starts
``every`` or more windows past the previous epoch's start, exactly
where ``AutoCheckpoint.run`` will land the barrier (``due`` fires at
the first group END at least ``every`` windows past the last barrier;
that end is this group's start). Every process replays the same rule
over the same agreed K sequence, so epoch boundaries — hence election
tags, hence winners — agree by induction, with no clock anywhere.

Election tags live in the ABSOLUTE window ordinal namespace
(``cadence.e{origin + index}``), so a process restored from epoch N
re-elects under the same tags the pre-kill run persisted: ``elect`` is
put-if-absent + read (replay-safe by the transport contract), so the
replay adopts the recorded winners and tiles forward exactly as the
survivors did. Value identity needs nothing more — the group-fold
contract guarantees emissions identical to the per-window path for ANY
tiling, so the tiling only has to agree ACROSS PROCESSES.

Caveat (documented, not load-bearing today): streams without a native
``superbatches_dynamic`` go through a generic fallback that probes
``k_fn`` ONE extra time for the prefetch depth. The probe pattern is
the same code path on every process, so agreement still holds, but the
tags shift off the true barrier ordinals by one phantom group. The
coordinated path streams (``SimpleEdgeStream``, ``_SkipStream``) all
take the native path.
"""

from __future__ import annotations

from ..obs import trace as _trace
from ..obs.registry import get_registry
from .base import Transport


class ElectedK:
    """The agreed-K controller adapter; see the module docstring.

    ``inner`` is the local learner (an
    :class:`~gelly_streaming_tpu_torch.control.AutoK`) — it keeps learning
    from its own taps, so its proposals improve even while losing
    elections. Unknown attributes delegate to it so controller
    introspection (``k_max``, history) keeps working through the
    wrapper. ``every`` is the coordinated barrier cadence, ``done`` the
    restore epoch (both fixed integers on the coordinated path).
    """

    def __init__(self, inner, transport: Transport, *, every: int,
                 done: int = 0, tag_prefix: str = "cadence"):
        self.inner = inner
        self.transport = transport
        self.tag_prefix = str(tag_prefix)
        self._every = max(1, int(every))
        self._origin = int(done)  # absolute ordinal of window _index 0
        self._index = 0           # window ordinal where the next group starts
        self._seg = 0             # window ordinal where this epoch started
        self._won = {}            # epoch-start ordinal -> agreed K
        # persist the restore epoch's winner up front: k_agreed is live
        # before the packer's first call, and on the collective backend
        # every rank enters this election at the same program point
        self.k_agreed = self._k_for(0)

    def _k_for(self, seg: int) -> int:
        """The agreed K for the epoch starting at relative ordinal
        ``seg`` — elected once, then replayed from the memo (and, across
        restarts, from the transport's persisted winner)."""
        k = self._won.get(seg)
        if k is None:
            tag = f"{self.tag_prefix}.e{self._origin + seg:08d}"
            proposal = max(1, int(self.inner.current_k()))
            k = max(1, int(self.transport.elect(tag, proposal)))
            self._won[seg] = k
            if _trace.on():
                get_registry().counter(
                    "fabric.agree", backend=self.transport.backend,
                    epoch=self._origin + seg, k=k,
                ).inc()
        return k

    # ------------------------------------------------------------ #
    # The controller surface the drive loop consumes
    # ------------------------------------------------------------ #
    def current_k(self) -> int:
        """One call per group formed (the dynamic packer's contract):
        replicate the barrier rule from the call history, return the
        agreed K of the epoch this group belongs to."""
        if self._index - self._seg >= self._every:
            self._seg = self._index
        k = self._k_for(self._seg)
        self._index += k
        self.k_agreed = k
        return k

    def tap_group(self, n_windows: int, n_edges: int,
                  wall_s: float) -> int:
        """Feed the local learner (its proposals keep improving) but
        hold the operating point at the agreed K until the next
        epoch's election."""
        self.inner.tap_group(n_windows, n_edges, wall_s)
        return self.k_agreed

    def __getattr__(self, name: str):
        return getattr(self.inner, name)
