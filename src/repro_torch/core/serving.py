"""Serving layer: queued admission churn with coalesced rebalances (§5).

The :class:`~repro_torch.core.runtime.AdmissionController` rebalances after
EVERY admit/evict under ``placement="joint"`` — correct and never-worse
per event, but at chip scale (32x32, hundreds of tenants) the per-event
joint re-optimization dominates the event loop, and a burst of K queued
events pays K rebalances where the LAST one already sees the final
placement state.  :class:`ServingQueue` batches that work:

  * events (admit / evict / finish) are **submitted** to a queue;
  * :meth:`ServingQueue.drain` applies them under the controller's
    :meth:`~repro_torch.core.runtime.AdmissionController.defer_rebalances`
    window, so each event's placement lands immediately (admission
    latency stays the cheap free-tile binding) but the joint rebalance
    is *recorded*, not run;
  * every ``coalesce_window`` applied events the pending records merge
    into ONE rebalance (:meth:`~repro_torch.core.runtime.AdmissionController.
    flush_rebalances`) whose affected region seeds from all recorded
    apps and freed tiles at once — and whose multi-component region
    search runs with FUSED scoring (one EdgeStack analysis per
    optimizer generation for the whole region, see
    :func:`~repro_torch.core.optimize.optimize_binding_graphs_fused`).

The chip objective still never regresses: every flush's rebalance seeds
from the then-current bindings and floors at pre-flush component
periods, exactly like a per-event rebalance would.  What coalescing
trades away is intermediate placement quality *between* flushes —
admissions within a window run on their greedy free-tile placement
until the next flush (the ``degraded_admissions`` the serving benchmark
counts) — in exchange for an O(window) cut in rebalance work.

Every score runs where the controller's ``device``/``backend`` say
(:class:`~repro_torch.core.runtime.AdmissionController`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np

from .runtime import AdmissionController, AdmissionError

_KINDS = ("admit", "evict", "finish")


@dataclasses.dataclass
class ServiceTicket:
    """One queued serving request and its outcome.

    ``t_submit``/``t_apply``/``t_done`` are ``time.perf_counter()``
    stamps: submission, the moment the drain loop picked the ticket up
    (its event applied, or its quota rejection decided), and the flush
    covering it — the placement a ticket runs under is final only once
    its window's rebalance flushed, so ``t_done - t_submit`` is the full
    service latency including the coalescing delay.  The breakdown
    ``wait_s`` (queue wait before the drain reached it) vs ``service_s``
    (apply + covering flush) is what makes speculative pre-compilation
    visible: a warm artifact shrinks ``service_s`` only.  ``status`` is
    ``"pending"`` until drained, then ``"ok"``, ``"rejected"``
    (admission refused — placement or quota), ``"cancelled"``
    (withdrawn before its drain), or ``"skipped"`` (e.g. evicting an
    app that is not resident).
    """

    kind: str
    app: str
    n_tiles_request: Optional[int] = None
    t_submit: float = 0.0
    t_apply: float = float("nan")
    t_done: float = float("nan")
    status: str = "pending"
    error: str = ""

    @property
    def latency_s(self) -> float:
        """Submit-to-covered-by-flush seconds (NaN while pending)."""
        return self.t_done - self.t_submit

    @property
    def wait_s(self) -> float:
        """Queue wait: submit-to-apply seconds (NaN while pending)."""
        return self.t_apply - self.t_submit

    @property
    def service_s(self) -> float:
        """Apply-to-covered-by-flush seconds (NaN while pending)."""
        return self.t_done - self.t_apply


class PrecompilePool:
    """Speculative pre-compilation between drains (the actor/learner split).

    Tracks which apps keep arriving (exponentially frequency-decayed
    ticket history — recent tenants outrank historical ones) and, between
    drains, *warms* the controller for the likeliest next admissions:

      * the :class:`~repro_torch.core.runtime.DesignArtifact` cache — a
        predicted app that was never registered runs its design-time flow
        (clustering, single-tile order, SDFG build) NOW, off the
        admission critical path;
      * the EdgeStack shape buckets — one B=1 bucket-padded scoring call
        per predicted artifact, so the admission-time analysis of that
        app's (n_actors, n_edges) bucket is a repeat key of the
        controller's shape-bucket counters (and the kernels are built)
        instead of a first sighting inside the drain.  No cache beyond
        those counters is kept.

    ``observe`` feeds the predictor (every admit submission), ``warm``
    runs the speculation, and ``ensure`` does the admission-time
    accounting: a *hit* means the artifact was already cached when its
    ticket drained (speculation or an earlier admission paid the design
    cost), a *miss* means the admission pays it inline — ``hit_rate`` is
    the cache-warm-hit-rate the serving benchmark reports.  Apps are
    resolved by name through ``source`` (name -> raw/clustered SNN,
    extended via :meth:`offer`); a predicted name with no source and no
    cached artifact is skipped — speculation never invents inputs.
    """

    def __init__(
        self,
        ctl: AdmissionController,
        *,
        source: Optional[dict] = None,
        decay: float = 0.9,
        top_k: int = 4,
    ):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        self.ctl = ctl
        self.source: dict = dict(source) if source else {}
        self.decay = float(decay)
        self.top_k = int(top_k)
        self.scores: dict[str, float] = {}
        self.hits = 0
        self.misses = 0
        self.warmed_artifacts = 0
        self.warmed_buckets = 0
        self.warm_calls = 0

    def offer(self, name: str, app) -> None:
        """Make ``app`` resolvable by ``name`` for future warming."""
        self.source[name] = app

    def observe(self, name: str) -> None:
        """Feed one (submitted) admission into the frequency predictor."""
        for k in self.scores:
            self.scores[k] *= self.decay
        self.scores[name] = self.scores.get(name, 0.0) + 1.0

    def predict(self, k: Optional[int] = None) -> list[str]:
        """Top-``k`` likeliest next admissions (score desc, name-stable)."""
        k = self.top_k if k is None else int(k)
        ranked = sorted(self.scores.items(), key=lambda kv: (-kv[1], kv[0]))
        return [name for name, _ in ranked[:k]]

    def _warm_bucket(self, art) -> None:
        """One B=1 bucket-padded solve of ``art``'s graph: the scoring
        shape bucket an admission of this app will hit is now a repeat
        key of the shape-bucket counters (all actors pinned to tile 0 — the
        binding does not matter, only the bucketed stacked shape does)."""
        from .engine import batch_execute, record_cache_stats

        binding = np.zeros(art.graph.n_actors, dtype=np.int64)
        with record_cache_stats(self.ctl.cache_stats):
            batch_execute(
                art.graph, binding, self.ctl.hw, rel_tol=1e-4,
                pad_shapes=True, backend=self.ctl.backend,
                device=self.ctl.device,
            )
        self.warmed_buckets += 1

    def warm(self) -> list[str]:
        """Speculatively pre-compile for the predicted next admissions.

        Returns the names actually warmed this call.  Idempotent per
        state: a predicted app whose artifact is already cached only
        re-warms its shape bucket (cheap — a compile-cache hit by
        construction after the first warm).
        """
        warmed = []
        for name in self.predict():
            key = (name, self.ctl.hw)
            if key not in self.ctl.artifacts:
                src = self.source.get(name)
                if src is None:
                    continue
                self.ctl.register(src)
                self.warmed_artifacts += 1
            self._warm_bucket(self.ctl.artifacts[key])
            warmed.append(name)
        self.warm_calls += 1
        return warmed

    def ensure(self, app: Union[str, object]) -> bool:
        """Admission-time warmth check (+ registration fallback).

        Called when an admit ticket drains: a cached artifact is a *hit*
        (design time already paid — by speculation or an earlier
        admission), anything else is a *miss* and registers the app from
        ``source`` if resolvable so the admission can proceed.  Returns
        the hit verdict.
        """
        name = app if isinstance(app, str) else getattr(
            getattr(app, "snn", app), "name"
        )
        if (name, self.ctl.hw) in self.ctl.artifacts:
            self.hits += 1
            return True
        self.misses += 1
        src = self.source.get(name)
        if src is not None:
            self.ctl.register(src)
        return False

    @property
    def hit_rate(self) -> float:
        """hits / (hits + misses); 0.0 before any ensure() call."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        """JSON-ready counters (stamped into the drain report)."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "warm_calls": self.warm_calls,
            "warmed_artifacts": self.warmed_artifacts,
            "warmed_buckets": self.warmed_buckets,
        }


class ServingQueue:
    """Burst-mode front-end of one :class:`AdmissionController`.

    ``coalesce_window`` is the flush cadence in applied events: 1
    degenerates to per-event rebalancing (the controller's normal
    behaviour, one flush per event), larger windows amortize one region
    rebalance over the whole window.  ``drain`` is synchronous and
    deterministic — events apply in submission order, flushes happen at
    fixed positions — so a replayed trajectory is reproducible.

    ``precompile`` attaches a :class:`PrecompilePool`: every admit
    submission feeds its predictor, every drain starts by warming its
    predictions (the between-drains window is where speculation runs),
    and every draining admit goes through its hit/miss accounting.

    ``quotas`` maps tenant (app name) -> maximum tiles one admission may
    request (``set_quota`` edits it later).  A ticket over quota is
    refused at its drain WITHOUT touching the placement — status
    ``"rejected"``, error ``"quota"`` — and stamped on the controller
    trajectory (:meth:`~repro_torch.core.runtime.AdmissionController.
    record_rejection`), same as a cancellation; the Fig.-11 flow audits
    every outcome.  An admit with no explicit ``n_tiles_request`` counts
    as requesting the app's cluster count (its maximum footprint) when
    the artifact is cached, and is never quota-refused before the design
    flow has revealed its size.
    """

    def __init__(
        self,
        ctl: AdmissionController,
        *,
        coalesce_window: int = 8,
        precompile: Optional[PrecompilePool] = None,
        quotas: Optional[dict[str, int]] = None,
    ):
        if coalesce_window < 1:
            raise ValueError(
                f"coalesce_window must be >= 1, got {coalesce_window}"
            )
        self.ctl = ctl
        self.coalesce_window = int(coalesce_window)
        self.precompile = precompile
        self.quotas: dict[str, int] = dict(quotas) if quotas else {}
        self.tickets: list[ServiceTicket] = []
        self._queue: list[ServiceTicket] = []
        self.flushes = 0
        self.coalesced_events = 0
        self.degraded_admissions = 0
        self.cancelled = 0
        self.quota_rejections = 0

    # -- submission ------------------------------------------------------
    def submit(
        self, kind: str, app: str, *,
        n_tiles_request: Optional[int] = None,
    ) -> ServiceTicket:
        """Queue one event; returns its (pending) ticket."""
        if kind not in _KINDS:
            raise ValueError(f"unknown kind {kind!r}; have {_KINDS}")
        t = ServiceTicket(
            kind=kind, app=app, n_tiles_request=n_tiles_request,
            t_submit=time.perf_counter(),
        )
        self._queue.append(t)
        self.tickets.append(t)
        return t

    def submit_admit(
        self, app: str, *, n_tiles_request: Optional[int] = None
    ) -> ServiceTicket:
        t = self.submit("admit", app, n_tiles_request=n_tiles_request)
        if self.precompile is not None:
            self.precompile.observe(app)
        return t

    def submit_evict(self, app: str) -> ServiceTicket:
        return self.submit("evict", app)

    def cancel(self, ticket: ServiceTicket) -> bool:
        """Withdraw a still-queued ticket before its drain.

        Returns True when the ticket was pending and is now
        ``"cancelled"`` (stamped on the controller trajectory as a
        rejection with reason ``"cancelled"``); False when it already
        drained — a drained ticket's effect is applied and a cancel
        cannot undo it (submit the inverse event instead).
        """
        if ticket.status != "pending" or ticket not in self._queue:
            return False
        self._queue.remove(ticket)
        ticket.status = "cancelled"
        ticket.t_apply = ticket.t_done = time.perf_counter()
        self.cancelled += 1
        self.ctl.record_rejection(ticket.app, "cancelled")
        return True

    def set_quota(self, app: str, max_tiles: Optional[int]) -> None:
        """Set (or clear, with None) one tenant's tile quota."""
        if max_tiles is None:
            self.quotas.pop(app, None)
        else:
            if max_tiles < 1:
                raise ValueError(f"quota must be >= 1, got {max_tiles}")
            self.quotas[app] = int(max_tiles)

    @property
    def pending(self) -> int:
        """Queued events not yet drained."""
        return len(self._queue)

    def _over_quota(self, t: ServiceTicket) -> bool:
        quota = self.quotas.get(t.app)
        if quota is None:
            return False
        requested = t.n_tiles_request
        if requested is None:
            art = self.ctl.artifacts.get((t.app, self.ctl.hw))
            if art is None:
                return False    # size unknown until the design flow runs
            requested = art.clustered.n_clusters
        return int(requested) > quota

    # -- drain -----------------------------------------------------------
    def _apply(self, t: ServiceTicket) -> None:
        ctl = self.ctl
        t.t_apply = time.perf_counter()
        try:
            if t.kind == "admit":
                if self._over_quota(t):
                    t.status = "rejected"
                    t.error = "quota"
                    self.quota_rejections += 1
                    ctl.record_rejection(t.app, "quota")
                    return
                if self.precompile is not None:
                    self.precompile.ensure(t.app)
                ctl.admit(t.app, n_tiles_request=t.n_tiles_request)
                # placement lands greedy (free-tile) now; the joint
                # rebalance that would refine it is deferred to the
                # window's flush
                self.degraded_admissions += 1
            elif t.kind == "evict":
                if t.app not in ctl.state.allocated:
                    t.status = "skipped"
                    return
                ctl.evict(t.app)
            else:
                if t.app not in ctl.state.allocated:
                    t.status = "skipped"
                    return
                ctl.finish(t.app)
            t.status = "ok"
        except AdmissionError as e:
            t.status = "rejected"
            t.error = str(e)

    def drain(self) -> dict:
        """Apply every queued event, flushing each coalescing window.

        Returns a JSON-ready stats dict for this drain call.  Tickets
        stamp ``t_done`` at their covering flush, so latency includes
        the coalescing delay.
        """
        ctl = self.ctl
        if self.precompile is not None:
            # the between-drains speculation window closes here: warm the
            # predicted artifacts/buckets before the first ticket applies
            self.precompile.warm()
        done: list[ServiceTicket] = []
        window: list[ServiceTicket] = []

        def _flush() -> None:
            n = ctl.flush_rebalances()
            self.flushes += 1
            self.coalesced_events += max(n - 1, 0)
            now = time.perf_counter()
            for t in window:
                t.t_done = now
            done.extend(window)
            window.clear()

        with ctl.defer_rebalances():
            while self._queue:
                t = self._queue.pop(0)
                self._apply(t)
                window.append(t)
                if len(window) >= self.coalesce_window:
                    _flush()
            if window:
                _flush()
        ok_admits = [
            t for t in done if t.kind == "admit" and t.status == "ok"
        ]
        lat = [t.latency_s for t in ok_admits]
        waits = [t.wait_s for t in ok_admits]
        services = [t.service_s for t in ok_admits]

        def _pcts(xs: list[float]) -> tuple[float, float]:
            if not xs:
                return 0.0, 0.0
            return (
                float(np.percentile(xs, 50)), float(np.percentile(xs, 99))
            )

        wait_p50, wait_p99 = _pcts(waits)
        service_p50, service_p99 = _pcts(services)
        stats = {
            "processed": len(done),
            "admitted": len(ok_admits),
            "evicted": sum(
                1 for t in done if t.kind == "evict" and t.status == "ok"
            ),
            "rejected": sum(1 for t in done if t.status == "rejected"),
            "quota_rejections": self.quota_rejections,
            "cancelled": self.cancelled,
            "skipped": sum(1 for t in done if t.status == "skipped"),
            "flushes": self.flushes,
            "coalesced_events": self.coalesced_events,
            "degraded_admissions": self.degraded_admissions,
            "admit_latency_p50_s": (
                float(np.percentile(lat, 50)) if lat else 0.0
            ),
            "admit_latency_p99_s": (
                float(np.percentile(lat, 99)) if lat else 0.0
            ),
            # end-to-end latency split: queue wait (submit -> drain picks
            # the ticket up) vs service (apply + covering flush) — a warm
            # precompile cache shows up as a smaller service tail only
            "queue_wait_p50_s": wait_p50,
            "queue_wait_p99_s": wait_p99,
            "service_p50_s": service_p50,
            "service_p99_s": service_p99,
        }
        if self.precompile is not None:
            stats["precompile"] = self.precompile.stats()
        return stats
