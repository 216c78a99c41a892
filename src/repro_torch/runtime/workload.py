"""The ``Workload`` protocol and its adapters.

A workload is anything that accepts requests and makes progress when the
cluster grants it active units. The runtime drives every workload through
the same four calls:

  * ``submit(request) -> rid``   — enqueue work;
  * ``step(n_active_units, dt_s, t) -> StepStats`` — advance one tick
    using *at most* the granted concurrency (this is where the activation
    target actually gates execution). Adapters may additionally accept a
    ``perf_scale=`` keyword (the runtime passes the tenant's mean DVFS
    perf multiplier when the workload's ``step`` signature declares it);
  * ``drain() -> [Response]``    — pop completed responses. This is the
    **single delivery channel**: every response is returned by drain()
    exactly once, and the runtime folds exactly that into
    ``Telemetry.responses``. ``StepStats.responses`` is an observational
    per-tick view of the same objects, never a second delivery path;
  * ``describe() -> dict``       — static metadata (name, unit_rate, ...).

Workloads may additionally expose ``oldest_waiting_s(t) -> float | None``
(the queue-age of the oldest waiting request); the runtime uses it for
straggler hedging (paper §5.2) — a tenant whose oldest request has waited
past ``ScalePolicy.hedge_after_s`` borrows an extra unit for the tick.

Adapters:

  * :class:`LMServingWorkload` — the live continuous-batching LM engine
    (``ServingEngine`` + ``ContinuousBatcher``); active units map to
    decode slots, so gating really limits concurrency.
  * :class:`DLServingWorkload` — DL inference serving from the paper's
    measured per-SoC rates (Fig 11/12, Table 7), as a fluid queue.
  * :class:`TranscodingWorkload` — live video transcoding from the
    paper's Table 3 per-SoC stream counts (§4), as a fluid queue.
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import (Any, Deque, Dict, List, Optional, Protocol,
                    runtime_checkable)

from repro_torch.runtime.result import Request, Response, StepStats


@runtime_checkable
class Workload(Protocol):
    """Structural protocol every runtime workload satisfies."""

    def submit(self, request: Request) -> int:
        ...

    def step(self, n_active_units: int, dt_s: float = 1.0,
             t: float = 0.0) -> StepStats:
        ...

    def drain(self) -> List[Response]:
        ...

    def describe(self) -> Dict[str, Any]:
        ...


# ---------------------------------------------------------------------------
# Fluid-queue workloads (model-driven: DL serving points, transcoding).
# ---------------------------------------------------------------------------
class QueueWorkload:
    """FIFO fluid queue: each active unit processes ``unit_rate`` cost
    units per second. Requests may carry fractional/aggregated cost (e.g.
    one request per trace tick with ``cost = rate * dt``), in which case
    ``work_done`` counts request-equivalents rather than completions.
    """

    def __init__(self, unit_rate: float, name: str = "queue",
                 kind: str = "fluid") -> None:
        assert unit_rate > 0, "unit_rate must be positive"
        self.unit_rate = unit_rate
        self.name = name
        self.kind = kind
        self._rid = itertools.count()
        # O(1) FIFO: head pops are popleft, not list.pop(0)
        self._queue: Deque[List[Any]] = deque()  # [request, remaining_cost]
        self._completed: List[Response] = []

    # -- protocol ----------------------------------------------------------
    def submit(self, request: Request) -> int:
        rid = next(self._rid)
        request.rid = rid
        if request.arrival_s is None:
            request.arrival_s = 0.0
        self._queue.append([request, float(request.cost)])
        return rid

    def _drain_tick(self, n_active_units: int, dt_s: float, t: float,
                    perf_scale: float) -> "tuple[float, float, int, int]":
        """One tick of the fluid FIFO drain — the single copy of the
        arithmetic behind both :meth:`step` and :meth:`step_fast`.
        Completed responses are appended to the :meth:`drain` channel;
        returns ``(work_done, utilization, queued, concurrency)``."""
        capacity = max(0, n_active_units) * self.unit_rate * dt_s \
            * max(perf_scale, 0.0)
        used = 0.0
        touched = 0
        queue = self._queue
        while queue and used < capacity:
            req, remaining = queue[0]
            take = min(remaining, capacity - used)
            used += take
            touched += 1
            if take >= remaining - 1e-12:
                queue.popleft()
                # finish inside the tick, at the fluid completion instant
                # (floored at one service time past arrival — at the
                # *effective* DVFS-scaled rate — latency for fluid
                # workloads has tick resolution, no better)
                frac = used / capacity if capacity > 0 else 1.0
                service_s = 1.0 / (self.unit_rate
                                   * max(perf_scale, 1e-9))
                self._completed.append(Response(
                    rid=req.rid, arrival_s=req.arrival_s,
                    finish_s=max(t + frac * dt_s,
                                 req.arrival_s + service_s),
                    output=req.payload))
            else:
                queue[0][1] = remaining - take
                break
        return (used, used / capacity if capacity > 0 else 0.0,
                len(queue), touched)

    def step(self, n_active_units: int, dt_s: float = 1.0,
             t: float = 0.0, perf_scale: float = 1.0) -> StepStats:
        before = len(self._completed)
        used, util, queued, touched = self._drain_tick(
            n_active_units, dt_s, t, perf_scale)
        responses = self._completed[before:]
        return StepStats(
            t=t, dt_s=dt_s,
            concurrency=touched,
            admitted=0,
            completed=len(responses),
            queued=queued,
            work_done=used,
            utilization=util,
            responses=responses,
        )

    def step_fast(self, n_active_units: int, dt_s: float = 1.0,
                  t: float = 0.0, perf_scale: float = 1.0
                  ) -> "tuple[float, float, int, int]":
        """Allocation-light twin of :meth:`step` for hot loops (the
        vectorized fleet engine calls it ~100k times per sweep): the
        same :meth:`_drain_tick` core, but no :class:`StepStats` —
        returns the plain ``(work_done, utilization, queued,
        concurrency)`` tuple. ``perf_scale`` is the tenant's mean DVFS
        perf multiplier, exactly as ``step`` takes it. Completed
        responses land in the :meth:`drain` channel as with ``step``."""
        return self._drain_tick(n_active_units, dt_s, t, perf_scale)

    def drain(self) -> List[Response]:
        out, self._completed = self._completed, []
        return out

    def describe(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind,
                "unit_rate": self.unit_rate}

    def oldest_waiting_s(self, t: float) -> Optional[float]:
        """Queue-age of the head request (None when the queue is empty);
        feeds the runtime's straggler-hedging decision."""
        if not self._queue:
            return None
        arrival = self._queue[0][0].arrival_s
        return max(0.0, t - (arrival or 0.0))

    def expire(self, now: float, deadline_s: float) -> "tuple[int, float]":
        """Deadline-aware load shedding (``repro_torch.fleet.degrade``):
        abandon queued requests whose arrival is ``deadline_s`` or more
        in the past, returning ``(n_requests, remaining_cost)``. The
        queue is FIFO by arrival, so expiry only ever pops from the
        head; a partially-drained head is popped too — its remainder
        is voided (the drained part stays counted as served). No
        :class:`Response` is emitted: like :meth:`evacuate`, the fleet
        layer owns the accounting. The cost sum is an explicit
        left-to-right loop so both fleet engines (which share this
        queue class) expire bitwise-identical totals."""
        cutoff = now - deadline_s + 1e-9
        n = 0
        cost = 0.0
        queue = self._queue
        while queue and (queue[0][0].arrival_s or 0.0) <= cutoff:
            _req, rem = queue.popleft()
            n += 1
            cost += rem
        return n, cost

    def evacuate(self) -> "tuple[int, float]":
        """Chaos full-rack kill: discard every queued request, returning
        ``(n_requests, remaining_cost)``. No :class:`Response` is
        emitted — the requests never complete here; the fleet layer
        decides whether their cost is respilled through the router or
        dropped (``repro_torch.fleet.chaos``). The cost sum is an explicit
        left-to-right loop so both fleet engines (which share this
        queue class) evacuate bitwise-identical totals."""
        n = len(self._queue)
        cost = 0.0
        for _req, rem in self._queue:
            cost += rem
        self._queue.clear()
        return n, cost

    # -- helpers -----------------------------------------------------------
    @property
    def pending_cost(self) -> float:
        return sum(rem for _, rem in self._queue)

    def idle(self) -> bool:
        return not self._queue


class DLServingWorkload(QueueWorkload):
    """DL inference serving (paper §5, Fig 11/12): each active unit serves
    ``unit_rate`` samples/s, taken from a measured
    :class:`~repro_torch.workloads.dlserving.ServingPoint` or given directly.
    Request cost is a sample count.
    """

    def __init__(self, unit_rate: float, model: str = "custom",
                 precision: str = "fp32", platform: str = "custom",
                 unit_power_w: Optional[float] = None) -> None:
        super().__init__(unit_rate, name=f"dlserving/{model}",
                         kind="dl-serving")
        self.model = model
        self.precision = precision
        self.platform = platform
        self.unit_power_w = unit_power_w

    @classmethod
    def from_point(cls, model: str, precision: str, platform: str
                   ) -> "DLServingWorkload":
        from repro_torch.workloads.dlserving import point
        p = point(model, precision, platform)
        if p is None:
            raise KeyError(f"no serving point for "
                           f"({model}, {precision}, {platform})")
        return cls(unit_rate=1000.0 / p.latency_ms * p.batch, model=model,
                   precision=precision, platform=platform,
                   unit_power_w=p.unit_power_w)

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d.update(model=self.model, precision=self.precision,
                 platform=self.platform, unit_power_w=self.unit_power_w)
        return d


class TranscodingWorkload(QueueWorkload):
    """Live video transcoding (paper §4, Table 3): each active SoC
    sustains ``streams_per_unit`` simultaneous live streams, i.e. it
    produces ``streams_per_unit`` stream-seconds of output per second.
    Request cost is stream-seconds (``streams * duration_s``).
    """

    def __init__(self, video: Any = None, hw_codec: bool = False,
                 streams_per_unit: Optional[float] = None) -> None:
        if streams_per_unit is None:
            assert video is not None, "need a Video or streams_per_unit"
            streams_per_unit = (video.soc_hw_streams if hw_codec
                                else video.soc_cpu_streams)
        vid = getattr(video, "vid", "custom")
        super().__init__(float(streams_per_unit),
                         name=f"transcoding/{vid}", kind="transcoding")
        self.video = video
        self.hw_codec = hw_codec

    def submit_stream(self, duration_s: float, streams: int = 1,
                      arrival_s: float = 0.0) -> int:
        """Convenience: enqueue a live stream of ``duration_s`` seconds."""
        return self.submit(Request(payload=self.video,
                                   cost=float(streams) * duration_s,
                                   arrival_s=arrival_s))

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d.update(video=getattr(self.video, "vid", None),
                 hw_codec=self.hw_codec)
        return d


# ---------------------------------------------------------------------------
# Live LM serving (engine + continuous batcher).
# ---------------------------------------------------------------------------
class LMServingWorkload:
    """Continuous-batched LM generation behind the workload protocol.

    Active units map to decode slots (``slots_per_unit`` each): the
    runtime's activation target becomes a hard cap on how many slots the
    batcher may fill, so scaling down genuinely reduces concurrency
    instead of being accounting-only (the seed repo's dead-code path).
    """

    def __init__(self, engine: Any, slots: int, slots_per_unit: int = 1,
                 max_new_tokens: int = 16) -> None:
        from repro_torch.serving.batcher import ContinuousBatcher
        self.engine = engine
        self.batcher = ContinuousBatcher(engine, slots=slots)
        self.slots_per_unit = max(1, int(slots_per_unit))
        self.max_new_tokens = max_new_tokens
        self._requests: Dict[int, Request] = {}
        self._completed: List[Response] = []
        self._tokens_done = 0

    # -- protocol ----------------------------------------------------------
    def submit(self, request: Request) -> int:
        mnt = int(request.meta.get("max_new_tokens", self.max_new_tokens))
        rid = self.batcher.submit(request.payload, max_new_tokens=mnt)
        request.rid = rid
        if request.arrival_s is None:
            request.arrival_s = 0.0
        self._requests[rid] = request
        return rid

    def step(self, n_active_units: int, dt_s: float = 1.0,
             t: float = 0.0, perf_scale: float = 1.0) -> StepStats:
        # perf_scale is accepted for protocol uniformity but unused: the
        # live batcher is slot-gated (one decode step per tick); DVFS
        # would change wall-clock per token, which the fluid tick model
        # does not resolve
        cap = min(self.batcher.slots,
                  max(0, n_active_units) * self.slots_per_unit)
        queued_before = len(self.batcher.queue)
        live = self.batcher.step(max_slots=cap)
        admitted = queued_before - len(self.batcher.queue)
        # in-flight requests keep their slots through a scale-down, so the
        # occupied-unit count can transiently exceed the granted target
        units_used = -(-live // self.slots_per_unit)  # ceil
        powered = max(max(0, n_active_units), units_used)
        responses: List[Response] = []
        # consume the batcher's finished list destructively so a long-
        # running serving loop doesn't retain every completed request
        done, self.batcher.finished = self.batcher.finished, []
        for breq in done:
            self._tokens_done += len(breq.generated)
            req = self._requests.pop(breq.rid,
                                     Request(arrival_s=t, rid=breq.rid))
            responses.append(Response(
                rid=breq.rid, arrival_s=req.arrival_s, finish_s=t + dt_s,
                output=list(breq.generated)))
        self._completed.extend(responses)
        return StepStats(
            t=t, dt_s=dt_s,
            concurrency=live,
            admitted=admitted,
            completed=len(responses),
            queued=len(self.batcher.queue),
            work_done=float(len(responses)),
            utilization=live / (powered * self.slots_per_unit)
            if powered > 0 else 0.0,
            units_used=units_used,
            responses=responses,
        )

    def drain(self) -> List[Response]:
        out, self._completed = self._completed, []
        return out

    def oldest_waiting_s(self, t: float) -> Optional[float]:
        """Queue-age of the oldest request still waiting for a decode
        slot (None when none queue); feeds straggler hedging."""
        if not self.batcher.queue:
            return None
        src = self._requests.get(self.batcher.queue[0].rid)
        if src is None or src.arrival_s is None:
            return None
        return max(0.0, t - src.arrival_s)

    def max_useful_units(self) -> int:
        """Beyond this many units the slot cap binds — granting (or
        hedging) more adds no concurrency, only powered silicon."""
        return -(-self.batcher.slots // self.slots_per_unit)

    def describe(self) -> Dict[str, Any]:
        return {"name": f"lm-serving/{self.engine.cfg.name}",
                "kind": "lm-serving",
                "slots": self.batcher.slots,
                "slots_per_unit": self.slots_per_unit,
                "arch": self.engine.cfg.name,
                "quantized": self.engine.scfg.quantize_weights}

    # -- helpers -----------------------------------------------------------
    def idle(self) -> bool:
        return (not self.batcher.queue
                and all(a is None for a in self.batcher.active))

    @property
    def tokens_generated(self) -> int:
        return self._tokens_done \
            + sum(len(r.generated) for r in self.batcher.finished) \
            + sum(len(r.generated) for r in self.batcher.active
                  if r is not None)
