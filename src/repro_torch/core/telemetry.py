"""Per-session/per-request telemetry and introspective debugging (paper §5).

NALAR has complete visibility into inter-agent calls, so it keeps detailed
per-session logs: time in each stage, agents/tools touched per node, failures
with workflow path + traceback.  The benchmark harness reads request records
to compute the latency distributions of Fig. 9.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class FutureRecord:
    fid: str
    agent_type: str
    method: str
    session_id: str
    request_id: str
    created_at: float
    scheduled_at: float
    started_at: float
    ready_at: float
    executor: str
    failed: bool
    cancelled: bool = False
    # which attempt resolved the future (0 = first execution; >0 means the
    # retry ladder re-dispatched it — rendered as ``retry#n`` in traces)
    attempt: int = 0

    @property
    def queue_time(self) -> float:
        return max(0.0, self.started_at - self.created_at)

    @property
    def service_time(self) -> float:
        return max(0.0, self.ready_at - self.started_at)


@dataclass
class RequestRecord:
    request_id: str
    session_id: str
    submitted_at: float
    finished_at: float = -1.0
    failed: bool = False
    # end-to-end budget the request was submitted with (-1 = none) and the
    # real outcome: the driver failed DeadlineExceeded, or completed after
    # the budget ran out.  Benchmarks report this instead of inferring
    # "unfinished == timed out".
    deadline_s: float = -1.0
    deadline_exceeded: bool = False
    # when the request's FIRST streamed chunk reached a future (-1 = the
    # request never streamed).  Workload-level TTFT: engines stamp their own
    # per-request first_token_at, but that never left per-engine metrics.
    first_output_at: float = -1.0
    stages: List[FutureRecord] = field(default_factory=list)

    @property
    def latency(self) -> float:
        return self.finished_at - self.submitted_at if self.finished_at >= 0 else -1.0

    @property
    def ttft(self) -> float:
        return (self.first_output_at - self.submitted_at
                if self.first_output_at >= 0 else -1.0)


@dataclass
class MigrationRecord:
    fid: str
    src: str
    dst: str
    at: float


@dataclass
class ControlRoundRecord:
    """One global-controller round: wall-clock breakdown plus how much state
    actually moved (``n_collected`` — the churn a delta round paid for) and
    whether the round was a full view rebuild (bootstrap / escape hatch)."""

    at: float                 # virtual time of the round
    collect: float            # wall-clock seconds
    policy: float
    push: float
    n_collected: int
    rebuild: bool

    @property
    def total(self) -> float:
        return self.collect + self.policy + self.push


class Telemetry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.requests: Dict[str, RequestRecord] = {}
        self.migrations: List[MigrationRecord] = []
        # bounded: a long-lived deployment ticks forever (interval=0.25s ->
        # ~345K rounds/day); keep a rolling window, like the FutureTable
        # keeps the deployment memory-flat
        self.control_rounds: "deque[ControlRoundRecord]" = deque(maxlen=4096)
        self.futures_done = 0

    def start_request(self, request_id: str, session_id: str, now: float,
                      deadline_s: float = -1.0) -> None:
        with self._lock:
            self.requests[request_id] = RequestRecord(
                request_id, session_id, now, deadline_s=deadline_s)

    def end_request(self, request_id: str, now: float, failed: bool = False,
                    deadline_exceeded: bool = False) -> None:
        with self._lock:
            r = self.requests.get(request_id)
            if r is not None:
                r.finished_at = now
                r.failed = failed
                r.deadline_exceeded = deadline_exceeded

    def on_first_output(self, request_id: str, now: float) -> None:
        """Stamp TTFT from the first streamed chunk (idempotent: only the
        earliest stamp sticks — later chunks and hedge duplicates no-op)."""
        with self._lock:
            r = self.requests.get(request_id)
            if r is not None and r.first_output_at < 0:
                r.first_output_at = now

    def deadline_outcomes(self) -> Dict[str, float]:
        """Real per-request deadline accounting: requests submitted with a
        budget, how many missed it (failed DeadlineExceeded or finished
        late), how many never finished at all — plus workload-level TTFT
        percentiles from the streamed first-chunk stamps."""
        with self._lock:
            recs = list(self.requests.values())
        with_deadline = [r for r in recs if r.deadline_s >= 0]
        ttfts = sorted(r.ttft for r in recs if r.first_output_at >= 0)

        def pct(p: float) -> float:
            if not ttfts:
                return float("nan")
            return ttfts[min(len(ttfts) - 1,
                             int(round(p / 100.0 * (len(ttfts) - 1))))]

        return {
            "requests": len(recs),
            "with_deadline": len(with_deadline),
            "deadline_missed": sum(r.deadline_exceeded for r in recs),
            "unfinished": sum(r.finished_at < 0 for r in recs),
            "ttft_n": len(ttfts),
            "ttft_p50": pct(50),
            "ttft_p99": pct(99),
        }

    def on_future_done(self, fut, inst, now: float) -> None:
        rec = FutureRecord(
            fid=fut.fid, agent_type=fut.meta.agent_type, method=fut.meta.method,
            session_id=fut.meta.session_id, request_id=fut.meta.request_id,
            created_at=fut.meta.created_at, scheduled_at=fut.meta.scheduled_at,
            started_at=fut.meta.started_at, ready_at=now,
            executor=fut.meta.executor, failed=fut.state.value == "failed",
            cancelled=fut.state.value == "cancelled",
            attempt=fut.meta.attempt)
        with self._lock:
            self.futures_done += 1
            r = self.requests.get(fut.meta.request_id)
            if r is not None:
                r.stages.append(rec)

    def on_migration(self, fut, src: str, dst: str, now: float) -> None:
        with self._lock:
            self.migrations.append(MigrationRecord(fut.fid, src, dst, now))

    def on_control_round(self, at: float, collect: float, policy: float,
                         push: float, n_collected: int,
                         rebuild: bool) -> None:
        with self._lock:
            self.control_rounds.append(ControlRoundRecord(
                at, collect, policy, push, n_collected, rebuild))

    def control_summary(self) -> Dict[str, float]:
        """Mean per-stage wall-clock of the control loop (Fig. 10 shape)."""
        with self._lock:
            rounds = list(self.control_rounds)
        if not rounds:
            return {"rounds": 0}
        n = len(rounds)
        return {
            "rounds": n,
            "rebuilds": sum(r.rebuild for r in rounds),
            "collect_ms": 1e3 * sum(r.collect for r in rounds) / n,
            "policy_ms": 1e3 * sum(r.policy for r in rounds) / n,
            "push_ms": 1e3 * sum(r.push for r in rounds) / n,
            "mean_collected": sum(r.n_collected for r in rounds) / n,
        }

    # ------------------------------------------------------------- analysis
    def completed_latencies(self) -> List[float]:
        with self._lock:
            return sorted(r.latency for r in self.requests.values()
                          if r.finished_at >= 0 and not r.failed)

    def percentile(self, p: float) -> float:
        lat = self.completed_latencies()
        if not lat:
            return float("nan")
        idx = min(len(lat) - 1, int(round(p / 100.0 * (len(lat) - 1))))
        return lat[idx]

    def summary(self) -> Dict[str, float]:
        lat = self.completed_latencies()
        if not lat:
            return {"n": 0}
        return {
            "n": len(lat),
            "avg": sum(lat) / len(lat),
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "max": lat[-1],
            "migrations": len(self.migrations),
        }

    def trace(self, request_id: str) -> Optional[RequestRecord]:
        """Workflow path for one request — the §5 debuggability hook."""
        with self._lock:
            return self.requests.get(request_id)
