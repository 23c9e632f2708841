"""Continuous-batching scheduler for the inference engine (the port's own
copy of the JAX package's ``serving/batching.py``).

Admission: priority first, then FCFS (NALAR's local controllers can reorder
by installing a different comparator — the same LocalSchedule idea applied
to the engine's waiting queue).  The wait queue is a binary heap (O(log n)
push/pop instead of the seed's O(n) scan) and can be *bounded*: a full
queue rejects the submission with :class:`EngineOverloaded`, which the
engine bridge propagates as a retryable failure into the runtime's retry
ladder — backpressure instead of unbounded queue growth, the baseline
failure mode the paper's serving claims are measured against.

Prompt lengths are padded to power-of-two buckets so monolithic prefill
compiles a bounded set of shapes (the chunked-prefill path feeds exact
tokens through the decode step and needs no buckets).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from dataclasses import dataclass, field
from time import monotonic as _monotonic
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .sampler import SamplingParams

_req_ids = itertools.count()


class EngineOverloaded(RuntimeError):
    """Admission rejected: the engine's bounded wait queue is at capacity.

    Retryable by design — the component controller's retry ladder backs off
    and re-submits, and on budget exhaustion the global RetryPolicy reroutes
    the future to a less-loaded replica.
    """


class RequestExpired(RuntimeError):
    """Admission rejected: the request's deadline already passed.

    Distinct from :class:`EngineOverloaded` so callers can tell backpressure
    from deadline misses.  Retryable at the engine layer (another replica
    might still race the deadline after clock skew), but the NALAR bridge
    converts it into the runtime's non-retryable ``DeadlineExceeded`` —
    expired agent work is worthless and must not burn retry budget.
    """


@dataclass
class Request:
    request_id: str
    session_id: str
    prompt: np.ndarray                       # [S] int32
    sampling: SamplingParams
    extras: Dict[str, np.ndarray] = field(default_factory=dict)
    priority: float = 0.0
    submitted_at: float = 0.0
    # Full-context prompt to prefill if the session's KV cache turns out to
    # be cold at admission (evicted/migrated since the caller checked).  Set
    # by the NALAR engine bridge when ``prompt`` is only the continuation
    # suffix of a longer transcript.
    fallback_prompt: Optional[np.ndarray] = None
    # absolute wall-clock (time.monotonic) deadline; -1.0 = none.  Enforced
    # at admission (push + pop) and mid-decode by the step loop, which
    # preempts the slot and reclaims its KV pages.
    deadline_wall: float = -1.0
    # filled during execution
    generated: List[int] = field(default_factory=list)
    finished: bool = False
    # the request was preempted/rejected because its deadline passed
    expired: bool = False
    # wall-clock (time.monotonic) stamps taken by the engine itself, so TTFT
    # is measured on one clock regardless of which kernel created the request
    submitted_wall: float = -1.0
    first_token_at: float = -1.0
    finished_at: float = -1.0
    prefix_reused_tokens: int = 0
    # execution path the engine admitted this request onto ("paged" /
    # "fused" / "masked") — observability for tests and benchmarks that
    # must assert which data plane actually served them
    decode_path: str = ""
    # tokens already emitted as stream chunks (prefix length of
    # ``generated``); maintained by the engine's step loop so each drain
    # delivers exactly the tokens appended since the previous one
    streamed: int = 0

    @staticmethod
    def make(prompt, session_id: str = "", sampling: Optional[SamplingParams] = None,
             priority: float = 0.0, now: float = 0.0,
             fallback_prompt=None, deadline_wall: float = -1.0,
             **extras) -> "Request":
        return Request(
            request_id=f"req{next(_req_ids)}",
            session_id=session_id or f"sess-req{next(_req_ids)}",
            prompt=np.asarray(prompt, np.int32),
            sampling=sampling or SamplingParams(),
            extras={k: np.asarray(v) for k, v in extras.items()},
            priority=priority,
            submitted_at=now,
            fallback_prompt=(None if fallback_prompt is None
                             else np.asarray(fallback_prompt, np.int32)),
            deadline_wall=deadline_wall,
        )


def bucket_len(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class WaitQueue:
    """Heap-ordered admission queue, optionally bounded.

    ``order_key(req)`` maps a request to a sort key (smaller pops first);
    the key is evaluated at push time, so installing a new comparator
    reorders future pushes only.  ``maxsize == 0`` means unbounded (the
    seed behaviour); a bounded queue raises :class:`EngineOverloaded` on
    overflow and counts the rejection.
    """

    def __init__(self, maxsize: int = 0) -> None:
        self._lock = threading.Lock()
        self._heap: List[tuple] = []
        self._seq = itertools.count()          # FIFO tie-break, stable heap
        self.maxsize = int(maxsize)
        self.rejected = 0
        self.expired_rejects = 0
        # wall clock for deadline checks; swappable for deterministic tests
        self.clock: Callable[[], float] = _monotonic
        self.order_key: Callable[[Request], Any] = (
            lambda r: (-r.priority, r.submitted_at))

    def push(self, req: Request) -> None:
        with self._lock:
            if 0 <= req.deadline_wall <= self.clock():
                self.expired_rejects += 1
                req.expired = True
                raise RequestExpired(
                    f"request {req.request_id} deadline passed before "
                    f"admission")
            if self.maxsize and len(self._heap) >= self.maxsize:
                self.rejected += 1
                raise EngineOverloaded(
                    f"engine wait queue full ({len(self._heap)}/"
                    f"{self.maxsize}); shed or retry elsewhere")
            heapq.heappush(self._heap, (self.order_key(req), next(self._seq),
                                        req))

    def pop_next(self) -> Optional[Request]:
        with self._lock:
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def remove(self, request_id: str) -> Optional[Request]:
        """Withdraw one waiting request by id (hedge-loser cancellation).
        O(n) scan + heapify — cancellation is rare by construction (hedge
        budget caps it), so simplicity beats an index here."""
        with self._lock:
            for idx, entry in enumerate(self._heap):
                if entry[2].request_id == request_id:
                    self._heap[idx] = self._heap[-1]
                    self._heap.pop()
                    heapq.heapify(self._heap)
                    return entry[2]
        return None

    def clear(self) -> int:
        with self._lock:
            n = len(self._heap)
            self._heap.clear()
            return n

    def saturation(self) -> float:
        """Queue depth as a fraction of capacity (0.0 when unbounded)."""
        with self._lock:
            if not self.maxsize:
                return 0.0
            return len(self._heap) / float(self.maxsize)

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)
