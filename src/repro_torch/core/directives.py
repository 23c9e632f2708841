"""Runtime directive (hint) interface — paper §3.4, Table 1.

Directives let developers declare execution properties the runtime exploits:
batching, statefulness, preemptability, instance bounds, resource demands.

Constraint from §5 (Discussion): managed state cannot be combined with
batchable agents — batching aggregates requests across sessions, making state
attribution impossible.  ``validate()`` enforces it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional


@dataclass
class Directives:
    # True: successive calls of one session route to the same instance, and
    # sessions are never migrated (§5: stricter than managed-state sessions,
    # which may migrate *with* their state).
    stateful: bool = False
    # True: the module accepts a batch of requests.
    batchable: bool = False
    max_batch: int = 8
    # Name of a preemption hook; None means not preemptable.
    preemptable: Optional[Callable] = None
    max_instances: int = 8
    min_instances: int = 1
    # {"GPU": n, "CPU": n, "MEM": gb} per instance.
    resources: Dict[str, float] = field(default_factory=dict)
    # Does this agent keep managed (session) state?  Set automatically when the
    # agent code touches managedList/managedDict; may also be declared.
    uses_managed_state: bool = False
    # ---- failure handling (the retry ladder) --------------------------------
    # Max *local* retries per future: the component controller re-executes a
    # failed attempt in place (state epoch rolled back first) with exponential
    # backoff.  After the budget is exhausted — or immediately when the
    # instance died — the failure escalates to the global controller's
    # RetryPolicy, which reroutes to a surviving replica.  0 = fail fast.
    # A per-call ``_hint={"retry": n}`` overrides this budget.
    max_retries: int = 0
    # Which errors are worth retrying: bool, or a predicate over the raised
    # exception.  Cancellations are never retried regardless.
    retryable: Any = True
    # Base backoff in (virtual) seconds; attempt k waits backoff * 2^k.
    retry_backoff: float = 0.05
    # ---- latency-fault handling ---------------------------------------------
    # Per-call deadline budget in (kernel) seconds: every future of this agent
    # gets an absolute deadline of create-time + deadline_s, and child calls
    # inherit the parent's *remaining* budget (the effective deadline is the
    # min of the inherited one and this budget).  Expired futures fail with a
    # non-retryable DeadlineExceeded.  A per-call ``_hint={"deadline_s": x}``
    # overrides this budget.  None = no deadline.
    deadline_s: Optional[float] = None

    def validate(self) -> None:
        if self.batchable and self.uses_managed_state:
            raise ValueError(
                "directive conflict: managed state cannot be combined with "
                "batchable agents (paper §5) — batching mixes sessions, making "
                "state attribution impossible")
        if self.min_instances > self.max_instances:
            raise ValueError("min_instances > max_instances")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.retry_backoff < 0:
            raise ValueError("retry_backoff must be >= 0")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 when set")

    def merged(self, **overrides) -> "Directives":
        d = Directives(**{**self.__dict__, **overrides})
        d.validate()
        return d
