"""Auto-generated stubs: the conduit between user programs and NALAR (§3.1).

Before deployment, developers run the stub-generation tool on each agent or
tool with a short declaration (agent name, callable functions, parameters).
The generated module's methods do not execute the underlying logic; they
create and return *futures* carrying the call's metadata, which the runtime
schedules, routes, and monitors.

Two entry points:

* ``AgentSpec`` + ``generate_stub`` — programmatic declaration (what the YAML
  tool would emit);
* ``parse_spec`` — a minimal parser for the paper's YAML declaration format
  (PyYAML-free; the declarations are flat).

Stub calls strip an optional ``_hint`` kwarg ({"in_tokens", "out_tokens",
"est_service", "graph_depth", "retry", "max_retries", "deadline_s", ...})
used by cost models and scheduling policies — never seen by user code.  Two hints feed
the runtime's retry ladder: ``"max_retries"`` is the explicit per-call
budget (overrides the agent directive; 0 disables retries for this call),
and a *truthy* ``"retry"`` doubles as the budget for convenience —
``{"retry": 0}`` stays a pure scheduling signal (LPT re-entrance for
driver-managed retry loops) and leaves the directive in force.

Streaming hints: ``"stream_min_tokens": n`` declares the call can start on
partial input — the controller dispatches it as soon as every Future
dependency has streamed ≥ n tokens (the dep substitutes its ``partial()``
token snapshot; a dep that resolves first substitutes its value as usual).
``"session_id"`` overrides the context session for this one call, detaching
it from the caller's per-session ordering — a pipelined side-step (e.g. a
classifier racing its upstream generator) must not queue behind the very
call it consumes partial output from.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .directives import Directives
from .executor import EmulatedMethod
from .future import Future, FutureMetadata, extract_dependencies
from .session import get_context, get_current_deadline


@dataclass
class AgentSpec:
    """What the YAML declaration describes."""

    name: str
    # method name -> EmulatedMethod (leaf) | Python callable (composite)
    methods: Dict[str, Any] = field(default_factory=dict)
    directives: Directives = field(default_factory=Directives)

    def validate(self) -> None:
        if not self.name or not self.methods:
            raise ValueError("agent spec needs a name and >=1 callable function")
        self.directives.validate()


def parse_spec(text: str, impls: Dict[str, Any]) -> AgentSpec:
    """Parse the flat YAML declaration the stub tool consumes.

    Example::

        name: developer
        functions:
          - implement_and_test
          - review
        batchable: true
        max_instances: 4

    ``impls`` maps function names to their implementations (the tool links
    them at deployment; here they're passed directly).
    """
    name = ""
    functions: List[str] = []
    d = Directives()
    in_functions = False
    for raw in text.splitlines():
        line = raw.rstrip()
        if not line or line.lstrip().startswith("#"):
            continue
        stripped = line.strip()
        if in_functions and stripped.startswith("- "):
            functions.append(stripped[2:].strip())
            continue
        in_functions = False
        if ":" not in stripped:
            raise ValueError(f"bad spec line: {raw!r}")
        key, _, val = stripped.partition(":")
        key, val = key.strip(), val.strip()
        if key == "name":
            name = val
        elif key == "functions":
            in_functions = True
        elif key in ("stateful", "batchable"):
            setattr(d, key, val.lower() in ("true", "1", "yes"))
        elif key in ("max_instances", "min_instances", "max_batch",
                     "max_retries"):
            setattr(d, key, int(val))
        elif key == "retry_backoff":
            d.retry_backoff = float(val)
        elif key == "resources":
            # "GPU=2,CPU=1"
            d.resources = {k: float(v) for k, v in
                           (kv.split("=") for kv in val.split(",") if kv)}
    missing = [f for f in functions if f not in impls]
    if missing:
        raise ValueError(f"no implementation linked for: {missing}")
    return AgentSpec(name=name,
                     methods={f: impls[f] for f in functions},
                     directives=d)


class Stub:
    """The importable module the stub tool generates for one agent/tool.

    Methods mirror the declared functions; each call creates a future, routes
    it via the caller's component controller, and returns immediately.
    """

    def __init__(self, runtime, spec: AgentSpec) -> None:
        self._runtime = runtime
        self._spec = spec
        for m in spec.methods:
            setattr(self, m, self._make_method(m))

    @property
    def agent_type(self) -> str:
        return self._spec.name

    def init(self, **directive_overrides) -> None:
        """Runtime directives at deployment time (Fig. 4 lines 6-7)."""
        self._runtime.apply_directives(self._spec.name, directive_overrides)

    def _make_method(self, method: str) -> Callable[..., Future]:
        def call(*args, **kwargs) -> Future:
            hint = kwargs.pop("_hint", {}) or {}
            sid, rid, caller = get_context()
            if hint.get("session_id") is not None:
                sid = str(hint["session_id"])
            rt = self._runtime
            now = rt.kernel.now()
            sess = rt.sessions.get(sid)
            prio = sess.priority_for(self._spec.name) if sess else 0.0
            # effective deadline = min(own budget, caller's remaining budget).
            # The inherited deadline is already absolute (the parent's), so a
            # child can never outlive its parent's budget; a tighter per-call
            # ``deadline_s`` (hint or directive) shrinks it further.
            budget = hint.get("deadline_s", self._spec.directives.deadline_s)
            deadline = get_current_deadline()
            if budget is not None and budget >= 0:
                own = now + float(budget)
                deadline = own if deadline < 0 else min(deadline, own)
            meta = FutureMetadata(
                dependencies=extract_dependencies(args, kwargs),
                creator=caller,
                session_id=sid,
                request_id=rid,
                agent_type=self._spec.name,
                method=method,
                priority=prio,
                deadline=deadline,
                created_at=now,
                work_hint=dict(hint),
            )
            fut = Future(rt, meta, args, kwargs)
            rt.add_future(fut)
            rt.dispatch(fut)
            return fut

        call.__name__ = method
        return call

    def __repr__(self) -> str:  # pragma: no cover
        return f"Stub({self._spec.name}, methods={list(self._spec.methods)})"


def emulated(latency, value_fn: Optional[Callable] = None) -> EmulatedMethod:
    """Shorthand for declaring a leaf method."""
    return EmulatedMethod(latency=latency, value_fn=value_fn)
