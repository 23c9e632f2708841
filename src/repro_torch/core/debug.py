"""Introspective debugging (paper §5).

NALAR has complete visibility into inter-agent calls, so it can render a
request's workflow path — time in each stage, the agent/instance touched,
queue vs service split — and report failures with the full path.  This is
the text form of the visualization tool the paper describes.
"""

from __future__ import annotations

from typing import List, Optional

from .telemetry import RequestRecord, Telemetry


def format_trace(rec: RequestRecord, width: int = 48) -> str:
    """Render one request's workflow path as a timeline."""
    lines = [f"request {rec.request_id} (session {rec.session_id}) — "
             f"{'FAILED' if rec.failed else 'ok'} "
             f"latency={rec.latency:.3f}s"]
    if not rec.stages:
        return lines[0] + "\n  (no stages recorded)"
    t0 = rec.submitted_at
    t1 = max(rec.finished_at, max(s.ready_at for s in rec.stages))
    span = max(t1 - t0, 1e-9)
    for s in sorted(rec.stages, key=lambda s: s.created_at):
        lo = int((s.created_at - t0) / span * width)
        mid = int((max(s.started_at, s.created_at) - t0) / span * width)
        hi = int((s.ready_at - t0) / span * width)
        bar = (" " * lo + "." * max(mid - lo, 0)
               + "#" * max(hi - mid, 1))[:width].ljust(width)
        mark = " "
        if s.failed:
            mark = "!"
        elif getattr(s, "cancelled", False):
            mark = "x"
        retry = (f" retry#{s.attempt}"
                 if getattr(s, "attempt", 0) > 0 else "")
        lines.append(
            f" {mark}[{bar}] {s.agent_type}.{s.method} @ {s.executor} "
            f"queue={s.queue_time:.3f}s service={s.service_time:.3f}s"
            f"{retry}")
    return "\n".join(lines)


def slowest_stage(rec: RequestRecord):
    if not rec.stages:
        return None
    return max(rec.stages, key=lambda s: s.service_time + s.queue_time)


def session_report(telemetry: Telemetry, session_id: str) -> str:
    """Per-session log: every request, stage counts, agents touched."""
    recs = [r for r in telemetry.requests.values()
            if r.session_id == session_id]
    if not recs:
        return f"session {session_id}: no requests"
    lines = [f"session {session_id}: {len(recs)} requests"]
    for r in sorted(recs, key=lambda r: r.submitted_at):
        agents = sorted({s.agent_type for s in r.stages})
        nodes = sorted({s.executor.split(":")[-1].split("/")[0]
                        for s in r.stages if s.executor})
        lines.append(f"  {r.request_id}: latency={r.latency:.3f}s "
                     f"stages={len(r.stages)} agents={','.join(agents)} "
                     f"nodes={','.join(nodes)}"
                     + (" FAILED" if r.failed else ""))
    return "\n".join(lines)


def failure_report(telemetry: Telemetry) -> List[str]:
    """All failed requests with the agent where the failure occurred."""
    out = []
    for r in telemetry.requests.values():
        if not r.failed:
            continue
        failed_stages = [s for s in r.stages if s.failed]
        where = (f"{failed_stages[-1].agent_type} @ "
                 f"{failed_stages[-1].executor}" if failed_stages
                 else "driver")
        out.append(f"{r.request_id} (session {r.session_id}) failed at "
                   f"{where} after {r.latency:.3f}s; path: "
                   + " -> ".join(f"{s.agent_type}.{s.method}"
                                 for s in sorted(r.stages,
                                                 key=lambda s: s.created_at)))
    return out
