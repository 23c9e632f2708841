"""Router-based workflow — the paper's §6 **Fig. 9b** (router serving
benchmark), the port of the JAX package's ``workloads/router.py``.
The HTTP front end over :func:`build_pool_runtime`:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --selftest

A lightweight router classifies each query and forwards it to either a chat
workflow or a coding agent.  Per the Azure LLM traces the paper uses, the
branch mix shifts over time (imbalance can exceed 90%), so a static split
of engines starves one branch while the other idles.  NALAR's resource-
reassignment policy moves GPU capacity between branches; baselines can't,
and their overloaded branch's latency blows up (the paper reports OOM
failures at 70-80 RPS — here the failure mode is unbounded queueing, and we
report a timeout rate).

Three execution modes: :func:`build_runtime` (emulated branch LLMs, virtual
time — the paper's §6.3 methodology), :func:`build_engine_runtime` (branch
LLMs on single real ``InferenceEngine`` instances, wall-clock time), and
:func:`build_pool_runtime` (one LLM agent type backed by an ``EnginePool``
of N real replicas, where global-controller routing/migration actions
resolve to concrete replicas).
"""

from __future__ import annotations

import random
from typing import Dict

import torch

from ..core import (AgentSpec, Directives, FixedLatency, LLMLatency,
                    NalarRuntime, emulated)
from ..core.runtime import current_runtime
from ..device import DeviceLike, resolve_device
from .baselines import SystemConfig


def build_runtime(sys_cfg: SystemConfig, *, n_gpus: int = 8,
                  seed: int = 0) -> NalarRuntime:
    rt = NalarRuntime(
        simulate=True,
        nodes={f"n{i}": {"GPU": 4, "CPU": 32} for i in range(n_gpus // 4)},
        policy=sys_cfg.policy,
        control_interval=sys_cfg.control_interval,
        seed=seed)
    rt.router.mode = sys_cfg.router_mode
    rt.register_agent(AgentSpec(
        name="router",
        methods={"classify": emulated(
            FixedLatency(0.01), lambda q: "code" if "code" in q else "chat")},
        directives=Directives(max_instances=2, resources={"CPU": 1}),
    ), instances=2)
    rt.register_agent(AgentSpec(
        name="chat_llm",
        methods={"generate": emulated(
            LLMLatency(prefill_tps=40000, decode_tps=1800, base=0.015,
                       jitter_sigma=0.1),
            lambda q, **kw: f"chat({q[:16]})")},
        directives=Directives(batchable=True, max_batch=8,
                              max_instances=n_gpus - 1,
                              min_instances=1, resources={"GPU": 1}),
    ), instances=n_gpus // 2)
    rt.register_agent(AgentSpec(
        name="code_llm",
        methods={"generate": emulated(
            LLMLatency(prefill_tps=30000, decode_tps=1500, base=0.02,
                       jitter_sigma=0.1),
            lambda q, **kw: f"code({q[:16]})")},
        directives=Directives(batchable=True, max_batch=8,
                              max_instances=n_gpus - 1,
                              min_instances=1, resources={"GPU": 1}),
    ), instances=n_gpus - n_gpus // 2)
    return rt


def _smoke_model(arch: str, seed: int, device: DeviceLike):
    """The smoke config of ``arch``, its model and params from ``seed``."""
    from ..configs import get_smoke_config
    from ..models import build_model

    model = build_model(get_smoke_config(arch))
    dev = resolve_device(device)
    params = model.init(torch.Generator(device=dev.type).manual_seed(seed),
                        device=dev)
    return model, params


def build_engine_runtime(*, arch: str = "qwen3_0_6b", max_batch: int = 4,
                         max_seq: int = 128, max_new_tokens: int = 8,
                         seed: int = 0,
                         device: DeviceLike = None) -> NalarRuntime:
    """Real-execution variant of :func:`build_runtime`.

    Same workflow topology — a cheap router tool classifies, then a branch
    LLM generates — but the two branch agents execute on actual
    ``repro_torch.serving.InferenceEngine`` instances (reduced model, on
    ``device``: the CUDA card unless the caller names the CPU) through the
    ``EngineMethod`` backend instead of ``LLMLatency`` emulation.
    Requests run in wall-clock time (``simulate=False``); repeated calls in
    one session reuse prefix KV on the engine that holds the session cache.
    """
    from ..serving import InferenceEngine, SamplingParams
    from ..serving.bridge import register_engine_agent

    rt = NalarRuntime(simulate=False,
                      nodes={"n0": {"GPU": 2, "CPU": 8}}, seed=seed)
    rt.register_agent(AgentSpec(
        name="router",
        methods={"classify": emulated(
            FixedLatency(0.001), lambda q: "code" if "code" in q else "chat")},
        directives=Directives(max_instances=2, resources={"CPU": 1}),
    ), instances=1)
    model, params = _smoke_model(arch, seed, device)
    for name in ("chat_llm", "code_llm"):
        engine = InferenceEngine(model, params, max_batch=max_batch,
                                 max_seq=max_seq, device=device)
        register_engine_agent(
            rt, name, engine,
            sampling=SamplingParams(max_new_tokens=max_new_tokens),
            resources={"GPU": 1})
    return rt


def build_pool_runtime(*, replicas: int = 3, arch: str = "qwen3_0_6b",
                       max_batch: int = 4, max_seq: int = 128,
                       max_new_tokens: int = 6, router_mode: str = "least_eta",
                       kv_affinity: bool = True, policy=None,
                       control_interval: float = 0.25,
                       heterogeneous: bool = False,
                       prefill_chunk: int = 8, max_queue: int = 0,
                       max_retries: int = 0, retry_backoff: float = 0.05,
                       prefix_sharing: bool = True,
                       tiers=None, tier_archs=None,
                       draft_layers: int = 0, spec_k: int = 3,
                       decode=None, seed: int = 0,
                       device: DeviceLike = None) -> NalarRuntime:
    """One ``llm`` agent type backed by an ``EnginePool`` of real replicas.

    This is the pooled topology of the migration/routing benchmarks: N
    ``InferenceEngine`` replicas (sharing reduced-model weights, each with
    its own KV pool and pump thread, on ``device``: the CUDA card unless
    the caller names the CPU) are the N instances of one agent type, so
    Router modes (``round_robin`` / ``least_eta``), ``route`` pins from a
    global policy, and ``migrate`` actions all resolve to concrete engines.
    ``kv_affinity=False`` disables the Router's native cache-locality rule —
    the baseline configuration that sprays a session's turns across replicas
    and pays a full-context prefill per turn.  ``heterogeneous=True`` halves
    the last replica's batch width (a deliberately weaker engine) to show
    policies handling non-uniform capacity.

    Data-plane knobs (the sustained-RPS benchmark sweeps these):
    ``prefill_chunk`` — prompt tokens consumed per slot per engine step
    (0 = legacy monolithic bucket prefill); ``max_queue`` — per-replica
    admission bound (0 = unbounded queueing, the baseline collapse mode);
    ``max_retries``/``retry_backoff`` — retry-ladder budget so admission
    rejections back off and reroute instead of failing the request;
    ``prefix_sharing`` — cross-session KV prefix index with copy-on-write
    pages (``False`` = the baseline that re-prefills identical system
    prompts per session).

    Model-tier knobs: ``tiers`` is a per-replica tier label list (``len ==
    replicas``; ``None`` = an untiered pool) and ``tier_archs`` maps a tier
    label to the smoke arch its replicas load (labels absent from the map
    fall back to ``arch``).  Pair with a ``TierRoutePolicy`` and
    ``model_tier`` work hints (see :func:`tiered_driver`).  A tier arch the
    port has not reached raises, naming ROADMAP.md A11; ``draft_layers >
    0`` (a layer-truncated self-draft for speculative decoding) raises,
    naming A9, and so ``spec_k`` is unused until then.
    """
    from ..configs import ARCH_IDS, canonical
    from ..serving import InferenceEngine, SamplingParams
    from ..serving.pool import register_engine_pool

    if draft_layers > 0:
        raise NotImplementedError(
            "speculative decoding (draft_layers) is not ported yet "
            "(ROADMAP.md A9)")
    for a in (tier_archs or {}).values():
        if canonical(a) not in ARCH_IDS:
            raise NotImplementedError(
                f"tier arch {a!r} is not ported yet (ROADMAP.md A11)")
    rt = NalarRuntime(simulate=False,
                      nodes={"n0": {"GPU": replicas, "CPU": 8}},
                      policy=policy, control_interval=control_interval,
                      seed=seed)
    rt.router.mode = router_mode
    rt.router.kv_affinity = kv_affinity
    built = {}

    def _built(a):
        if a not in built:
            built[a] = _smoke_model(a, seed, device)
        return built[a]

    engines = []
    for i in range(replicas):
        mb = max_batch
        if heterogeneous and i == replicas - 1:
            mb = max(1, max_batch // 2)
        tier = tiers[i] if tiers else ""
        model, params = _built((tier_archs or {}).get(tier, arch))
        engines.append(InferenceEngine(model, params, max_batch=mb,
                                       max_seq=max_seq,
                                       prefill_chunk=prefill_chunk,
                                       max_queue=max_queue,
                                       prefix_sharing=prefix_sharing,
                                       tier=tier, device=device))
    register_engine_pool(
        rt, "llm", engines,
        sampling=SamplingParams(max_new_tokens=max_new_tokens),
        decode=decode, resources={"GPU": 1})
    if max_retries:
        rt.apply_directives("llm", {"max_retries": max_retries,
                                    "retry_backoff": retry_backoff})
    return rt


def classify_tokens(out, k: int = 10) -> str:
    """Branch from the first ``k`` output tokens only.

    Accepts either a partial token list (the streamed path hands the
    classifier ``Future.partial()`` — a plain prefix of token ids) or the
    full engine result (the completion path hands the resolved value, which
    carries ``.tokens``).  Depending only on the first ``k`` tokens is what
    makes the two paths decide identically: greedy decode regenerates the
    same prefix, so a router that looked past position ``k`` would be the
    only source of divergence.
    """
    toks = list(getattr(out, "tokens", out))[:k]
    return "code" if sum(int(t) for t in toks) % 2 else "chat"


def add_stream_classifier(rt: NalarRuntime, *, latency: float = 0.02,
                          k: int = 10) -> None:
    """Register the pipelining classifier on a pool runtime.

    An emulated CPU agent (works on real-time kernels, same as
    :func:`build_engine_runtime`'s router) whose one method classifies from
    the first ``k`` tokens — the downstream consumer of the streaming data
    plane's ``stream_min_tokens`` hint.
    """
    rt.register_agent(AgentSpec(
        name="classifier",
        methods={"classify": emulated(
            FixedLatency(latency), lambda out: classify_tokens(out, k))},
        directives=Directives(max_instances=2, resources={"CPU": 1}),
    ), instances=1)


def streamed_routed_driver(query: str, out_tokens: int = 24,
                           stream_min: int = 10,
                           refine_tokens: int = 6) -> Dict[str, object]:
    """Route on partial output: the classifier starts after ``stream_min``
    streamed tokens, so the branch call overlaps the tail of the upstream
    generation instead of queueing behind it.

    The branch call detaches from the driver session (``session_id: ""``):
    the per-session ordering that keeps multi-turn transcripts consistent
    would otherwise park it behind the still-streaming draft — the very
    call it is pipelining past.
    """
    rt = current_runtime()
    draft = rt.stub("llm").generate(query, _hint={"out_tokens": out_tokens})
    branch = rt.stub("classifier").classify(
        draft, _hint={"stream_min_tokens": stream_min}).value()
    refine = rt.stub("llm").generate(
        f"{branch} follow-up: {query}",
        _hint={"out_tokens": refine_tokens, "session_id": ""})
    d = draft.value()
    r = refine.value()
    return {"branch": branch, "draft": [int(t) for t in d.tokens],
            "refine": [int(t) for t in r.tokens]}


def completion_routed_driver(query: str, out_tokens: int = 24,
                             refine_tokens: int = 6) -> Dict[str, object]:
    """Baseline twin of :func:`streamed_routed_driver`: identical workflow,
    no streaming hints — the classifier waits for the draft to resolve
    fully, and the branch call starts only after.  Greedy decode makes the
    two drivers' outputs byte-identical; only the overlap differs."""
    rt = current_runtime()
    draft = rt.stub("llm").generate(query, _hint={"out_tokens": out_tokens})
    branch = rt.stub("classifier").classify(draft).value()
    refine = rt.stub("llm").generate(
        f"{branch} follow-up: {query}",
        _hint={"out_tokens": refine_tokens, "session_id": ""})
    d = draft.value()
    r = refine.value()
    return {"branch": branch, "draft": [int(t) for t in d.tokens],
            "refine": [int(t) for t in r.tokens]}


def routed_driver(query: str, in_tokens: int, out_tokens: int) -> str:
    rt = current_runtime()
    branch = rt.stub("router").classify(query).value()
    agent = "code_llm" if branch == "code" else "chat_llm"
    return rt.stub(agent).generate(
        query, _hint={"in_tokens": in_tokens, "out_tokens": out_tokens}).value()


def tiered_driver(query: str, tier: str, out_tokens: int) -> str:
    """Pool driver that stamps the just-in-time ``model_tier`` hint: the
    caller (an agent program that knows a classify/extract step is cheap)
    names the tier it wants, and the Router's tier table — installed by
    ``TierRoutePolicy`` — steers the call there, shed watermark permitting."""
    rt = current_runtime()
    return rt.stub("llm").generate(
        query, _hint={"model_tier": tier, "out_tokens": out_tokens}).value()


def run_router(sys_cfg: SystemConfig, *, rps: float = 80.0,
               duration: float = 24.0, seed: int = 0,
               timeout_s: float = 60.0) -> Dict[str, float]:
    """Two phases: chat-heavy then code-heavy (the trace's imbalance)."""
    rt = build_runtime(sys_cfg, seed=seed)
    rng = random.Random(seed)
    rt.start()
    t = 0.0
    i = 0
    while t < duration:
        t += rng.expovariate(rps)
        phase2 = t > duration / 2
        is_code = rng.random() < (0.9 if phase2 else 0.1)
        q = f"{'code' if is_code else 'chat'} query {i}"
        in_tok = rng.randint(400, 1600)
        out_tok = rng.randint(150, 450) if is_code else rng.randint(40, 160)
        rt.submit_request(routed_driver, q, in_tok, out_tok, delay=t,
                          deadline_s=timeout_s)
        i += 1
    rt.run(max_time=duration + timeout_s)
    out = rt.telemetry.summary()
    # real per-request deadline outcomes from telemetry (each request was
    # submitted with deadline_s=timeout_s), not "unfinished == timed out":
    # a request that failed DeadlineExceeded or completed past its budget
    # is a timeout even though it finished, and an unfinished request at
    # the horizon is counted separately as such.
    dl = rt.telemetry.deadline_outcomes()
    out["timeouts"] = dl["deadline_missed"] + dl["unfinished"]
    out["deadline_missed"] = dl["deadline_missed"]
    out["unfinished"] = dl["unfinished"]
    out["timeout_rate"] = out["timeouts"] / max(dl["requests"], 1)
    out["system"] = sys_cfg.name
    out["rps"] = rps
    return out
