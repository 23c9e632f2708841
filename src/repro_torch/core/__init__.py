"""repro_torch.core — NALAR's contribution: futures-centric agent serving runtime.

Public API:
    NalarRuntime, deployment          runtime + entry point
    AgentSpec, parse_spec, emulated   agent declaration / stub generation
    Directives                        runtime hints (Table 1)
    Future                            coordination handle (§3.2)
    ManagedList/ManagedDict           managed state (§3.3)
    Policy, ActionSink, ClusterView   policy interface (§4.2, Table 2)
    + the default/example policy library
"""

from .clock import Kernel, RealTimeKernel, SimKernel
from .controller_global import GlobalController
from .controller_local import ComponentController, LocalSchedule
from .directives import Directives
from .executor import (AgentInstance, EmulatedMethod, EngineBackedMethod,
                       FixedLatency, LatencyModel, LLMLatency,
                       LognormalLatency)
from .future import (DeadlineExceeded, Future, FutureCancelled,
                     FutureMetadata, FutureState, FutureTable, InstanceDied)
from .kv_registry import KVRegistry, Residency
from .node_store import NodeStore, StoreCluster
from .policy import (Action, ActionSink, ClusterView, HedgePolicy,
                     HighPrioritySessionPolicy,
                     HoLMitigationPolicy, InstanceView, KVAffinityPolicy,
                     LoadBalancePolicy, LPTPolicy, LPTSchedule, Policy,
                     PolicyChain, ResourceReassignmentPolicy, RetryPolicy,
                     SRTFPolicy, SRTFSchedule, TierRoutePolicy,
                     default_policies)
from .runtime import NalarRuntime, Router, current_runtime, deployment
from .session import SessionRegistry, get_context, set_context
from .state import (ManagedDict, ManagedList, SessionStateStore,
                    SessionTranscript, managedDict, managedList)
from .stubs import AgentSpec, Stub, emulated, parse_spec
from .telemetry import Telemetry

__all__ = [
    "AgentInstance", "AgentSpec", "Action", "ActionSink", "ClusterView",
    "ComponentController", "DeadlineExceeded", "Directives", "EmulatedMethod",
    "EngineBackedMethod", "FixedLatency",
    "Future", "FutureCancelled", "FutureMetadata", "FutureState",
    "FutureTable", "GlobalController", "HedgePolicy",
    "HighPrioritySessionPolicy",
    "HoLMitigationPolicy", "InstanceDied",
    "InstanceView", "KVAffinityPolicy", "Kernel", "KVRegistry",
    "LatencyModel", "LLMLatency",
    "LoadBalancePolicy", "LocalSchedule", "LognormalLatency", "LPTPolicy",
    "LPTSchedule", "ManagedDict", "ManagedList", "NalarRuntime", "NodeStore",
    "Policy", "PolicyChain", "RealTimeKernel", "Residency",
    "ResourceReassignmentPolicy", "RetryPolicy", "Router", "SRTFPolicy",
    "SRTFSchedule", "TierRoutePolicy",
    "SessionRegistry", "SessionStateStore", "SessionTranscript", "SimKernel",
    "StoreCluster",
    "Stub", "Telemetry", "current_runtime", "default_policies", "deployment",
    "emulated", "get_context", "managedDict", "managedList", "parse_spec",
    "set_context",
]
