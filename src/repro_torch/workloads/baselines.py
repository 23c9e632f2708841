"""Baseline agent-framework emulations (paper §6 comparison classes).

Each baseline is NALAR with capabilities *removed*, matching the paper's
characterization of the competing systems (§2.3):

  crewai   — specification-focused: no resource management, no global
             control, whole-workflow replication, FCFS, sticky sessions.
  autogen  — event-driven messaging: least-queue at submission, no
             periodic control, no migration, sticky sessions.
  ayo      — static graph + Ray-style immutable placement: parallel
             execution allowed, but a future's placement never changes and
             capacity is fixed.
  nalar    — full system: the three §6.1 default policies (load-balance
             routing, HoL migration, resource reassignment) + migratable
             session state (K,V control).

All four run the *same* workload code on the same simulated cluster; only
the control capabilities differ, which is the comparison the paper makes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core import (HoLMitigationPolicy, LoadBalancePolicy, Policy,
                    PolicyChain, ResourceReassignmentPolicy)


class NullPolicy(Policy):
    name = "null"

    def step(self, view, act) -> None:
        return


@dataclass
class SystemConfig:
    name: str
    policy: Policy
    # sessions may migrate with their state (NALAR's K,V control, §4.3.2);
    # baselines route a session to its original instance forever
    sticky_sessions: bool
    # the runtime may kill/provision instances across agent types
    dynamic_resources: bool
    # default-routing capability (see core.runtime.Router.mode)
    router_mode: str = "least_eta"
    control_interval: float = 0.25


def system_config(name: str) -> SystemConfig:
    if name == "nalar":
        # native least-ETA routing IS the paper's default policy 1
        # (load-balance via routing); the chain adds HoL migration and
        # resource reassignment (§6.1's three defaults).
        return SystemConfig(
            name="nalar",
            policy=PolicyChain(HoLMitigationPolicy(wait_threshold=1.0),
                               ResourceReassignmentPolicy(hot=3.0, cold=0.5,
                                                          cooldown=4.0)),
            sticky_sessions=False,
            dynamic_resources=True,
            router_mode="least_eta")
    if name == "autogen":
        # event-driven messaging: queue-length routing at send time, no
        # periodic control, no migration
        return SystemConfig(name="autogen", policy=NullPolicy(),
                            sticky_sessions=True, dynamic_resources=False,
                            router_mode="least_qlen")
    if name == "crewai":
        # thin specification layer: whole-workflow replication ~ round-robin
        return SystemConfig(name="crewai", policy=NullPolicy(),
                            sticky_sessions=True, dynamic_resources=False,
                            router_mode="round_robin")
    if name == "ayo":
        # static graph + Ray-style event-driven scheduling: least-queue at
        # future creation, placement immutable afterwards
        return SystemConfig(name="ayo", policy=NullPolicy(),
                            sticky_sessions=True, dynamic_resources=False,
                            router_mode="least_qlen")
    raise KeyError(name)


BASELINES = ["ayo", "crewai", "autogen"]
