"""Chaos-engineering subsystem, the port's copy of the JAX package's
``chaos``: scripted fault schedules, a delivery-invariant oracle, and a
scenario library over the real-TCP mock cluster.  The repo's CHAOS.md
is the DSL reference, with the oracle invariants and the
replay-from-seed workflow.

    from librdkafka_tpu_torch.chaos import (Schedule, ChaosScheduler,
                                            DeliveryOracle, broker_kill,
                                            ...)

CLI: ``python -m librdkafka_tpu_torch.chaos --list``.
"""
from .oracle import DeliveryOracle, OracleViolation
from .schedule import (Action, ChaosContext, ChaosScheduler, Schedule,
                       broker_kill, broker_restart, call, conn_kill,
                       leader_migrate, net, proc_cont, proc_kill9,
                       proc_pause, proc_restart)
from .scenarios import SCENARIOS, Scenario, Storm

__all__ = [
    "Action", "ChaosContext", "ChaosScheduler", "Schedule",
    "broker_kill", "broker_restart", "call", "conn_kill",
    "leader_migrate", "net",
    "proc_kill9", "proc_pause", "proc_cont", "proc_restart",
    "DeliveryOracle", "OracleViolation",
    "SCENARIOS", "Scenario", "Storm",
]
