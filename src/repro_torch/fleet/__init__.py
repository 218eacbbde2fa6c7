"""Concurrent, policy-driven serving fleet (the live twin of the simulator).

A clock-advanced driver over the shared :mod:`repro_torch.core.cluster` kernel —
container FSM, warm pools, memory counters, and QoS accounting are the same
code the discrete-event simulator runs, so virtual-clock replays are
ledger-identical between the two.

Layers:
  clock       virtual + scaled wall-clock time under one protocol
  frontend    per-function queues, admission control, SLO deadlines
  pool        the kernel's replica registry + execution backends
  autoscaler  the shared PolicyDriver/Context under their fleet names
  loadgen     trace replay -> QoSLedger (sim-vs-real calibration loop)
"""
from repro_torch.fleet.autoscaler import Autoscaler, FleetContext
from repro_torch.fleet.clock import Clock, VirtualClock, WallClock
from repro_torch.fleet.frontend import (AdmissionConfig, DropLedger, Frontend,
                                        Request)
from repro_torch.fleet.loadgen import FleetConfig, FleetRunner, replay
from repro_torch.fleet.pool import (EngineBackend, EnginePool, EngineProfile,
                                    ExecutionBackend, ModeledBackend, Replica)

__all__ = [
    "Autoscaler", "FleetContext", "Clock", "VirtualClock", "WallClock",
    "AdmissionConfig", "DropLedger", "Frontend", "Request",
    "FleetConfig", "FleetRunner", "replay",
    "EngineBackend", "EnginePool", "EngineProfile", "ExecutionBackend",
    "ModeledBackend", "Replica",
]
