"""The part of ``tse1m_tpu/resilience`` the port runs: watchdog deadlines,
the stage watchdog, request budgets and the failure classifiers
(``watchdog``), and the fault-injection plane (``faults``).  The retry
engine and the step runner are ``utils/retry.py`` and ``utils/runner.py``;
the degradation ladder is ``cluster/ladder.py``.  ``coordinator`` is the
pod coordinator: heartbeats, the peer monitor, epoch leases, the pod
supervisor, the run nonce and the membership ledger, run by the sharded
serving plane and the pod path."""

from .coordinator import (HeartbeatWriter, HostLostError,
                          LeaseSupersededError, MembershipLedger,
                          PeerMonitor, PodSupervisor, RangeLeaseGuard)
from .faults import (FaultPlan, FaultRule, InjectedConnectionDrop,
                     InjectedFault, active_plan, clear_plan, fault_point,
                     install_plan, reraise_if_fault)
from .watchdog import (StageWatchdog, StallError, StickyDeviceError,
                       deadline_clock, deadline_guard, is_device_loss,
                       is_resource_exhausted, is_sticky_cuda_error,
                       request_budget_s, run_with_deadline,
                       terminal_device_error, watchdog_enabled)

__all__ = ["FaultPlan", "FaultRule", "HeartbeatWriter", "HostLostError",
           "InjectedConnectionDrop", "InjectedFault",
           "LeaseSupersededError", "MembershipLedger", "PeerMonitor",
           "PodSupervisor", "RangeLeaseGuard",
           "StageWatchdog", "StallError",
           "StickyDeviceError", "active_plan", "clear_plan",
           "deadline_clock", "deadline_guard", "fault_point", "install_plan",
           "is_device_loss", "is_resource_exhausted", "is_sticky_cuda_error",
           "request_budget_s", "reraise_if_fault", "run_with_deadline",
           "terminal_device_error", "watchdog_enabled"]
