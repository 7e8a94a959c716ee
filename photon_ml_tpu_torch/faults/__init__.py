"""Deterministic fault injection (see :mod:`photon_ml_tpu_torch.faults.plan`),
counterpart of ``photon_ml_tpu/faults``.

Public surface::

    from photon_ml_tpu_torch import faults

    _FP = faults.register_point("my.seam", write_path=False)   # import time
    faults.fault_point(_FP)                                    # call site

    plan = faults.FaultPlan([faults.FaultRule("my.seam", action="exit")])
    faults.install_plan(plan)          # in-process, or via PHOTON_FAULT_PLAN
"""

from photon_ml_tpu_torch.faults.plan import (
    DEFAULT_EXIT_CODE,
    ENV_VAR,
    FaultPlan,
    FaultPlanError,
    FaultPointInfo,
    FaultRule,
    InjectedFault,
    InjectedIOError,
    active_plan,
    clear_plan,
    corrupt_array,
    corrupt_health,
    distributed_points,
    fault_point,
    install_from_env,
    install_plan,
    register_point,
    registered_points,
    warn_if_armed,
    write_path_points,
)

__all__ = [
    "DEFAULT_EXIT_CODE",
    "ENV_VAR",
    "FaultPlan",
    "FaultPlanError",
    "FaultPointInfo",
    "FaultRule",
    "InjectedFault",
    "InjectedIOError",
    "active_plan",
    "clear_plan",
    "corrupt_array",
    "corrupt_health",
    "distributed_points",
    "fault_point",
    "install_from_env",
    "install_plan",
    "register_point",
    "registered_points",
    "warn_if_armed",
    "write_path_points",
]
