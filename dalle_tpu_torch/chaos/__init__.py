"""Deterministic fault injection (a copy of ``dalle_tpu/chaos``).

A scripted, seeded :class:`~dalle_tpu_torch.chaos.faults.FaultPlan` kills,
hangs or slows a loop at step N, fails guarded I/O k times before healing,
or corrupts a checkpoint on disk. The hook points sit in the real loops
(``BaseTrainer.fit``, ``DecodeEngine.run``) and cost one module-global
``None`` check when no plan is installed.
"""

from .faults import (EPOCH_ENV, PLAN_ENV, RANK_ENV, Fault, FaultPlan,
                     InjectedFault, active_plan, corrupt_checkpoint, install,
                     install_from_env, io_hook, step_hook, uninstall)

__all__ = [
    "EPOCH_ENV", "PLAN_ENV", "RANK_ENV", "Fault", "FaultPlan",
    "InjectedFault", "active_plan", "corrupt_checkpoint", "install",
    "install_from_env", "io_hook", "step_hook", "uninstall",
]
