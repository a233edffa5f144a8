"""Breach actions: the policy layer that makes the health sentries act.

Port of ``dalle_tpu/train/actions.py`` under its names. ``BreachActions``
maps each breach class of :mod:`..obs.anomaly` to one action, run on the
host between steps:

  * ``nan-precursor`` → **preemptive snapshot**
    (``BaseTrainer.take_preemptive_snapshot``): inf in the gradients comes
    a few steps before a NaN loss, and the NaN rollback rewinds to the last
    save; a snapshot at the precursor makes the rollback lose the steps
    since the breach instead. The rung is one-shot: a second NaN falls
    through to the save's snapshot.
  * ``grad-explosion`` → **rollback + lr cut**: restore the last good state
    now, and scale the learning rate by ``lr_cut_factor`` (through
    ``BaseTrainer.set_lr_scale``, clamped at ``min_lr_scale``).
  * ``codebook-collapse`` → **lr cut + gumbel re-anneal**: restart the
    temperature schedule from the breach step on trainers that have
    ``reanneal_gumbel`` (the dVAE's).
  * ``loss-spike`` → no action by default; ``policy={...}`` remaps.

Actions are edge-triggered (the sentry delivers ok→breach transitions),
one action kind per step however many groups breach, with an optional
``cooldown_steps``. Each emits a ``breach_action`` flight-recorder event,
an ``actions.fired_total{action=}`` counter and, for a cut, an
``actions.lr_scale`` gauge. A failing action is logged and the loop goes
on.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..obs import counter_add, gauge_set, record_event
from ..obs.anomaly import Breach, HealthSentry

# detector name -> action name (the policy table in docs/RESILIENCE.md)
DEFAULT_POLICY: Dict[str, str] = {
    "nan-precursor": "preemptive_snapshot",
    "grad-explosion": "rollback_lr_cut",
    "codebook-collapse": "lr_cut_reanneal",
}


class BreachActions:
    """Callable policy object wired as ``HealthSentry.on_breach``.

    ``attach()`` binds it to the trainer's sentry (creating one from the
    trainer's ObsConfig if ``fit`` hasn't yet), chaining — not replacing —
    any existing ``on_breach`` sink."""

    def __init__(self, trainer, *, policy: Optional[Dict[str, str]] = None,
                 lr_cut_factor: float = 0.5, min_lr_scale: float = 1e-3,
                 cooldown_steps: int = 0, log=print):
        self.trainer = trainer
        self.policy = dict(DEFAULT_POLICY if policy is None else policy)
        self.lr_cut_factor = float(lr_cut_factor)
        self.min_lr_scale = float(min_lr_scale)
        self.cooldown_steps = int(cooldown_steps)
        self.log = log
        self.fired = []                    # (step, action, detector, group)
        self._last_fired: Dict[str, int] = {}   # action -> step
        self._handlers: Dict[str, Callable[[Breach], None]] = {
            "preemptive_snapshot": self._act_preemptive_snapshot,
            "rollback_lr_cut": self._act_rollback_lr_cut,
            "lr_cut_reanneal": self._act_lr_cut_reanneal,
        }

    # -- wiring ------------------------------------------------------------
    def attach(self) -> "BreachActions":
        """Bind to the trainer's HealthSentry (building it from
        ``train_cfg.obs`` when fit() hasn't run yet — fit's ``is None``
        check then reuses the same sentry, so EMA baselines are shared)."""
        sentry = self.trainer.health_sentry
        if sentry is None:
            sentry = HealthSentry.from_obs_config(self.trainer.train_cfg.obs)
            self.trainer.health_sentry = sentry
        prev = sentry.on_breach
        if prev is None:
            sentry.on_breach = self
        else:
            def chained(breach, _prev=prev, _self=self):
                _prev(breach)
                _self(breach)
            sentry.on_breach = chained
        return self

    # -- dispatch ----------------------------------------------------------
    def __call__(self, breach: Breach) -> None:
        action = self.policy.get(breach.detector)
        if action is None:
            return
        handler = self._handlers.get(action)
        if handler is None:
            self.log(f"[actions] unknown action {action!r} for "
                     f"{breach.detector}; ignoring")
            return
        last = self._last_fired.get(action)
        if last is not None and (breach.step == last
                                 or breach.step - last < self.cooldown_steps):
            # coalesce: N groups breaching in one boundary = one action;
            # cooldown bounds the rate across boundaries
            return
        self._last_fired[action] = breach.step
        try:
            handler(breach)
        except Exception as exc:  # noqa: BLE001 - a policy bug must degrade
            # to a missed remediation, never kill the run it protects
            self.log(f"[actions] {action} failed on {breach.detector} "
                     f"breach: {exc!r}")
            return
        self.fired.append((breach.step, action, breach.detector,
                           breach.layer_group))
        counter_add("actions.fired_total", 1.0, labels={"action": action})
        record_event("breach_action", action=action,
                     detector=breach.detector, layer_group=breach.layer_group,
                     step=breach.step, value=breach.value)
        self.log(f"[actions] step {breach.step}: {breach.detector} breach "
                 f"in [{breach.layer_group}] → {action}")

    # -- the actions -------------------------------------------------------
    def _act_preemptive_snapshot(self, breach: Breach) -> None:
        self.trainer.take_preemptive_snapshot()

    def _act_rollback_lr_cut(self, breach: Breach) -> None:
        self.trainer._rollback()
        self._cut_lr()

    def _act_lr_cut_reanneal(self, breach: Breach) -> None:
        self._cut_lr()
        reanneal = getattr(self.trainer, "reanneal_gumbel", None)
        if reanneal is not None:
            reanneal(breach.step)

    def _cut_lr(self) -> float:
        """Multiply the optimizer's runtime lr scale by the cut factor
        (clamped at ``min_lr_scale``) through ``set_lr_scale``; one read of
        the scale from the device per breach. An optimizer without an armed
        scale (``TrainConfig.runtime_lr_scale`` off) is a logged skip."""
        old = self.trainer.optimizer.lr_scale
        if old is None:
            self.log("[actions] state has no lr_scale leaf; lr cut skipped")
            return 1.0
        new = max(float(old) * self.lr_cut_factor, self.min_lr_scale)
        self.trainer.set_lr_scale(new)
        gauge_set("actions.lr_scale", new)
        return new
