"""Anomaly sentries: host-side detectors over the health taps.

A copy of ``dalle_tpu/obs/anomaly.py`` (it imports no JAX), with the same
detector names, gauge names and breach columns. :mod:`.health` computes
the model's vitals on the card, in the training step; this module watches
them. At each metrics boundary the trainer hands the fetched dict to
:meth:`HealthSentry.observe`, which

  * publishes every ``health/*`` column as a ``dalle_health_*`` gauge,
    per-layer-group ones as ``{layer_group="..."}`` labelled series (the
    groups come from the model's structure, so the label set is bounded),
  * runs the detectors (loss-spike z-score, grad-norm explosion,
    codebook-collapse perplexity floor, NaN-precursor non-finite
    fraction), each edge-triggered: one breach per episode, re-armed only
    after the signal recovers,
  * on each breach: a ``health_breach`` flight-recorder event, a bundle
    dump (``dump_recorder("health_<detector>")``, a no-op without a
    configured recorder, rate-limited per reason), a
    ``health.breaches_total{detector=}`` counter, a
    ``health.breach{detector=,layer_group=}`` gauge, and breach columns
    merged back into the metrics record, so the JSONL, and with it
    ``obs_report``'s MODEL-HEALTH verdict, names the detector and group.

Baselines are an EMA mean/variance (loss) and an EMA level (grad norms),
warmed by ``min_samples`` observations before a detector may fire: a cold
start never pages. The sentry consumes host floats only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

from .recorder import dump_recorder, record_event
from .trace import counter_add, gauge_set

HEALTH_PREFIX = "health/"


def split_health_key(key: str) -> Optional[tuple]:
    """``health/grad_norm/gen/encoder`` → ("grad_norm", "gen/encoder");
    ``health/codebook_perplexity`` → ("codebook_perplexity", "");
    None for non-health keys."""
    if not key.startswith(HEALTH_PREFIX):
        return None
    rest = key[len(HEALTH_PREFIX):]
    metric, _, group = rest.partition("/")
    return metric, group


@dataclasses.dataclass
class Breach:
    detector: str        # which sentry fired
    layer_group: str     # offending group ("loss"/"codebook" for globals)
    step: int
    value: float         # the observed reading
    threshold: float     # what it crossed
    message: str

    def as_fields(self) -> dict:
        return dataclasses.asdict(self)


class _Ema:
    """EMA mean + variance (the debiased exponential analogue of Welford):
    O(1) per update, warmup-counted so consumers can gate on sample size."""

    __slots__ = ("alpha", "mean", "var", "n")

    def __init__(self, alpha: float = 0.98):
        self.alpha = float(alpha)
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, x: float) -> None:
        if not math.isfinite(x):
            return              # poisoned readings must not poison the baseline
        self.n += 1
        if self.n == 1:
            self.mean = x
            return
        a = self.alpha
        d = x - self.mean
        self.mean += (1 - a) * d
        self.var = a * (self.var + (1 - a) * d * d)

    @property
    def std(self) -> float:
        return math.sqrt(max(self.var, 0.0))


class Detector:
    """One anomaly class. ``observe`` returns this boundary's NEW breaches
    (edge-triggered per layer group) and updates its baselines."""

    name = ""

    def observe(self, step: int, metrics: dict) -> List[Breach]:
        raise NotImplementedError

    # -- shared edge-trigger state (per layer group) -----------------------
    def __init__(self):
        self._in_breach: Dict[str, bool] = {}
        self._recovered: List[str] = []

    def _edge(self, group: str, breached: bool) -> bool:
        """True exactly on the ok→breach transition for ``group``. The
        breach→ok transition is queued in ``_recovered`` so the sentry can
        clear the group's breach gauge (pop_recoveries)."""
        was = self._in_breach.get(group, False)
        self._in_breach[group] = breached
        if was and not breached:
            self._recovered.append(group)
        return breached and not was

    def pop_recoveries(self) -> List[str]:
        """Groups that transitioned breach→ok since the last call."""
        out, self._recovered = self._recovered, []
        return out


class LossSpikeDetector(Detector):
    """z-score of the step loss against its EMA mean/std. A spike is a
    PRECURSOR: the classic divergence shape is spike → explosion → NaN,
    and the NaN-rollback only catches the last frame."""

    name = "loss-spike"

    def __init__(self, z: float = 6.0, alpha: float = 0.98,
                 min_samples: int = 5, min_rel_std: float = 0.05):
        super().__init__()
        self.z = float(z)
        self.ema = _Ema(alpha)
        self.min_samples = int(min_samples)
        # σ floor as a fraction of |mean|: a smooth warmup ramp has
        # near-zero EMA variance, and without the floor a +1% monotone
        # drift reads as "many σ" — a spike must clear z × max(σ, 5% of
        # the loss level) to page
        self.min_rel_std = float(min_rel_std)

    def observe(self, step: int, metrics: dict) -> List[Breach]:
        loss = metrics.get("loss")
        if not isinstance(loss, (int, float)):
            return []
        out = []
        warmed = self.ema.n >= self.min_samples
        std = max(self.ema.std, self.min_rel_std * abs(self.ema.mean), 1e-12)
        zscore = ((loss - self.ema.mean) / std) if warmed else 0.0
        breached = bool(warmed and (zscore > self.z
                                    or not math.isfinite(loss)))
        if self._edge("loss", breached):
            out.append(Breach(
                self.name, "loss", step, float(loss), self.z,
                f"loss {loss:.6g} is {zscore:.1f}σ above its EMA "
                f"{self.ema.mean:.6g} (threshold {self.z}σ)"))
        self.ema.update(float(loss))
        return out


class GradExplosionDetector(Detector):
    """Per-layer-group grad norm vs ``factor ×`` its EMA level. Group
    attribution is the point: a global-norm alarm says "something blew
    up"; this says WHICH subtree."""

    name = "grad-explosion"

    def __init__(self, factor: float = 10.0, alpha: float = 0.98,
                 min_samples: int = 5):
        super().__init__()
        self.factor = float(factor)
        self.min_samples = int(min_samples)
        self._emas: Dict[str, _Ema] = {}

    def observe(self, step: int, metrics: dict) -> List[Breach]:
        out = []
        for key, val in metrics.items():
            parsed = split_health_key(key)
            if parsed is None or parsed[0] != "grad_norm":
                continue
            if not isinstance(val, (int, float)):
                continue
            group = parsed[1] or "root"
            ema = self._emas.setdefault(group, _Ema())
            warmed = ema.n >= self.min_samples and ema.mean > 0
            thresh = self.factor * ema.mean if warmed else math.inf
            breached = bool(warmed and (val > thresh
                                        or not math.isfinite(val)))
            if self._edge(group, breached):
                out.append(Breach(
                    self.name, group, step, float(val), thresh,
                    f"grad_norm[{group}] {val:.6g} > {self.factor}× EMA "
                    f"{ema.mean:.6g}"))
            ema.update(float(val))
        return out


class CodebookCollapseDetector(Detector):
    """Usage perplexity under an absolute floor. Perplexity is
    ``num_tokens`` at uniform usage and → 1 at full collapse, so a small
    absolute floor (default 4.0: "the whole batch routed through a
    handful of codes") is meaningful at any codebook size; runs with a
    known healthy operating point should raise it."""

    name = "codebook-collapse"

    def __init__(self, floor: float = 4.0, min_samples: int = 2):
        super().__init__()
        self.floor = float(floor)
        self.min_samples = int(min_samples)
        self._seen: Dict[str, int] = {}

    def observe(self, step: int, metrics: dict) -> List[Breach]:
        out = []
        for key, val in metrics.items():
            parsed = split_health_key(key)
            if parsed is None or not parsed[0].endswith("_perplexity"):
                continue
            if not isinstance(val, (int, float)):
                continue
            group = parsed[0][:-len("_perplexity")]
            n = self._seen.get(group, 0) + 1
            self._seen[group] = n
            breached = bool(n >= self.min_samples
                            and (val < self.floor
                                 or not math.isfinite(val)))
            if self._edge(group, breached):
                out.append(Breach(
                    self.name, group, step, float(val), self.floor,
                    f"{group} usage perplexity {val:.4g} under the "
                    f"collapse floor {self.floor:.4g}"))
        return out


class NaNPrecursorDetector(Detector):
    """Any non-finite fraction in a layer group's gradients. Zero
    tolerance by default: a single inf in one layer is the cheapest
    possible warning that the next steps will poison the state — fire
    BEFORE the loss itself goes NaN and the rollback burns progress."""

    name = "nan-precursor"

    def __init__(self, max_frac: float = 0.0):
        super().__init__()
        self.max_frac = float(max_frac)

    def observe(self, step: int, metrics: dict) -> List[Breach]:
        out = []
        for key, val in metrics.items():
            parsed = split_health_key(key)
            if parsed is None or parsed[0] != "nonfinite_frac":
                continue
            if not isinstance(val, (int, float)):
                continue
            group = parsed[1] or "root"
            if self._edge(group, bool(val > self.max_frac)):
                out.append(Breach(
                    self.name, group, step, float(val), self.max_frac,
                    f"{val:.2%} non-finite gradient elements in "
                    f"[{group}] (tolerance {self.max_frac:.2%})"))
        return out


class HealthSentry:
    """The graftpulse judge: detectors + gauge publication + breach
    side-effects, one ``observe(step, metrics)`` per metrics boundary
    (BaseTrainer wires this on every fetched-metrics path when
    ``ObsConfig.health`` is set). Mutates ``metrics`` with breach columns
    (``health/breach``, ``health/breach_detector``,
    ``health/breach_group``) so the record the writer logs carries the
    verdict inputs obs_report needs."""

    def __init__(self, detectors: Optional[List] = None, *,
                 on_breach: Optional[Callable[[Breach], None]] = None,
                 dump_bundles: bool = True):
        self.detectors = detectors if detectors is not None else [
            LossSpikeDetector(), GradExplosionDetector(),
            CodebookCollapseDetector(), NaNPrecursorDetector()]
        self.on_breach = on_breach
        self.dump_bundles = dump_bundles
        self.breaches: List[Breach] = []

    @classmethod
    def from_obs_config(cls, oc) -> "HealthSentry":
        """Build from ObsConfig's health_* knobs (docs/OBSERVABILITY.md)."""
        ms = int(getattr(oc, "health_min_samples", 5))
        return cls([
            LossSpikeDetector(z=getattr(oc, "health_loss_z", 6.0),
                              min_samples=ms),
            GradExplosionDetector(
                factor=getattr(oc, "health_grad_factor", 10.0),
                min_samples=ms),
            CodebookCollapseDetector(
                floor=getattr(oc, "health_perplexity_floor", 4.0),
                min_samples=ms),
            NaNPrecursorDetector(),
        ])

    def _publish_gauges(self, metrics: dict) -> None:
        for key, val in metrics.items():
            parsed = split_health_key(key)
            if parsed is None or not isinstance(val, (int, float)):
                continue
            metric, group = parsed
            if metric in ("breach",):
                continue      # breach gauges are published labeled below
            if group:
                gauge_set(f"health.{metric}", float(val),
                          labels={"layer_group": group})
            else:
                gauge_set(f"health.{metric}", float(val))

    def observe(self, step: int, metrics: dict) -> List[Breach]:
        if not metrics:
            return []
        self._publish_gauges(metrics)
        new: List[Breach] = []
        for det in self.detectors:
            try:
                new.extend(det.observe(step, metrics))
                # clear the breach gauge on the breach→ok edge — without
                # the 0-write, one transient spike reads as an ongoing
                # incident on every later scrape
                for group in (det.pop_recoveries()
                              if hasattr(det, "pop_recoveries") else ()):
                    gauge_set("health.breach", 0.0,
                              labels={"detector": det.name,
                                      "layer_group": group})
            except Exception as exc:  # noqa: BLE001 - a detector bug must
                # degrade to a missed alarm, never kill the training loop
                # it watches
                print(f"[graftpulse] detector {det.name} failed: {exc!r}")
        for b in new:
            self.breaches.append(b)
            counter_add("health.breaches_total", 1.0,
                        labels={"detector": b.detector})
            gauge_set("health.breach", 1.0,
                      labels={"detector": b.detector,
                              "layer_group": b.layer_group})
            record_event("health_breach", **b.as_fields())
            if self.dump_bundles:
                dump_recorder(f"health_{b.detector}",
                              extra={"breach": b.as_fields()})
            if self.on_breach is not None:
                try:
                    self.on_breach(b)
                except Exception as exc:  # noqa: BLE001 - see detector note
                    print(f"[graftpulse] on_breach sink failed: {exc!r}")
        if new:
            metrics["health/breach"] = (
                float(metrics.get("health/breach", 0)) + len(new))
            metrics["health/breach_detector"] = new[-1].detector
            metrics["health/breach_group"] = new[-1].layer_group
        return new
