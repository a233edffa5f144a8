"""Proactive degradation response: components that are sick but alive.

Port of ``dalle_tpu/degrade`` (it imports no JAX), under the same names:

  * :class:`~.detector.StragglerDetector` flags a training worker whose
    collective wait lags its peers' by a sustained factor of the step
    interval (EWMA-smoothed, hysteresis-guarded, edge-triggered);
    ``frozen_progress`` is the fresh-but-frozen core the fleet transport's
    outside-in replica check shares.
  * :class:`~.wedge.WedgeWatchdog` is the engine-iteration liveness probe a
    replica process runs on its own decode loop: busy with frozen progress
    past a timeout is a wedge, self-reported through the health verb so
    the fleet controller drains the replica.

``ladder.py`` (``DegradeMonitor``, the page → drain ladder of the elastic
training agent) waits for ``parallel/elastic.py``, its only caller.
"""

from .detector import StragglerDetector, StragglerVerdict, frozen_progress
from .wedge import WedgeWatchdog

__all__ = ["StragglerDetector", "StragglerVerdict", "WedgeWatchdog", "frozen_progress"]
