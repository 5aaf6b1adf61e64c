"""Fleet observatory: retained time-series, trend watchdog,
and the trend digest the router/controller act on.

- `tsring`: fixed-cadence bounded ring + delta encoding (clock seam)
- `watchdog`: EWMA + slope/level-shift change-point detection, typed
  ``trend:<series>`` FlightRecorder incidents
- `observatory`: collectors + sampling loop + trend digest

PyTorch port: a copy of ``bee2bee_tpu/obs/__init__.py`` with the import root rewritten to
``bee2bee_tpu_torch``; comments that cited the JAX package's change history or the
reference checkout's path are trimmed.
"""

from .observatory import Observatory, default_collectors
from .tsring import (
    OBS_CADENCE_S,
    OBS_CAPACITY,
    SERIES,
    SERIES_BY_NAME,
    SERIES_NAMES,
    SeriesSpec,
    TsRing,
    delta_decode,
    delta_encode,
)
from .watchdog import TREND_DIGEST_VERSION, TrendPolicy, TrendWatchdog

__all__ = [
    "OBS_CADENCE_S",
    "OBS_CAPACITY",
    "SERIES",
    "SERIES_BY_NAME",
    "SERIES_NAMES",
    "SeriesSpec",
    "TsRing",
    "delta_decode",
    "delta_encode",
    "TREND_DIGEST_VERSION",
    "TrendPolicy",
    "TrendWatchdog",
    "Observatory",
    "default_collectors",
]
