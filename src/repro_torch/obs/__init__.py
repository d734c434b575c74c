"""repro_torch.obs — campaign telemetry.  Counterpart of ``repro.obs``; so
far only the bus (:mod:`~repro_torch.obs.bus`), which the DSE runner emits
its round, compile, transfer and sweep events into."""
from .bus import (BUS, SCHEMA_VERSION, Bus, Counter, Gauge, Histogram,
                  MemorySink, MetricsRegistry, capture, emit)

__all__ = [
    "BUS", "SCHEMA_VERSION", "Bus", "Counter", "Gauge", "Histogram",
    "MemorySink", "MetricsRegistry", "capture", "emit",
]
