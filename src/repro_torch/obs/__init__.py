"""repro_torch.obs — campaign telemetry: one event/metrics bus for sweeps and
search, with pluggable sinks, a live dashboard, and Perfetto export.

The engine already honors the paper's observability pitch for single
runs (tracing §3.4, AkitaRTM §3.5, Daisen §3.6); this package gives DSE
*campaigns* — round-based sweeps, closed-loop searches — the same
first-class treatment:

  * :mod:`~repro_torch.obs.bus`       — the process-wide :class:`Bus`
    (``emit(kind, **fields)``), the metrics registry
    (counters/gauges/histograms) and the schema version.  Zero-cost
    when no sink is attached; host-side only, never inside jitted code.
  * :mod:`~repro_torch.obs.sinks`     — :class:`MemorySink`,
    :class:`JsonlSink` (versioned append-only event log),
    :class:`CallbackSink`, and :func:`read_jsonl`.
  * :mod:`~repro_torch.obs.bridge`    — :class:`BusTracer`: forward engine
    :class:`~repro_torch.core.tracing.Task`\\ s onto the bus so one stream
    covers engine (virtual) and campaign (wall) clocks.
  * :mod:`~repro_torch.obs.dashboard` — :class:`CampaignServer`: live
    ``/campaign`` JSON + ``/events`` SSE over the monitor's HTTP
    machinery (rounds drained, live/pending lanes, budget burn-down,
    current best per objective).
  * :mod:`~repro_torch.obs.perfetto`  — :func:`export_chrome_trace`
    (Perfetto-loadable trace-event JSON: rounds/compiles/transfers/
    search rounds/rung promotions as tracks) and
    :func:`export_campaign_html` (Daisen-lite campaign timeline).

Counterpart of ``repro.obs``.  The instrumented call sites live in
``repro_torch.dse`` (runner, sweep); the search drivers are not ported yet.
See OBSERVABILITY.md for the event catalogue and DSE.md "Watching a
campaign" for the workflow.
"""
from .bridge import BusTracer, bridge_domain
from .bus import (BUS, SCHEMA_VERSION, Bus, Counter, Gauge, Histogram,
                  MetricsRegistry, capture, emit)
from .dashboard import CampaignServer, CampaignStats
from .perfetto import (campaign_tasks, export_campaign_html,
                       export_chrome_trace, to_chrome_trace)
from .sinks import CallbackSink, JsonlSink, MemorySink, read_jsonl

__all__ = [
    "BUS", "SCHEMA_VERSION", "Bus", "BusTracer", "CallbackSink",
    "CampaignServer", "CampaignStats", "Counter", "Gauge", "Histogram",
    "JsonlSink", "MemorySink", "MetricsRegistry", "bridge_domain",
    "campaign_tasks", "capture", "emit", "export_campaign_html",
    "export_chrome_trace", "read_jsonl", "to_chrome_trace",
]
