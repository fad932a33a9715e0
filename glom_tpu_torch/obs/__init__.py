"""Observability of the port: the runtime monitors (``monitors.py``: the
step's numerics, device memory, kernel rebuilds), the trainer's phase timer
(``timing.py``), GLOM diagnostics (``diagnostics.py``), forensics bundles
(``forensics.py``: the flight recorder, the env fingerprint, the capture
pipeline), and the copies of ``glom_tpu``'s stdlib-only obs modules — the
metric registry (``registry.py``), its exporters (``exporters.py``: JSONL,
CSV, the Prometheus textfile and the ``/metrics`` text), request tracing
(``tracing.py``), triggers (``triggers.py``), the event timeline
(``events.py``) and declarative SLOs (``slo.py``)."""

from glom_tpu_torch.obs.registry import (  # noqa: F401
    EVENT_FORENSICS,
    EVENT_NAN,
    EVENT_PREEMPT_STOP,
    EVENT_RECOMPILE,
    EVENT_RESUME,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    Timer,
)
from glom_tpu_torch.obs.exporters import (  # noqa: F401
    CsvExporter,
    JsonlExporter,
    PrometheusTextfileExporter,
    prometheus_lines,
)
from glom_tpu_torch.obs.triggers import (  # noqa: F401
    QueueSaturationMonitor,
    StepTimeRegressionMonitor,
    TriggerEngine,
)
from glom_tpu_torch.obs.tracing import (  # noqa: F401
    Span,
    TraceExporter,
    TraceSink,
    Tracer,
    find_root,
    format_traceparent,
    parse_traceparent,
    span_coverage,
    to_perfetto,
)
from glom_tpu_torch.obs.slo import (  # noqa: F401
    SLO,
    BurnRateEvaluator,
    SloManager,
    parse_slo,
)
from glom_tpu_torch.obs.events import Timeline  # noqa: F401
