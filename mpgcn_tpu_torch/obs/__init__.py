"""The telemetry plane (counterpart of mpgcn_tpu/obs/): ``metrics``
(counters, gauges, histograms, the Prometheus text encoder), ``trace``
(span ids and the span log), ``flight`` (the in-memory flight recorder
dumped on the failure paths), ``device`` (the card's memory gauges) and
``perf.slo`` (service-level objectives with burn windows).

Import-empty on purpose: utils/logging.py tees into ``obs.flight``, and
``obs.trace`` imports utils/logging back."""
