"""Performance observability (counterpart of mpgcn_tpu/obs/perf/): the
serving plane's service-level objectives (``slo``). Import-empty."""
