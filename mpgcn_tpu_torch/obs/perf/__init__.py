"""Performance observability (counterpart of mpgcn_tpu/obs/perf/): the
service-level objectives (``slo``), the ``slo`` command's offline and
live evaluation (``slo_cli``) and the kernel-library cache behind
``-compile-cache`` (``compile_cache``). Import-empty."""
