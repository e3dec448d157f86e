"""Observability, the port's copy of the JAX package's ``obs`` modules:

  * trace.py   — flight-recorder trace rings + Chrome trace-event export
  * metrics.py — the process-wide metrics registry (counters / gauges /
                 HdrHistogram windows)
"""
