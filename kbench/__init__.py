"""The benchmark of librdkafka_tpu_torch: see run.py and PERF.md."""
