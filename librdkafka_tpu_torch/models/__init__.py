"""Batched codec steps: the port of librdkafka_tpu/models."""
