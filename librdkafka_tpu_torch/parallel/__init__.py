"""librdkafka_tpu_torch.parallel — the codec kernels over several devices."""
