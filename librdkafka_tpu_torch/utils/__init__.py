"""librdkafka_tpu_torch.utils"""
