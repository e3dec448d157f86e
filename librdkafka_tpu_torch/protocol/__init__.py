"""librdkafka_tpu_torch.protocol"""
