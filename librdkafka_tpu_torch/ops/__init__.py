"""librdkafka_tpu_torch.ops"""
