"""librdkafka_tpu_torch.client"""
