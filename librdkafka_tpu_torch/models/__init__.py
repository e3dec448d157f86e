"""The batched codec step: the port of librdkafka_tpu/models.

A Kafka client has no neural model; the flagship step is the batched
MessageSet codec step: many independent per-partition blocks LZ4-encoded
and checksummed (CRC32C) in one launch of the hand-written kernel
(csrc/lz4_rows.cu).  ``librdkafka_tpu_torch.entry.entry()`` delegates
here.
"""
from .codec_step import (batched_codec_step, example_inputs,
                         pipelined_codec_step)

__all__ = ["batched_codec_step", "example_inputs",
           "pipelined_codec_step"]
