"""librdkafka_tpu_torch.examples — the port's copies of the examples.

Each runs as ``python -m librdkafka_tpu_torch.examples.<name>``:
``producer``, ``consumer``, ``idempotent_producer``, ``admin``,
``performance`` (``--backend cpu|gpu``; ``gpu`` needs a CUDA card) and
``verifiable_client`` (the ducktape protocol client); ``capi_client.c``
and ``cpp_client.cpp`` link against the port's libtkafka.so
(``librdkafka_tpu_torch.capi.build_capi``).
"""
