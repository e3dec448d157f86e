"""librdkafka_tpu_torch.capi — the C-callable binding surface of the port.

A real C ABI (libtkafka.so + tkafka.h, the JAX package's declarations
unchanged) whose ``tk_*`` entry points drive the port's client inside an
embedded CPython, so C and C++ applications link against the PyTorch /
CUDA client the way they link librdkafka today; ``tkafka.hpp`` is the
header-only C++ wrapper over it.  The library is a hand-written C shim
(``tkafka.c``) over ``_embed.py``, built with gcc against the running
Python's shared libpython.

Build:  python -m librdkafka_tpu_torch.capi.build_capi  (writes
        libtkafka.so + tkafka.h into build/librdkafka_tpu_torch/capi/;
        ``build_capi.compile_program(src, exe)`` links a C or C++
        program against it)
"""
