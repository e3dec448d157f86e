"""Builds both packages' native libraries once, in the process that starts
the test run, before any test worker exists.

Each package compiles its libraries on first use.  The JAX package's
build (librdkafka_tpu/ops/native/build.py) writes one temporary file that
every process shares, so parallel workers (``-n``) that find the
libraries missing and build them at the same moment can lose that race,
and a worker whose load failed runs without the library for the rest of
the run.  Built here first, every worker finds them fresh.  A build that
fails here is left to the packages' own builds, which report it.
"""
import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def _native_build(pkg: str):
    """``<pkg>/ops/native/build.py``, loaded by path: importing the
    package itself would load far more than its build script."""
    spec = importlib.util.spec_from_file_location(
        f"_prebuild_{pkg}", os.path.join(ROOT, pkg, "ops", "native",
                                         "build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pytest_configure(config):
    if hasattr(config, "workerinput"):      # an xdist worker
        return
    for pkg in ("librdkafka_tpu", "librdkafka_tpu_torch"):
        try:
            b = _native_build(pkg)
            b.build()
            b.build_enqlane()
        except Exception as e:
            print(f"conftest: {pkg}'s native build failed: {e!r}",
                  file=sys.stderr)
