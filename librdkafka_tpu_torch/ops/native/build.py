"""Build the native libraries (g++ → .so), cached by mtime.

The port's copy of librdkafka_tpu/ops/native/build.py.  Two artifacts:
  _codec.so           — plain shared library reached via ctypes (codec.cpp,
                        then lz4_pack.cpp, the device lz4 route's staging)
  tk_torch_enqlane.so — CPython extension module (enqlane.cpp with
                        codec.cpp linked in; ctypes call overhead would
                        eat the enqueue lane's win).  Its module name is
                        the port's own, so the JAX package's
                        ``tk_enqlane`` and this one load side by side.
"""
from __future__ import annotations

import fcntl
import os
import subprocess
import sysconfig
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "codec.cpp")
PACK_SRC = os.path.join(_DIR, "lz4_pack.cpp")
SO = os.path.join(_DIR, "_codec.so")
ENQ_NAME = "tk_torch_enqlane"
ENQ_SRC = os.path.join(_DIR, "enqlane.cpp")
ENQ_SO = os.path.join(_DIR, ENQ_NAME + ".so")
_lock = threading.Lock()
_load_lock = threading.Lock()
_enqlane = None         # the loaded extension module
_enqlane_err = None     # or why it could not be built or loaded


def _fresh(so: str, srcs: list[str]) -> bool:
    return (os.path.exists(so)
            and all(os.path.getmtime(so) >= os.path.getmtime(s)
                    for s in srcs))


def _compile(src, so: str, extra: list[str]) -> str:
    srcs = [src] if isinstance(src, str) else list(src)
    if _fresh(so, srcs):
        return so
    # one compile of an artifact at a time across processes: parallel
    # workers wait for the first g++ run and load its output
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh(so, srcs):
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               *extra, "-o", tmp, *srcs]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{e.stderr}") from e
        os.replace(tmp, so)
    return so


def _loadable(so: str) -> bool:
    """A shipped .so can be foreign (sdist built on another arch/libc);
    trust it only if ctypes can actually load it."""
    import ctypes
    try:
        ctypes.CDLL(so)
        return True
    except OSError:
        return False


def build(force: bool = False) -> str:
    """Compile codec.cpp and lz4_pack.cpp to a shared library if stale;
    returns the .so path."""
    with _lock:
        if force and os.path.exists(SO):
            os.remove(SO)
        so = _compile([SRC, PACK_SRC], SO, ["-fvisibility=hidden"])
        if not _loadable(so):
            os.remove(so)               # wrong-platform prebuilt: rebuild
            so = _compile([SRC, PACK_SRC], SO, ["-fvisibility=hidden"])
        return so


def build_enqlane(force: bool = False) -> str:
    """Compile the tk_torch_enqlane CPython extension if stale; returns
    its path.  codec.cpp is linked in too: the fused batch builder
    (build_batch) calls its framing/codec/CRC functions directly."""
    with _lock:
        if force and os.path.exists(ENQ_SO):
            os.remove(ENQ_SO)
        inc = sysconfig.get_paths()["include"]
        return _compile([ENQ_SRC, SRC], ENQ_SO, ["-I" + inc])


def load_enqlane():
    """Import the tk_torch_enqlane extension module (building if stale).
    A shipped wrong-platform binary gets one rebuild before giving up."""
    import importlib.machinery
    import importlib.util

    def _load(path):
        loader = importlib.machinery.ExtensionFileLoader(ENQ_NAME, path)
        spec = importlib.util.spec_from_loader(ENQ_NAME, loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        return mod

    try:
        return _load(build_enqlane())
    except ImportError:
        return _load(build_enqlane(force=True))


def enqlane():
    """The tk_torch_enqlane module, built and loaded once a process, or
    None when that failed (:func:`enqlane_error` says why).  The enqueue
    lane (client/arena.py) and the batched codec calls (ops/cpu.py) both
    read this one cache."""
    global _enqlane, _enqlane_err
    if _enqlane is None and _enqlane_err is None:
        with _load_lock:
            if _enqlane is None and _enqlane_err is None:
                try:
                    _enqlane = load_enqlane()
                except Exception as e:
                    _enqlane_err = f"{type(e).__name__}: {e}"
    return _enqlane


def enqlane_error() -> str | None:
    """Why :func:`enqlane` returned None, or None."""
    return _enqlane_err
