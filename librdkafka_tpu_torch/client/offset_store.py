"""Legacy local file offset store (reference: src/rdkafka_offset.c:98-330).

``offset.store.method=file`` (topic conf, deprecated in the reference
but part of the surface): committed offsets are persisted to local text
files instead of the broker. Per toppar, the file is
``<offset.store.path>/<topic>-<partition>.offset`` when the path is a
directory (the reference's layout), else the configured path itself.
``offset.store.sync.interval.ms`` controls fsync: -1 never, 0 after
every write, >0 at most once per interval (reference rdkafka_offset.c:46
syncs from the main thread on that timer).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional, TYPE_CHECKING

from ..analysis.locks import new_lock
from ..analysis.races import shared

if TYPE_CHECKING:
    from .kafka import Kafka


class _OffsetFile:
    __slots__ = ("path", "fd", "last_sync", "dirty", "open_cb", "_fobj")

    def __init__(self, path: str, open_cb=None):
        self.path = path
        self.fd: Optional[int] = None
        self.last_sync = 0.0
        self.dirty = False
        self.open_cb = open_cb
        self._fobj = None       # keeps a cb-returned file object alive

    def open(self):
        if self.fd is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            if self.open_cb is not None:
                # app-supplied file-open hook (reference open_cb,
                # rdkafka_conf.c:524 — used for the offset store's
                # opens): cb(path, os_flags) -> OS fd or file object.
                # A file object must be HELD, not just fileno()'d —
                # dropping the last reference would close the fd
                f = self.open_cb(self.path, os.O_CREAT | os.O_RDWR)
                if isinstance(f, int):
                    self.fd = f
                else:
                    self._fobj = f
                    self.fd = f.fileno()
            else:
                self.fd = os.open(self.path,
                                  os.O_CREAT | os.O_RDWR, 0o644)

    def read(self) -> Optional[int]:
        self.open()
        os.lseek(self.fd, 0, os.SEEK_SET)
        data = os.read(self.fd, 64).strip()
        if not data:
            return None
        try:
            return int(data)
        except ValueError:
            return None

    def write(self, offset: int, sync_interval_ms: int):
        self.open()
        payload = b"%d\n" % offset
        os.lseek(self.fd, 0, os.SEEK_SET)
        os.write(self.fd, payload)
        os.ftruncate(self.fd, len(payload))
        self.dirty = True
        now = time.monotonic()
        if sync_interval_ms == 0 or (
                sync_interval_ms > 0
                and now - self.last_sync >= sync_interval_ms / 1000.0):
            os.fsync(self.fd)
            self.last_sync = now
            self.dirty = False

    def close(self):
        if self.fd is not None:
            if self.dirty:
                try:
                    os.fsync(self.fd)
                except OSError:
                    pass
            if self._fobj is not None:
                self._fobj.close()        # owns the fd
                self._fobj = None
            else:
                os.close(self.fd)
            self.fd = None


class FileOffsetStore:
    """All file-backed offsets for one client instance."""

    # the file-handle table is touched from store (app) and commit
    # (rdk:main) paths, always under offset_store.files
    _files = shared("offset_store.files_map")

    def __init__(self, rk: "Kafka"):
        self.rk = rk
        self._files: dict[tuple[str, int], _OffsetFile] = {}
        self._lock = new_lock("offset_store.files")

    def _file(self, topic: str, partition: int) -> _OffsetFile:
        key = (topic, partition)
        with self._lock:
            f = self._files.get(key)
            if f is None:
                base = self.rk.topic_conf_for(topic).get("offset.store.path")
                if os.path.isdir(base) or base.endswith(os.sep) or base == ".":
                    path = os.path.join(base, f"{topic}-{partition}.offset")
                else:
                    path = base
                f = _OffsetFile(path, self.rk.conf.get("open_cb"))
                self._files[key] = f
            return f

    def method(self, topic: str) -> str:
        """Effective offset.store.method for this topic
        (none | file | broker)."""
        return self.rk.topic_conf_for(topic).get("offset.store.method")

    def uses_file(self, topic: str) -> bool:
        return self.method(topic) == "file"

    def read(self, topic: str, partition: int) -> Optional[int]:
        try:
            return self._file(topic, partition).read()
        except OSError:
            return None

    def commit_all(self, offsets: dict) -> None:
        """Write {(topic, partition): offset} to their files."""
        for (t, p), off in offsets.items():
            ival = self.rk.topic_conf_for(t).get(
                "offset.store.sync.interval.ms")
            self._file(t, p).write(off, ival)

    def close(self) -> None:
        with self._lock:
            for f in self._files.values():
                f.close()
            self._files.clear()
