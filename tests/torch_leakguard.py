"""The thread half of the port's leak guards.

A guard fails a test for a matching thread that the test started and
left running.  A matching thread that was alive before the test began is
another test's leak (under ``pytest -n`` an earlier file of the same
worker): it is reported on stderr with its name and not blamed here.
"""
import contextlib
import sys
import threading
import time


def _matching(match) -> list:
    return [t for t in threading.enumerate() if t.is_alive() and match(t.name)]


@contextlib.contextmanager
def no_new_threads(match, grace: float = 5.0):
    """Fail on exit if a thread whose name satisfies ``match`` and that
    was not alive on entry is still alive ``grace`` seconds after the
    body (time for a close() in progress to join its threads)."""
    before = set(_matching(match))
    for t in before:
        print(f"leak guard: thread {t.name!r} was alive before this test; "
              f"not blamed on it", file=sys.stderr)
    yield

    def left():
        return [t.name for t in _matching(match) if t not in before]
    deadline = time.monotonic() + grace
    while left() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not left(), f"leaked threads: {left()}"
