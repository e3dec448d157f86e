"""The port's leak guards (``torch_leakguard.no_new_threads`` behind the
autouse fixtures of test_torch_eos.py and test_torch_client.py) blame a
test only for the threads it started: a broker thread left alive by an
earlier test of the same worker is reported and passes, a thread started
inside the guarded body still fails it."""
import threading

import pytest

import test_torch_client
import test_torch_eos
from torch_leakguard import no_new_threads

GUARDS = {"eos": test_torch_eos.guarded_thread,
          "client": test_torch_client.guarded_thread}


def _parked(name: str):
    """A thread named ``name`` that runs until its event is set."""
    stop = threading.Event()
    th = threading.Thread(target=stop.wait, args=(30,), name=name,
                          daemon=True)
    th.start()
    return th, stop


@pytest.mark.parametrize("guard", list(GUARDS))
def test_thread_alive_before_the_test_is_not_blamed(guard, capsys):
    th, stop = _parked("rdk:broker/127.0.0.1:39753/1")
    try:
        with no_new_threads(GUARDS[guard], grace=0.2):
            pass
        assert "rdk:broker/127.0.0.1:39753/1" in capsys.readouterr().err
    finally:
        stop.set()
        th.join(5)
    assert not th.is_alive()


@pytest.mark.parametrize("guard", list(GUARDS))
def test_thread_started_inside_the_test_fails_the_guard(guard):
    old, stop_old = _parked("rdk:broker/127.0.0.1:1/1")
    new = stop_new = None
    try:
        with pytest.raises(AssertionError, match="rdk:broker/127.0.0.1:2/2") \
                as ei:
            with no_new_threads(GUARDS[guard], grace=0.2):
                new, stop_new = _parked("rdk:broker/127.0.0.1:2/2")
        assert "127.0.0.1:1/1" not in str(ei.value)
    finally:
        for stop in (stop_old, stop_new):
            if stop is not None:
                stop.set()
        for th in (old, new):
            if th is not None:
                th.join(5)
