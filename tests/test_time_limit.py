"""The per-phase time limit of tests/_time_limit.py: a phase that runs past it
fails with an exception naming the test and the limit, a phase that ends in
time leaves no timer armed and the previous SIGALRM handler back, and a
test that ended its worker is not handed again from the scheduler's queue."""

import contextlib
import signal
import time
from types import SimpleNamespace

import pytest

from tests._time_limit import TIME_LIMIT_S, TimeLimitExceeded, skip_queued_crashitem, time_limit


@contextlib.contextmanager
def outside_the_phase_limit():
    """Pause the running phase's own limit, so that what the test reads of
    the timer and the handler is the inner context manager's doing alone;
    restore both after. Yields the time the phase had left."""
    handler = signal.getsignal(signal.SIGALRM)
    remaining = signal.setitimer(signal.ITIMER_REAL, 0)
    try:
        yield remaining[0]
    finally:
        signal.signal(signal.SIGALRM, handler)
        signal.setitimer(signal.ITIMER_REAL, *remaining)


def test_a_phase_past_its_limit_raises_naming_it():
    with outside_the_phase_limit():
        start = time.monotonic()
        with pytest.raises(TimeLimitExceeded) as raised:
            with time_limit("tests/x.py::test_sleeps", seconds=1):
                time.sleep(5)
        elapsed = time.monotonic() - start
        after = signal.getitimer(signal.ITIMER_REAL)
    assert elapsed < 2
    assert str(raised.value) == "tests/x.py::test_sleeps ran past its time limit of 1 s"
    assert after == (0.0, 0.0)


def test_a_phase_in_time_leaves_no_timer_armed():
    def before(signum, frame):
        pass

    with outside_the_phase_limit() as left:
        signal.signal(signal.SIGALRM, before)
        with time_limit("tests/x.py::test_passes"):
            armed = signal.getitimer(signal.ITIMER_REAL)[0]
            inside = signal.getsignal(signal.SIGALRM)
        after = signal.getitimer(signal.ITIMER_REAL)
        restored = signal.getsignal(signal.SIGALRM)
    assert 0 < left <= TIME_LIMIT_S  # this test's own call phase is armed
    assert TIME_LIMIT_S - 5 < armed <= TIME_LIMIT_S
    assert inside is not before
    assert after == (0.0, 0.0)
    assert restored is before


def test_a_crashed_test_is_not_run_again():
    """The shape of xdist's file-scoped scheduler after a worker died in
    ``f.py::b``: the file is back in the queue with ``b`` pending."""
    queued = {"f.py::a": True, "f.py::b": False, "f.py::c": False}
    other = {"g.py::b": False}
    sched = SimpleNamespace(workqueue={"f.py": queued, "g.py": other})
    skip_queued_crashitem(crashitem="f.py::b", sched=sched)
    assert queued == {"f.py::a": True, "f.py::b": True, "f.py::c": False}
    assert other == {"g.py::b": False}
    # a scheduler without file-scoped units (``--dist load``) is left alone
    skip_queued_crashitem(crashitem="f.py::b", sched=SimpleNamespace())
