"""A time limit for each phase of a test (setup, call, teardown), wired in by
the repo's root ``conftest.py``.

A phase past the limit fails alone, with an exception naming the test and the
limit, and its worker goes on to the next test. xdist runs tests on the
worker's main thread, so SIGALRM is delivered where the test runs.
"""

import contextlib
import faulthandler
import signal
import sys

# About three times the longest phase measured on the CPU (154 s); a module
# fixture's build counts against the first test that sets it up.
TIME_LIMIT_S = 480


class TimeLimitExceeded(Exception):
    pass


@contextlib.contextmanager
def time_limit(nodeid, seconds=TIME_LIMIT_S, stderr=None):
    """Raise ``TimeLimitExceeded`` naming ``nodeid`` once ``seconds`` have
    passed. SIGALRM interrupts only Python code: a hang inside native code
    (a compile, a blocked socket) is ended ``seconds + 60`` s in by
    faulthandler, which writes every thread's stack to ``stderr`` (a file
    or a descriptor) and exits the process; xdist then replaces the worker."""

    def _raise(signum, frame):
        raise TimeLimitExceeded(f"{nodeid} ran past its time limit of {seconds} s")

    previous = signal.signal(signal.SIGALRM, _raise)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    faulthandler.dump_traceback_later(
        seconds + 60, exit=True, file=sys.__stderr__ if stderr is None else stderr
    )
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


def skip_queued_crashitem(crashitem, sched):
    """Mark ``crashitem`` done where its file waits in the queue of xdist's
    file-scoped scheduler (``--dist loadfile``), which takes a crashed
    worker's file back with that test still pending; its replacement would
    run it, and hang, again. A file that the scheduler has already handed to
    another worker while taking the crashed one down runs the test again:
    its bookkeeping there is left as it is, since it names the next crash."""
    for unit in getattr(sched, "workqueue", {}).values():
        if crashitem in unit:
            unit[crashitem] = True
