"""Hooks of the test harness for the whole repo: every phase of every test runs
under ``tests/_time_limit.py``'s limit, and the opt-in full-resolution parity
gates stay out of a run that selects ``-m 'not slow'``."""

import os
import sys

import pytest

from tests._time_limit import skip_queued_crashitem, time_limit

# The real stderr, duplicated before capture takes fd 2 over, so that the
# faulthandler backstop's stacks reach the log of a worker it ends.
_STDERR = pytest.StashKey[int]()


def pytest_configure(config):
    config.stash[_STDERR] = os.dup(sys.__stderr__.fileno())


def pytest_unconfigure(config):
    if _STDERR in config.stash:
        os.close(config.stash[_STDERR])


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    """pytest.ini's addopts deselects the ``parity_full`` gates, but a ``-m``
    on the command line replaces addopts'. Mark them ``slow`` as well, before
    ``-m`` selects, so that ``-m 'not slow'`` leaves them out too; the opt-in
    ``-m parity_full --override-ini addopts=`` still runs them."""
    for item in items:
        if item.get_closest_marker("parity_full"):
            item.add_marker(pytest.mark.slow)


@pytest.hookimpl(optionalhook=True)
def pytest_handlecrashitem(crashitem, sched):
    skip_queued_crashitem(crashitem, sched)


def _phase_limit(item):
    return time_limit(item.nodeid, stderr=item.config.stash[_STDERR])


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _phase_limit(item):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _phase_limit(item):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    with _phase_limit(item):
        yield
