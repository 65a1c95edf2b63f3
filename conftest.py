"""Run-wide pytest settings that sit above `tests/conftest.py`: a watchdog
for every test, and the tests set aside as `slow`.

Every test runs under `watchdog(LIMIT)`: a test still running after LIMIT
seconds has every thread's stack printed and its process ended, so one hung
test fails alone (pytest-xdist replaces the worker) instead of holding the
whole run until an outer timeout cuts it.

`python -m pytest tests/ -m slow` runs the tests in SLOW; `-m 'not slow'`
leaves them out.
"""

import contextlib
import faulthandler
import os

import pytest

# Seconds one test (setup, call and teardown) may take: over twice the
# slowest test of the suite, test_regen's statistical match at ~257 s with
# six busy xdist workers.
LIMIT = 600

# Node ids marked `slow` here, beside their files. The streamed test
# forces the HBM-streamed triangle path on the 100,352-triangle door
# stand-in; its 256-triangle leaves are unrolled by Pallas interpret mode
# into a program whose CPU compile runs for many minutes.
SLOW = frozenset({
    "tests/test_pallas_trace.py::TestMeshWalk::"
    "test_streamed_leaf_dma_matches_resident",
})


@contextlib.contextmanager
def watchdog(limit):
    """End the process, printing every thread's stack, if the body runs past
    `limit` seconds.

    faulthandler's timer is a C thread, so it fires even while the main
    thread is blocked in native code (an XLA compile, a Pallas interpret
    loop), where a SIGALRM handler written in Python never runs. It writes
    to a duplicate of the real stderr: during a test, pytest's capture
    redirects fd 2 to a file that dies with the process."""
    with os.fdopen(os.dup(2), "w") as err:
        faulthandler.dump_traceback_later(limit, exit=True, file=err)
        try:
            yield
        finally:
            faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    # the whole protocol, so module-scoped fixtures set up for this test
    # (spawned worlds, compiled renderers) are under the limit too
    with watchdog(LIMIT):
        yield


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    # before the mark plugin's own hook, which deselects by `-m`
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


@pytest.hookimpl(optionalhook=True)
def pytest_handlecrashitem(crashitem, report, sched):
    """Under `--dist loadfile` pytest-xdist puts a crashed worker's unfinished
    file back in the queue, the test that crashed it included, so every
    replacement worker would run a hung test again until the restarts run
    out. Mark that test done: its crash is already reported as a failure,
    and the new worker runs only the rest of the file.

    The queue and `_split_scope` are private to pytest-xdist 3.8's
    LoadScopeScheduling; without them the hook does nothing."""
    queue = getattr(sched, "workqueue", None)  # loadscope and loadfile only
    split = getattr(sched, "_split_scope", None)
    if queue is None or split is None:
        return
    # absent when a live worker already took the file back: the test then
    # runs there once more
    scope = split(crashitem)
    if scope in queue:
        queue[scope][crashitem] = True
        if all(queue[scope].values()):
            del queue[scope]
