"""The per-test watchdog of the repository's root conftest.py, run on a tiny
pytest session in a subprocess with a 2-s limit: a test that blocks is ended
with its stack printed, and a quick test under the same limit passes. In one
process that ends the session; under `--dist loadfile` it ends the worker,
and the replacement worker runs the rest of the file, not the blocked test
again."""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

CONFTEST = Path(__file__).parents[1] / "conftest.py"

PROBE = """
import time

def test_quick():
    time.sleep(0.5)

def test_blocks_forever():
    time.sleep(600)

def test_after():
    pass
"""


def _session(tmp_path, *args):
    """Run PROBE under the suite's watchdog and crash hook, 2-s limit."""
    (tmp_path / "conftest.py").write_text(textwrap.dedent(f"""
        import importlib.util
        import time

        import pytest

        spec = importlib.util.spec_from_file_location(
            "suite_conftest", {str(CONFTEST)!r})
        suite = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(suite)
        pytest_handlecrashitem = suite.pytest_handlecrashitem

        @pytest.hookimpl(hookwrapper=True)
        def pytest_runtest_protocol(item, nextitem):
            if item.name == "test_blocks_forever":
                with open("armed_at", "w") as f:
                    f.write(repr(time.monotonic()))
            with suite.watchdog(2):
                yield
        """))
    (tmp_path / "test_probe.py").write_text(PROBE)
    # no plugins from entry points (some import JAX, ~2.6 s a process);
    # xdist is loaded by `-p` where a session needs it
    env = {**os.environ, "PYTEST_DISABLE_PLUGIN_AUTOLOAD": "1"}
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         *args, "test_probe.py"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=60)
    out = run.stdout
    assert run.returncode != 0, out
    assert out.count("Timeout (0:00:02)!") == 1, out
    assert "in test_blocks_forever" in out, out
    return out


def test_watchdog_ends_a_blocked_test_and_names_it(tmp_path):
    out = _session(tmp_path, "-p", "no:xdist")
    assert "test_probe.py::test_quick PASSED" in out, out
    # from the moment the blocked test's watchdog was armed: the session's
    # own start-up is not the watchdog's to bound
    waited = time.monotonic() - float((tmp_path / "armed_at").read_text())
    assert 2 <= waited < 10, (waited, out)


def test_loadfile_runs_the_rest_of_the_file_on_a_new_worker(tmp_path):
    out = _session(tmp_path, "-p", "xdist", "-n", "1", "--dist", "loadfile")
    assert "replacing crashed worker gw0" in out, out
    assert "PASSED test_probe.py::test_quick" in out, out
    assert "[gw1]" in out and "PASSED test_probe.py::test_after" in out, out
    assert "1 failed, 2 passed" in out, out
