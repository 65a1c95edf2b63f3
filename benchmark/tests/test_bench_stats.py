"""The rates divide by the measured window and the tail is over every
step."""

import statistics
import time

import pytest
import torch

from benchmark import cells, generator, harness


def _run(kind, walls, window_s):
    t, items = 0.0, []
    for w in walls:
        items.append(dict(t0=t, t1=t + w, rays=1_000_000, trace=0.0,
                          build=0.0, fwd=None, bwd=None))
        t += w
    return harness.Run(kind=kind, items=items, window_s=window_s,
                       setup_s=1.0)


def test_rate_divides_by_the_measured_window_not_the_nominal():
    # a 2-second window whose last request ended at 2.5 s
    run = _run("render", [0.5] * 5, 2.5)
    assert cells.reader("render_mrays_s")(run) == 5 / 2.5
    run = _run("train", [0.5] * 5, 2.5)
    assert cells.reader("train_mrays_s")(run) == 5 / 2.5
    assert cells.reader("render_mrays_s")(run) is None


def test_window_ends_with_the_request_under_way():
    class Load:
        kind, device = "train", torch.device("cpu")

        def request(self, spans=False):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.03:
                pass
            return dict(t0=t0, t1=time.perf_counter(), rays=1)

    items, window_s = generator.window(Load(), 0.1)
    assert window_s >= 0.1
    assert abs(window_s - (items[-1]["t1"] - items[0]["t0"])) < 0.01


def test_p95_is_over_every_step():
    walls = [0.01] * 95 + [0.02] * 4 + [1.0]
    run = _run("train", walls, sum(walls))
    got = cells.reader("train_step_p95_ms")(run)
    want = statistics.quantiles(walls, n=20, method="inclusive")[18] * 1e3
    assert got == pytest.approx(want, rel=1e-12)
    # one more slow step moves it: every step counts
    run2 = _run("train", walls + [1.0] * 5, sum(walls) + 5)
    assert cells.reader("train_step_p95_ms")(run2) > got
