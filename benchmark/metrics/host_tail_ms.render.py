"""Milliseconds of a render outside the port's build and chunk loop: the
sums' copy to the host, the mean, the tone mapping and the 8-bit image
(the request's wall less `render_linear`'s "build" and "trace" phases),
the mean over the window's renders."""

from benchmark import stats


def read(run):
    if run.kind != "render":
        return None
    return stats.mean([i["t1"] - i["t0"] - i["build"] - i["trace"]
                       for i in run.items]) * 1e3
