"""Camera rays of every render finished in the window over the window's
measured seconds, in millions a second."""

from benchmark import stats


def read(run):
    return stats.rate(run.items, run.window_s) if run.kind == "render" \
        else None
