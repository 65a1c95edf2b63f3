"""Milliseconds a render spends in the port's chunk loop: `render_linear`'s
"trace" phase (the chunks, each synchronized), the mean over the
window's renders."""

from benchmark import stats


def read(run):
    if run.kind != "render":
        return None
    return stats.mean([i["trace"] for i in run.items]) * 1e3
