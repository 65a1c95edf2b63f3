"""The 95th percentile of every step of the window, each timed from its
start to the synchronize after its loss is read."""

from benchmark import stats


def read(run):
    if run.kind != "train":
        return None
    return stats.p95([i["t1"] - i["t0"] for i in run.items]) * 1e3
