"""Milliseconds of a step's backward half: the closed-form adjoint, Adam
and the loss read back, synchronized, the mean over the window's
steps."""

from benchmark import stats


def read(run):
    if run.kind != "train" or run.items[0]["bwd"] is None:
        return None
    return stats.mean([i["bwd"] for i in run.items]) * 1e3
