"""Milliseconds of a step's forward half: the port's chunk and the loss,
synchronized, the mean over the window's steps."""

from benchmark import stats


def read(run):
    if run.kind != "train" or run.items[0]["fwd"] is None:
        return None
    return stats.mean([i["fwd"] for i in run.items]) * 1e3
