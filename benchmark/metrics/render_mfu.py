"""A whole render's share of the card's float32 peak: the counted
operations of its chunk launches (`peaks.render_work`) over the mean
render's wall seconds and the published peak."""

from benchmark import peaks, stats


def read(run):
    if run.kind != "render" or run.work is None:
        return None
    wall = stats.mean([i["t1"] - i["t0"] for i in run.items])
    return 100.0 * run.work[0] / wall / peaks.PEAK_FP32_FLOPS
