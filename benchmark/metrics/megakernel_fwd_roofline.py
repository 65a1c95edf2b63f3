"""The forward megakernel's share of its roofline: the least time the
published peaks allow for a render's counted operations and bytes
(`peaks.render_work`) over its chunk launches' device time."""

from benchmark import peaks


def read(run):
    if run.kind != "render" or run.profile is None or run.work is None:
        return None
    s = run.profile.kernel_seconds("megakernel_fwd")
    if s <= 0:
        return None
    per = s / len(run.profile.items)
    return 100.0 * peaks.least_seconds(*run.work) / per
