"""The share of the traced window in which the device ran nothing,
during renders."""


def read(run):
    if run.kind != "render" or run.profile is None:
        return None
    return 100.0 * (1.0 - run.profile.busy_s / run.profile.window_s)
