"""Device milliseconds a step of the record megakernel's chunk launches
(`megakernel_record`), from the profiler over the traced steps."""


def read(run):
    if run.kind != "train" or run.profile is None:
        return None
    s = run.profile.kernel_seconds("megakernel_record")
    return s / len(run.profile.items) * 1e3 if s > 0 else None
