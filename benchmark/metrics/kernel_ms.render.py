"""Device milliseconds a render of the forward megakernel's chunk launches
(`megakernel_fwd`), from the profiler over the traced renders."""


def read(run):
    if run.kind != "render" or run.profile is None:
        return None
    s = run.profile.kernel_seconds("megakernel_fwd")
    return s / len(run.profile.items) * 1e3 if s > 0 else None
