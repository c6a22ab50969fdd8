"""Host milliseconds a training step spends in the dataset's get_batch,
the mean over the traced run's measured window (the benchmark's span
`loader.get_batch` around the call)."""


def read(ctx):
    times = ctx.spans.times.get("loader.get_batch")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
