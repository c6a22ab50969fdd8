"""Host milliseconds a tile spends in the CUDA runtime's copies between
host and card and in the waits of those copies (cudaMemcpyAsync,
cudaMemcpy, cudaStreamSynchronize), from the profiler's host events over
the profiled tiles."""

CALLS = {"cudaMemcpyAsync", "cudaMemcpy", "cudaStreamSynchronize"}


def read(ctx):
    if ctx.trace is None or not ctx.measured.get("trace_units"):
        return None
    return 1e3 * ctx.trace.host_seconds(CALLS) / ctx.measured["trace_units"]
