"""Host milliseconds a tick inside the drain span (the benchmark's wrapper
around the layer's public call), over the window's untraced ticks."""


def read(run):
    ticks = [t.index for t in run.timed_ticks()]
    if not ticks:
        return None
    return 1e3 * sum(run.spans.per_tick("drain", ticks)) / len(ticks)
