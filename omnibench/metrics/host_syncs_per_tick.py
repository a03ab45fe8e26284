"""Calls a tick that block the host on the device, as the program counts
them (``repro_torch.tracing``'s ``host_syncs``: copies back, pinned
buffers' event waits, synchronizations), over the window's untraced
ticks; the benchmark's own end-of-tick sync is not among them."""

from omnibench.program_spans import counter_per_tick


def read(run):
    return counter_per_tick(run, "host_syncs")
