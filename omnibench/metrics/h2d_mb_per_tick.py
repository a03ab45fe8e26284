"""Frame bytes uploaded a tick, in MB (1e6 B), as the program counts them
(``repro_torch.tracing``'s ``h2d_bytes``: the staged frames and any frame
a chunk or discovery pass uploads again), over the window's untraced
ticks."""

from omnibench.program_spans import counter_per_tick


def read(run):
    n = counter_per_tick(run, "h2d_bytes")
    return None if n is None else n / 1e6
