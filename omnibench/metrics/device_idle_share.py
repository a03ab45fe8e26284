"""Share of the traced ticks' wall time (first tick start to last tick end,
on the trace's clock) in which no operation ran on the device."""


def read(run):
    red = run.trace
    if not red or red["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
