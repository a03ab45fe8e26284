"""Frames whose results are out, over the elapsed seconds of the window's
whole ticks (first tick's start to last tick's end)."""


def read(run):
    ticks = run.window.ticks
    if run.window.kind != "closed" or not ticks:
        return None
    return sum(t.frames for t in ticks) / (ticks[-1].end - ticks[0].start)
