"""The benchmark's own count of the detector's convolution work a served
frame (``omnibench.flops``: every request and discovery pass), in GFLOP,
over the window's ticks; times ``frames_per_s`` it is the work rate."""


def read(run):
    ticks = run.window.ticks
    frames = sum(t.frames for t in ticks)
    if not frames:
        return None
    return sum(run.flops[t.index] for t in ticks) / frames / 1e9
