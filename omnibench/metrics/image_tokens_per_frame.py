"""Image tokens a served frame: the program's ``vlm.image_tokens``
counter (MoonViT's merged tokens of every crop described) a tick, over
the frames a tick of the window's untraced ticks (the recorder keeps
the last 256 ticks, more than a window holds)."""

from omnibench.program_spans import counter_per_tick


def read(run):
    per_tick = counter_per_tick(run, "vlm.image_tokens")
    ticks = run.timed_ticks()
    frames = sum(t.frames for t in ticks)
    if not per_tick or not frames:
        return None
    return per_tick * len(ticks) / frames
