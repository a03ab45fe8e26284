"""Detector requests (one crop each) a served frame, over the window's
ticks: the work the allocator put on the card, so that a change in the
traffic shows apart from a change in speed."""


def read(run):
    ticks = run.window.ticks
    frames = sum(t.frames for t in ticks)
    if not frames:
        return None
    return sum(run.pod.tick_counts(t.index)["requests"]
               for t in ticks) / frames
