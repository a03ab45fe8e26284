"""Host milliseconds a frame in ``OmniSenseLoop.begin_frame`` (SRoI
prediction and allocation), over the window's untraced ticks."""


def read(run):
    ticks = run.timed_ticks()
    frames = sum(t.frames for t in ticks)
    if not frames:
        return None
    return 1e3 * sum(run.spans.per_tick("plan", [t.index for t in ticks])) \
        / frames
