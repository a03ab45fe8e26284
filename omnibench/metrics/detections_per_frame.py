"""Detections the detector served a frame (before the NMS), over the
window's ticks."""


def read(run):
    ticks = run.window.ticks
    frames = sum(t.frames for t in ticks)
    if not frames:
        return None
    return sum(run.pod.tick_counts(t.index)["served"]
               for t in ticks) / frames
