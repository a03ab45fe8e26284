"""The whole tick's share of the card's float32 peak: the benchmark's own
count of the convolution FLOPs of every detector forward served
(``omnibench.flops``), over the untraced window ticks' wall seconds times
67 TFLOP/s (TF32 is off)."""

from omnibench.peaks import F32_FLOPS


def read(run):
    ticks = run.timed_ticks()
    wall = sum(t.wall for t in ticks)
    if not ticks or wall <= 0:
        return None
    return 100.0 * sum(run.flops[t.index] for t in ticks) / (wall * F32_FLOPS)
