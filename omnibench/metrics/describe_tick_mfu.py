"""The region-description tick's share of the card's bfloat16 peak: the
benchmark's own count of the matrix-product FLOPs of every request
served, vision, prefill and decode at its rung (``omnibench.vlm_flops``),
over the untraced window ticks' wall seconds times 989 TFLOP/s
(``omnibench.peaks_bf16``)."""

from omnibench.peaks_bf16 import BF16_FLOPS


def read(run):
    if run.config.get("pod") != "describe":
        return None
    ticks = run.timed_ticks()
    wall = sum(t.wall for t in ticks)
    if not ticks or wall <= 0:
        return None
    return 100.0 * sum(run.flops[t.index] for t in ticks) / (wall
                                                             * BF16_FLOPS)
