"""Device milliseconds a traced tick of the kernels launched inside the
vision tower (the ``omnibench.vision`` range around
``models/kimi_vl.py::image_tokens``: MoonViT and the projector on each
prefill chunk's crops)."""


def read(run):
    red = run.trace
    if not red or not red["n_ticks"] or "vision" not in red["in_range"]:
        return None
    return 1e3 * red["in_range"]["vision"] / red["n_ticks"]
