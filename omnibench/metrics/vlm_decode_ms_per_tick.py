"""Device milliseconds a traced tick of the kernels launched inside the
tick's decode (the ``omnibench.vlm_decode`` range around
``models/kimi_vl.py::generate``: the latent cache filled and every
greedy step of the tick's requests in one batch)."""


def read(run):
    red = run.trace
    if not red or not red["n_ticks"] or "vlm_decode" not in red["in_range"]:
        return None
    return 1e3 * red["in_range"]["vlm_decode"] / red["n_ticks"]
