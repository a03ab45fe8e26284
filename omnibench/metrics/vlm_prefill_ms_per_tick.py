"""Device milliseconds a traced tick of the kernels launched inside the
LM's prefill (the ``omnibench.vlm_prefill`` range around
``models/kimi_vl.py::prefill``, one a chunk)."""


def read(run):
    red = run.trace
    if not red or not red["n_ticks"] or "vlm_prefill" not in red["in_range"]:
        return None
    return 1e3 * red["in_range"]["vlm_prefill"] / red["n_ticks"]
