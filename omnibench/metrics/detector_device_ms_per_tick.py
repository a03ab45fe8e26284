"""Device milliseconds a traced tick of the kernels launched inside the
detector's forward (the ``omnibench.detector`` range around
``models/detector.py::apply``)."""


def read(run):
    red = run.trace
    if not red or not red["n_ticks"] or "detector" not in red["in_range"]:
        return None
    return 1e3 * red["in_range"]["detector"] / red["n_ticks"]
