"""Set-up: process start to the first timed tick (imports, the seeded
weights, the videos and their rendered frame pool, the kernels' libraries,
every forward shape and the warm-up ticks)."""


def read(run):
    return run.setup_s
