"""Host milliseconds a served frame in the program's ``emit.allocate``
spans (``repro_torch.tracing``: the knapsack DP, ``allocation.allocate``,
or the pod-level solve), over the window's untraced ticks."""

from omnibench.program_spans import span_ms


def read(run):
    return span_ms(run, "emit.allocate", per="frame")
