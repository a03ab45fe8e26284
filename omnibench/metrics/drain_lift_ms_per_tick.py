"""Host milliseconds a tick in the program's ``drain.lift`` spans
(``repro_torch.tracing``): each chunk's rows lifted to spherical boxes on
the host, over the window's untraced ticks."""

from omnibench.program_spans import span_ms


def read(run):
    return span_ms(run, "drain.lift")
