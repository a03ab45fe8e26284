"""Host milliseconds a tick in the program's ``drain.launch`` spans
(``repro_torch.tracing``): each chunk's projection, padding, and forward
and decode enqueued, over the window's untraced ticks."""

from omnibench.program_spans import span_ms


def read(run):
    return span_ms(run, "drain.launch")
