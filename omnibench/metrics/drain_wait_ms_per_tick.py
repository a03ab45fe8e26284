"""Host milliseconds a tick in the program's ``drain.wait`` spans
(``repro_torch.tracing``): the host blocked in each chunk's three copies
back (boxes, scores, classes), over the window's untraced ticks."""

from omnibench.program_spans import span_ms


def read(run):
    return span_ms(run, "drain.wait")
