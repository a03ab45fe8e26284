"""Host milliseconds a tick in the program's ``ingest.discovery`` spans
(``repro_torch.tracing``: each discovery pass, ``infer_erp``: resize,
batch-1 forward, decode and copies back), over the window's untraced
ticks."""

from omnibench.program_spans import span_ms


def read(run):
    return span_ms(run, "ingest.discovery")
