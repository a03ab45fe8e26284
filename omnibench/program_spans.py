"""The program's own spans and counters (``repro_torch.tracing``, which
``PodServer.step`` fills tick by tick, numbered as the window's ticks),
read over the window's untraced ticks for the per-layer readers.

Each function returns None where the program has no tracer (a commit
before it) or kept none of those ticks, so that its reader reports
nothing there instead of raising."""

from __future__ import annotations


def _kept_ticks(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None, []
    kept = set(tracing.ticks())
    return tracing, [t for t in run.timed_ticks() if t.index in kept]


def span_ms(run, name: str, per: str = "tick"):
    """Milliseconds in spans ``name``, a tick (``per="tick"``) or a
    served frame (``per="frame"``)."""
    tracing, ticks = _kept_ticks(run)
    if not ticks:
        return None
    total = sum(tracing.tick_totals(t.index).get(name, (0.0,))[0]
                for t in ticks)
    n = len(ticks) if per == "tick" else sum(t.frames for t in ticks)
    return 1e3 * total / n if n else None


def counter_per_tick(run, name: str):
    """Counter ``name`` a tick."""
    tracing, ticks = _kept_ticks(run)
    if not ticks:
        return None
    return sum(tracing.tick_counters(t.index).get(name, 0)
               for t in ticks) / len(ticks)
