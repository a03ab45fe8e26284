"""Candidate plans a served frame that the knapsack DP generates and
prunes (``repro_torch.tracing``'s ``alloc.candidates``, counted once an
``allocation.allocate`` call: the feasible (plan, model) pairs summed over
its columns), over the window's untraced ticks.  Beside
``allocate_ms_per_frame`` it tells a faster DP from a smaller one.

None where the program does not count them (a commit before the
counter), as where it has no tracer."""

from omnibench.program_spans import _kept_ticks


def read(run):
    tracing, ticks = _kept_ticks(run)
    counts = [tracing.tick_counters(t.index).get("alloc.candidates")
              for t in ticks]
    if all(c is None for c in counts):
        return None
    frames = sum(t.frames for t in ticks)
    return sum(c or 0 for c in counts) / frames if frames else None
