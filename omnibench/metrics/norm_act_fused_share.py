"""Share of the detector's norm-activation tails that ran as the fused
kernel: 100 x ``launch.groupnorm_mish`` (the kernel's launches) over
``norm_act.calls`` (``models/detector.py::_conv_bn``'s calls, whichever
path ran), ``repro_torch.tracing``'s counters over the window's untraced
ticks.  100 where every conv block of every forward took the kernel.

None where the program counts neither (a commit before them), as where
it has no tracer."""

from omnibench.program_spans import _kept_ticks


def read(run):
    tracing, ticks = _kept_ticks(run)
    counts = [tracing.tick_counters(t.index) for t in ticks]
    calls = sum(c.get("norm_act.calls", 0) for c in counts)
    fused = sum(c.get("launch.groupnorm_mish", 0) for c in counts)
    return 100.0 * fused / calls if calls else None
