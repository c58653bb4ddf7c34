"""The port's own spans and counters (raytracer_tpu_torch/utils/tracing),
read by the per-layer readers in benchmark/metrics/.

The port records them while a torch.profiler records, so in a --trace 1
run they cover the traced window.  The first reader of a run takes the
record from the port and keeps it in the run's context for the others.
A port without the module, or a window that recorded nothing, gives None.
"""

from __future__ import annotations

KEY = "program_record"


def record(ctx):
    """The run's record (spans, counters), or None."""
    if KEY not in ctx:
        try:
            from raytracer_tpu_torch.utils import tracing
        except ImportError:
            ctx[KEY] = None
        else:
            rec = tracing.take()
            ctx[KEY] = rec if rec.spans or rec.counters else None
    return ctx[KEY]


def per_unit_ms(ctx, name: str, unit: str):
    """Host ms of the spans called `name`, summed, over the number of spans
    called `unit` (the frames or epochs recorded); None without either."""
    rec = record(ctx)
    if rec is None:
        return None
    units = sum(1 for s in rec.spans if s.name == unit)
    spans = [s for s in rec.spans if s.name == name]
    if not units or not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / units


def counter(ctx, name: str):
    rec = record(ctx)
    return None if rec is None else rec.counters.get(name)
