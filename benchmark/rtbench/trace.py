"""Reading a torch.profiler trace: device activity, busy and idle, the top
device operations and the host operations that idle gaps fall in.

The reading arithmetic follows raytracer_tpu_torch/utils/profiling.py
(self device time by operation name), over the raw Kineto events so that
a window's bounds, its idle gaps and each unit's interval can be read:
device events are the kernels, copies and sets the profiler saw on the
card; the window and each unit (epoch group, frame) are marked by
`record_function` ranges named MARK + what.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

MARK = "rtbench."
NAME_CHARS = 160  # of an operation's name in the breakdown (C++ template names run to kB)


@contextlib.contextmanager
def profiled(device_type: str):
    """torch.profiler over the block -> the profiler: CPU and CUDA activity
    on a card; on the CPU (the harness's tests) the host's alone, so the
    window holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device_type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


def mark(what: str):
    return torch.profiler.record_function(MARK + what)


def _ns(e, which):
    if which == "start":
        return e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
    return e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000


def events(prof):
    """(device [(start_ns, end_ns, name)], host [(start_ns, end_ns, name)]).
    Kineto draws a user annotation (a record_function range: the MARK
    ranges, c10d's "nccl:all_reduce") on the device's timeline too, under
    the name of its host range: those copies are not device activity and
    are left out."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = _ns(e, "start")
        span = (s, s + _ns(e, "duration"), e.name())
        (dev if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(span)
    names = {h[2] for h in host}
    dev = sorted(d for d in dev if d[2] not in names and not d[2].startswith(MARK))
    return dev, host


def merged(intervals, lo, hi):
    """Union of (start, end, ...) intervals clipped to [lo, hi], sorted."""
    out = []
    for s, e, *_ in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _HostIndex:
    """Host events binned by time, to find the innermost one at an instant."""

    BIN_NS, LONG_BINS = 500_000, 2000

    def __init__(self, spans):
        self.bins, self.long = defaultdict(list), []
        for h in spans:
            a, b = h[0] // self.BIN_NS, h[1] // self.BIN_NS
            if b - a > self.LONG_BINS:
                self.long.append(h)
            else:
                for k in range(a, b + 1):
                    self.bins[k].append(h)

    def innermost(self, t) -> str:
        cover = [h for h in self.bins.get(t // self.BIN_NS, []) + self.long if h[0] <= t <= h[1]]
        return min(cover, key=lambda h: h[1] - h[0])[2] if cover else "(no host operation)"


def summary(prof, units_mark: str, n_top: int = 10) -> dict:
    """This process's reading of its traced window:
      window_s, busy_s (the union of device activity inside the window),
      device_ops (events inside it), op_us {name: device us},
      units [(host s, busy s, device ops)] of each MARK+units_mark range,
      top_ops [[name, s]] and idle_gaps [[host op, s]] (gaps summed by the
      innermost host operation running at their middle)."""
    dev, host = events(prof)
    marks = [h for h in host if h[2] == MARK + "window"]
    if not marks:
        raise RuntimeError("the trace holds no window mark")
    lo, hi = marks[0][0], marks[0][1]
    inside = [d for d in dev if d[0] >= lo and d[1] <= hi]
    busy = merged(inside, lo, hi)
    op_us = defaultdict(float)
    for s, e, name in inside:
        op_us[name] += (e - s) / 1e3
    units = []
    for s, e, _ in sorted(h for h in host if h[2] == MARK + units_mark):
        ds = [d for d in inside if d[0] >= s and d[1] <= e]
        units.append(((e - s) / 1e9, sum(b - a for a, b in merged(ds, s, e)) / 1e9, len(ds)))
    gaps = defaultdict(float)
    at = _HostIndex([h for h in host if not h[2].startswith(MARK)])
    edges = [lo] + [x for b in busy for x in b] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[at.innermost((a + b) // 2)] += (b - a) / 1e9
    top = sorted(op_us.items(), key=lambda kv: -kv[1])[:n_top]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "device_ops": len(inside),
        "op_us": dict(op_us),
        "units": units,
        "top_ops": [[name[:NAME_CHARS], us / 1e6] for name, us in top],
        "idle_gaps": [[n[:NAME_CHARS], s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:n_top]],
    }
