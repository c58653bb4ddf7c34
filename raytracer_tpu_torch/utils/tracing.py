"""Program spans and counters, recorded only while a torch.profiler records.

A unit of work (a Whitted frame, an MC epoch) opens with `unit`, which asks
the profiler once whether it is recording.  Inside a recorded unit, `span`
records a named interval and `count` adds to a named counter.  Outside one,
`unit` (with the profiler off) and `span` return one shared null context
and `count` returns at once: no clock is read, no object is made and
nothing runs on the card.

A recorded span is stamped with time.time_ns(), the clock of Kineto's host
events, and is mirrored on the profiler's host timeline by a FUNCTION-scope
range of the same name (torch._C._profiler._RecordFunctionFast), so an idle
gap of the device trace can be named after the span it falls in.  A
USER_SCOPE range (torch.profiler.record_function) would not do: Kineto
copies those onto the device's timeline too, where they would read as
device activity.

While a CUDA graph is captured, `redirect(sink)` hands every count to the
graph's own sink in place of the recorder, whose buffers a graph must not
bake in: `active()` holds and no span is recorded; `redirect(None)` counts
and records nothing (ops/ladder_graph.py).

`take()` hands over what was recorded since the last take: the spans in the
order they opened, each with its parent's index and its unit's id, and each
counter's total.  A tensor counted on the card is summed there, by one
reduction into a slot of the recorder's buffer of its dtype, and stays there
until `settle()` (the Whitted frame calls it where it already waits for the
card), `take()`, or a buffer's last slot filling reads the buffer in one
copy.  The recorder counts its own device work as two counters of its own:
`tracing.sums` (its reductions) and `tracing.reads` (its copies to the
host), so that a count of a traced window's device operations can leave
them out.

Span names start with `rt.`.  Units and spans of one process share one
recorder; the render calls them from one thread and counts on one device.
A profiler left on with no take() fills the record up to MAX_SPANS spans;
later units are not recorded until a take() empties it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

PREFIX = "rt."
SLOTS = 256  # device counts a buffer holds
MAX_SPANS = 200_000  # of the record between two takes (a frame makes ~250, an epoch 5)
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns()
    end_ns: int
    parent: Optional[int]  # index of the enclosing span in the same take(); None for a unit
    unit: Any  # id of the unit the span lies in (a frame's number, an epoch)
    attrs: dict


class Record(NamedTuple):
    spans: List[Span]
    counters: Dict[str, int]


class Recorder:
    """What the process has recorded since the last take."""

    def __init__(self):
        self.on = False  # inside a recorded unit
        self.uid = None  # that unit's id
        self.rows: list = []  # [name, start, end, parent, unit, attrs], in opening order
        self.stack: list = []  # indices of the open rows
        self.counts: Dict[str, int] = {}
        # dtype -> (buffer, the counter of each slot used), not yet read
        self.device: dict = {}
        self.numbers: Dict[str, int] = {}  # units opened so far, by name
        self.sink = None  # redirect()'s receiver of counts, or None

    def _add(self, name: str, value: int) -> None:
        self.counts[name] = self.counts.get(name, 0) + value

    def add(self, name: str, value: torch.Tensor) -> None:
        """Sum `value` on its device into the next slot of the buffer of its
        dtype (int64 for a mask): one reduction (an integer tensor), no read."""
        dtype = torch.int64 if value.dtype == torch.bool else value.dtype
        if dtype in self.device and len(self.device[dtype][1]) == SLOTS:
            self.settle()  # full: read now (a frame counts ~80, far fewer than SLOTS)
        if dtype not in self.device:
            self.device[dtype] = (torch.empty(SLOTS, dtype=dtype, device=value.device), [])
        buf, names = self.device[dtype]
        torch.sum(value.reshape(-1), dim=0, dtype=dtype, out=buf[len(names)])
        names.append(name)
        self._add("tracing.sums", 1)

    def settle(self) -> None:
        """Read the device counts into the host totals: one copy a buffer,
        which waits for the card."""
        for buf, names in self.device.values():
            for name, v in zip(names, buf[:len(names)].tolist()):
                self._add(name, int(v))
            self._add("tracing.reads", 1)
        self.device = {}

    def take(self) -> Record:
        if self.stack:
            raise RuntimeError(f"take() inside the open span {self.rows[self.stack[-1]][0]}")
        self.settle()
        spans = [Span(*row) for row in self.rows]
        counts, self.rows, self.counts = self.counts, [], {}
        return Record(spans, counts)


_REC = Recorder()


class _Open:
    """A recorded span, open while its `with` block runs."""

    __slots__ = ("name", "uid", "attrs", "row", "fast", "outer")

    def __init__(self, name: str, uid, attrs: dict):
        self.name, self.uid, self.attrs = name, uid, attrs

    def __enter__(self):
        rec = _REC
        self.outer = (rec.on, rec.uid)
        if self.uid is not None:
            rec.on, rec.uid = True, self.uid
        self.fast = torch._C._profiler._RecordFunctionFast(self.name)
        self.fast.__enter__()
        self.row = [self.name, time.time_ns(), None, rec.stack[-1] if rec.stack else None,
                    rec.uid, self.attrs]
        rec.stack.append(len(rec.rows))
        rec.rows.append(self.row)
        return self

    def __exit__(self, *exc):
        self.row[2] = time.time_ns()
        rec = _REC
        rec.stack.pop()
        rec.on, rec.uid = self.outer
        self.fast.__exit__(*exc)
        return False


def unit(name: str, uid=None):
    """A top-level unit of work: recorded, with its spans and counters, if a
    torch.profiler is recording as it opens.  uid: its id (default: the
    number of units of this name opened before it while recording)."""
    if not (_REC.on or torch._C._autograd._profiler_enabled()) or len(_REC.rows) >= MAX_SPANS:
        return _NULL
    if uid is None:
        uid = _REC.numbers.get(name, 0)
        _REC.numbers[name] = uid + 1
    return _Open(name, uid, {})


def span(name: str, **attrs):
    """A span inside the open unit (nothing outside a recorded one)."""
    if not _REC.on:
        return _NULL
    return _Open(name, None, attrs)


def active() -> bool:
    """Is a unit being recorded, or are counts redirected?  Guards work done
    only to be counted."""
    return _REC.on or _REC.sink is not None


def count(name: str, value) -> None:
    """Add `value` to counter `name` inside a recorded unit: a host int, or
    the sum of an integer tensor, taken on its device and read at settle().
    Under redirect(), hand both to its sink instead."""
    if _REC.sink is not None:
        _REC.sink(name, value)
        return
    if not _REC.on:
        return
    if isinstance(value, torch.Tensor):
        _REC.add(name, value)
    else:
        _REC._add(name, int(value))


@contextlib.contextmanager
def redirect(sink):
    """Inside the block every count(name, value) calls sink(name, value),
    active() holds, and no span is recorded: what a CUDA graph's capture
    counts becomes the graph's own output, and what its Python does is not
    mistaken for work on the card.  sink None: nothing is counted or
    recorded, and active() does not hold."""
    if _REC.sink is not None:
        raise RuntimeError("counts are already redirected")
    outer = (_REC.on, _REC.sink)
    _REC.on, _REC.sink = False, sink
    try:
        yield
    finally:
        _REC.on, _REC.sink = outer


def settle() -> None:
    """Read the device counters recorded so far (waits for the card)."""
    _REC.settle()


def take() -> Record:
    """The spans and counters recorded since the last take(); clears them."""
    return _REC.take()
