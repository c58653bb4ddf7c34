"""Starting and ending the processes of a run on several cards, one a card,
without importing torch: the parent of a run imports none, so the ranks
import it alone, at once.

A rank runs `target(rank, ready, out, *args)`, `target` named as
"module:function" (imported in the rank alone).  `ready` is an event of
the ranks' own (rank 0 sets it once it has counted the cards and built or
found the kernel library, rtbench/ranks.start), and `out` carries what a
rank hands back.  The parent ends every rank that is still running when it
stops waiting: after the deadline, or after a rank exits with another code
than 0.  A rank ends with the parent if the parent dies.
"""

from __future__ import annotations

import json
import multiprocessing
import multiprocessing.connection
import socket
import time


class Failed(Exception):
    """A run on several cards that printed no result; `code` is its exit code."""

    def __init__(self, msg: str, code: int = 1):
        super().__init__(msg)
        self.code = code


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    import ctypes
    import signal

    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except OSError:  # not Linux: the parent's stop() is the only end
        pass


def _rank(rank: int, ready, out, target: str, *args) -> None:
    import importlib

    _die_with_parent()
    module, name = target.split(":")
    getattr(importlib.import_module(module), name)(rank, ready, out, *args)


class Ranks:
    """`chips` spawned processes, started at once, each running `target`."""

    def __init__(self, target: str, args: tuple, chips: int):
        ctx = multiprocessing.get_context("spawn")
        self.ready, self.out = ctx.Event(), ctx.SimpleQueue()
        self.procs = [ctx.Process(target=_rank, args=(r, self.ready, self.out, target, *args),
                                  name=f"rank {r}", daemon=True) for r in range(chips)]
        for p in self.procs:
            p.start()

    def wait(self, deadline_s: float) -> list:
        """Wait for every rank to exit with 0 -> what they handed back, in
        order.  Raises Failed otherwise, with a rank's exit code where it is
        2 (too few cards) or 3 (a forbidden module loaded), else 1."""
        got, pending = [], list(self.procs)
        end = time.monotonic() + deadline_s
        while pending:
            left = end - time.monotonic()
            multiprocessing.connection.wait([p.sentinel for p in pending],
                                            timeout=max(0.1, min(2.0, left)))
            while not self.out.empty():
                got.append(self.out.get())
            for p in [p for p in pending if p.exitcode is not None]:
                pending.remove(p)
                if p.exitcode != 0:
                    raise Failed(f"{p.name} exited with code {p.exitcode}",
                                 p.exitcode if p.exitcode in (2, 3) else 1)
            if pending and left <= 0:
                raise Failed(f"the ranks did not end within {deadline_s:.0f} s")
        while not self.out.empty():
            got.append(self.out.get())
        return got

    def stop(self) -> None:
        """End every rank still running, and wait until each has ended."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join()


def on_ranks(spec: dict, chips: int, deadline_s: float, body: str = "rtbench.ranks:cell",
             *args) -> list:
    """`body` ("module:function"; `spec`: the fields of rtbench/runner.Spec)
    run on `chips` ranks (rtbench/ranks.main) -> what the ranks handed back."""
    ranks = Ranks("rtbench.ranks:main", (spec, chips, free_port(), body, *args), chips)
    try:
        return ranks.wait(deadline_s)
    finally:
        ranks.stop()


def run_cell(spec: dict, chips: int, deadline_s: float) -> dict:
    """One run of a cell on `chips` ranks -> rank 0's result line."""
    got = on_ranks(spec, chips, deadline_s)
    if len(got) != 1:
        raise Failed(f"rank 0 handed back {len(got)} result lines, not one")
    return json.loads(got[0])
