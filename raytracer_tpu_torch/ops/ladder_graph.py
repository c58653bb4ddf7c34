"""A tile's Whitted ladder replayed as a CUDA graph.

On the fused path (`trace.fused_ok`) everything `trace.trace_whitted` does
for a tile is fixed by the tile's width, the scene and the ladder's fields
of the RenderConfig: the pools' widths, the level-1 peel, the compaction
groups.  It never reads the card back inside a tile, and every kernel it
launches is enqueued on the current stream.  So the ladder of one tile is
captured once as a CUDA graph, from its primary rays (the graph's static
inputs) to its colour, casts and dropped rays (its static outputs), and
every later tile of that width replays it: one launch in place of a
tile's ~200 host dispatches.  A 1280x960 frame in tiles of 65,536 rays has
two widths, so two graphs.

`engages` decides from what the code can see: pools on a CUDA device, a
scene the fused kernels take, no caller's own level function.  Everything
else (the CPU, the unfused path, whose interior march reads the card
back) runs the ladder eagerly, as `trace` does for it.

Each width is captured twice.  The plain graph counts nothing, as the
eager ladder outside a recorded unit (utils/tracing).  The counted graph,
which a recorded unit replays, counts the tile as `trace_whitted` does
inside one: the lanes alive or owing radiance in each pool are summed, on
the card, into the graph's own `live` output, and the pools' widths are
noted on the host, so its replay adds both to the counters `ladder.live`
and `ladder.lanes` as the eager ladder would.  Those sums cost ~3 % of a
demo tile's device time on an H100, which an unrecorded frame does not
pay.  Each replay
also advances the ladder's launch counters as far as the capture noted
that one run advances them.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Callable, NamedTuple, Tuple

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import level_kernel
from raytracer_tpu_torch.ops import trace as trace_ops
from raytracer_tpu_torch.ops.trace import TraceResult, fused_ok
from raytracer_tpu_torch.scene.types import Scene
from raytracer_tpu_torch.utils import tracing

MAX_GRAPHS = 8  # ladders kept, least recently replayed dropped first
# The RenderConfig fields whose values the ladder bakes into its launches:
# widths, group, depth and the level kernel's scalar arguments.
LADDER_FIELDS = ("depth", "threshold", "max_refract_distance", "max_tir_retries",
                 "capacity_factor", "deep_capacity", "deep_slack", "tail_capacity",
                 "tail_slack", "compact_group")
# The launch counters a fused ladder advances.
COUNTERS = (level_kernel.COUNTS, level_kernel.COUNTS_BLK, trace_ops.DELIVER_COUNTS)

Trace = Callable[..., TraceResult]  # trace_whitted's signature


class Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    out: TraceResult  # its static outputs


@dataclasses.dataclass
class Ladder:
    """One tile width's captured ladder: its two graphs and the static
    inputs both read, what the counted one counts, and how far one run
    advances each of COUNTERS."""

    plain: Graph
    counted: Graph
    ray_o: torch.Tensor  # [n, 3] static inputs
    ray_d: torch.Tensor
    live: torch.Tensor  # int64 [depth - 1]: each counted pool's live lanes
    lanes: int  # the counted pools' widths, summed
    launches: Tuple[int, ...]


_LADDERS: "collections.OrderedDict[tuple, Ladder]" = collections.OrderedDict()
_WATCHED: set = set()  # ids of the scenes whose collection drops their ladders


def engages(scene: Scene, device, level_fn=None) -> bool:
    """Does a tile's ladder on `device` run as a graph?  Only on a CUDA
    device, for a scene the fused kernels take, with the default levels."""
    return torch.device(device).type == "cuda" and level_fn is None and fused_ok(scene)


def key(fn: Trace, scene: Scene, cfg: RenderConfig, width: int, device) -> tuple:
    """What a captured ladder is kept under: the scene, the traced function,
    the device, the tile's width and the ladder's fields of `cfg`."""
    return ((id(scene), fn, torch.device(device), width)
            + tuple(getattr(cfg, f) for f in LADDER_FIELDS))


def trace(fn: Trace, scene: Scene, ray_o, ray_d, cfg: RenderConfig, tile: int) -> TraceResult:
    """One tile's ladder, fn(scene, ray_o, ray_d, cfg) -> TraceResult: a
    replay of its graph where `engages`, else fn itself.  A replay's casts
    and dropped are the graph's own buffers, which its next replay
    overwrites: add them up before then.  Inside a recorded unit the tile
    adds 1 to the counter `ladder.tiles`, and a replay to `ladder.replays`."""
    tracing.count("ladder.tiles", 1)
    if not engages(scene, ray_o.device):
        return fn(scene, ray_o, ray_d, cfg)
    k = key(fn, scene, cfg, ray_o.shape[0], ray_o.device)
    ladder = _LADDERS.get(k)
    if ladder is None:
        return _capture(k, fn, scene, ray_o, ray_d, cfg)
    _LADDERS.move_to_end(k)
    with tracing.span("rt.ladder.replay", tile=tile):
        graph, out = ladder.counted if tracing.active() else ladder.plain
        ladder.ray_o.copy_(ray_o)
        ladder.ray_d.copy_(ray_d)
        graph.replay()
        for counter, n in zip(COUNTERS, ladder.launches):
            counter.launches += n
        tracing.count("ladder.replays", 1)
        if ladder.lanes:
            tracing.count("ladder.lanes", ladder.lanes)
            tracing.count("ladder.live", ladder.live)
        return out._replace(color=out.color.clone())


def _capture(k: tuple, fn: Trace, scene: Scene, ray_o, ray_d, cfg: RenderConfig) -> TraceResult:
    """Run the tile eagerly on a side stream (its result is the tile's),
    then capture its ladder, plain and counted, and keep it under `k`."""
    cur = torch.cuda.current_stream(ray_o.device)
    side = torch.cuda.Stream(ray_o.device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        res = fn(scene, ray_o, ray_d, cfg)
    cur.wait_stream(side)
    for t in res:
        t.record_stream(cur)

    static_o, static_d = ray_o.clone(), ray_d.clone()
    live = torch.empty((max(cfg.depth - 1, 0),), dtype=torch.int64, device=ray_o.device)
    pools, lanes = [], [0]

    def sink(name, value):
        if name == "ladder.lanes":
            lanes[0] += value
        elif name == "ladder.live":
            torch.sum(value.reshape(-1), dim=0, dtype=torch.int64, out=live[len(pools)])
            pools.append(value.numel())
        else:
            raise ValueError(f"the ladder's graph does not keep the counter {name!r}")

    def record(to):
        graph = torch.cuda.CUDAGraph()
        with tracing.redirect(to), torch.cuda.graph(graph, capture_error_mode="thread_local"):
            return Graph(graph, fn(scene, static_o, static_d, cfg))

    before = [c.launches for c in COUNTERS]
    with tracing.span("rt.ladder.capture"):
        plain = record(None)
        launches = tuple(c.launches - b for c, b in zip(COUNTERS, before))
        counted = record(sink)
    assert len(pools) == live.shape[0], (pools, live.shape)
    for c, b in zip(COUNTERS, before):  # the captures launched nothing
        c.launches = b
    _keep(k, scene, Ladder(plain, counted, static_o, static_d, live, lanes[0], launches))
    return res


def _keep(k: tuple, scene: Scene, ladder: Ladder) -> None:
    """Keep `ladder` under `k`, as long as `scene` lives, dropping the least
    recently replayed ladder beyond MAX_GRAPHS."""
    if id(scene) not in _WATCHED:
        _WATCHED.add(id(scene))
        weakref.finalize(scene, _forget, id(scene))
    _LADDERS[k] = ladder
    while len(_LADDERS) > MAX_GRAPHS:
        _LADDERS.popitem(last=False)


def _forget(scene_id: int) -> None:
    """Drop the ladders of a scene that was collected: its tables' memory,
    which they read, may be handed out again."""
    _WATCHED.discard(scene_id)
    for k in [k for k in _LADDERS if k[0] == scene_id]:
        del _LADDERS[k]
