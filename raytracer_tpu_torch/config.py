"""Render configuration.

The reference hardcodes every knob in main() (src/main.rs:1084-1174:
1280x960, depth 5, 100 epochs, focus 3.0, blur 0.04, threshold 0.001,
max refract distance 100.0, 10 TIR retries).  Here they are a config
dataclass; the defaults reproduce the reference's values and equal those of
raytracer_tpu/config.py field for field.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 960
    # Bounce depth for both the Whitted and the distributed pass
    # (reference: src/main.rs:1098, src/main.rs:1139).
    depth: int = 5
    # Contribution cutoff of the Whitted tracer (src/main.rs:467).
    threshold: float = 0.001
    # Interior-march budget of get_refract (src/main.rs:378, call sites
    # src/main.rs:505/601 pass 100.0).
    max_refract_distance: float = 100.0
    max_tir_retries: int = 10
    # Distributed pass (src/main.rs:1129-1148).
    epochs: int = 100
    focus: float = 3.0
    blur: float = 0.04
    # Tone normalization percentile (src/main.rs:754 uses 0.99).
    percentile: float = 0.99

    # --- execution knobs (no reference equivalent) ---
    # Rays per tile; the image is rendered in tiles of this many pixels so
    # the wavefront pools stay bounded.
    tile_rays: int = 1 << 16
    # Whitted pool capacities, per tile (ops/trace.py).  The level-1 pool
    # holds capacity_factor * tile_rays slots (2.0 is exact: each live ray
    # emits at most two children); levels >= 2 and >= 3 run in narrower
    # pools plus a fixed slack.  Overflow is counted in
    # TraceResult.dropped, never silent.
    capacity_factor: float = 2.0
    deep_capacity: float = 1.375
    deep_slack: int = 2048
    tail_capacity: float = 1.25
    tail_slack: int = 4096
    # Rays move through compaction in groups of this many; 0 = auto
    # (ops/trace.py:_group, 8 lanes).
    compact_group: int = 0


# The reference binary's own settings (raytracer_tpu/config.py:85).
REFERENCE_CONFIG = RenderConfig()

# The BASELINE.json north-star frame (raytracer_tpu/config.py:88).
NORTH_STAR_CONFIG = RenderConfig(width=1024, height=1024)
