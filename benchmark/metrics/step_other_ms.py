"""Device ms an epoch of everything but the MC walk's kernels: the draws,
the camera, the filter and counters, the accumulate, the renormalise's sort, the u8 encoding, the copies
(parallel/mesh.train_steps_sharded, ops/tonemap.post_process,
render.tile_draws); on several cards also the all-reduce, on the rank
that paces the epoch (readings.pacing)."""

from rtbench import readings


def read(ctx):
    if ctx["entry"] != "progressive":
        return None
    s = readings.pacing(ctx)
    total = sum(s["op_us"].values()) / 1e3
    return (total - readings.device_ms(s, readings.MC_KERNELS)) / ctx["units"]
