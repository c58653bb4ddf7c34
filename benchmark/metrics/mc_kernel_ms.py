"""Device ms an epoch of the MC walk's kernels (csrc/mc_kernel.cu through
ops/distributed: the dense `mc_kernel_staged`, the blocked
`mc_kernel<CoopGeom>`); on several cards on the rank that paces the epoch
(readings.pacing)."""

from rtbench import readings


def read(ctx):
    if ctx["entry"] != "progressive":
        return None
    return readings.per_unit(ctx, readings.MC_KERNELS, readings.pacing(ctx))
