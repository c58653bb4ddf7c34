"""Device ms a Whitted frame of the level kernel and the ordered delivery
(csrc/level_kernel.cu `level_kernel`, csrc/deliver.cu `deliver_kernel`)."""

from rtbench import readings

KERNELS = ("level_kernel", "deliver_kernel")


def read(ctx):
    if ctx["entry"] != "whitted":
        return None
    return readings.per_unit(ctx, KERNELS)
