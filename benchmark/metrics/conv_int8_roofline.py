"""The int8 convs' share of their roofline: the least time of the tower's
66 conv groups at the cell's batch (``roofline.launch_bound_s`` over
``roofline.served_launches``, from the reference's layer table: 2 x MACs
at the int8 peak, or each group's input read once and its kernels and
outputs written once at the memory rate) over the device time per batch
of the kernels that run them."""

from benchmark import roofline

KERNELS = (r"conv_int8",)


def read(r):
    if r is None or r.trace is None or not r.units:
        return None
    spent = r.trace.kernel_s(KERNELS) / r.units
    if spent <= 0:
        return None
    im = r.config["image"]
    least = roofline.launch_bound_s(roofline.served_launches(im["image_size"],
                                                             im["depth_multiplier"]),
                                    r.rows, roofline.PEAK_OPS_S["int8"])
    return 100.0 * least / spent
