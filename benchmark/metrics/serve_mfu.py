"""The served step's share of the card's peak in the configuration's
precision (its file's ``peak``: 1,979 TOP/s int8): the tower's operations
per post (2 x MACs of the convs a served forward runs, from the
reference's layer table) times the posts answered per second in the traced
window."""

from benchmark import roofline


def read(r):
    if r is None or r.trace is None or not r.units or not r.trace.window_s:
        return None
    im = r.config["image"]
    ops = roofline.forward_ops(roofline.served_convs(im["image_size"], im["depth_multiplier"]))
    return 100.0 * ops * r.units * r.rows / r.trace.window_s / roofline.PEAK_OPS_S[r.config["peak"]]
