"""The train step's share of the card's peak in the configuration's
precision (its file's ``peak``: 989 TFLOP/s bf16, 67 TFLOP/s float32 with
TF32 off): 3 x the forward's operations per example (2 x MACs of every
conv, the aux and logits heads included, and of the joint head) times the
examples trained per second in the traced window."""

from benchmark import roofline
from benchmark.reference.model import layer_table


def read(r):
    if r is None or r.trace is None or not r.units or not r.trace.window_s:
        return None
    im, tx = r.config["image"], r.config["text"]
    convs = layer_table(im["image_size"], im["depth_multiplier"], im["num_classes"])
    feature = [c for c in convs if c.name.endswith("Logits/Conv2d_1c_1x1")][0].cin
    ops = roofline.forward_ops(convs) + 2.0 * (feature + tx["embed_dim"]) * im["num_classes"]
    return 100.0 * 3.0 * ops * r.units * r.rows / r.trace.window_s / roofline.PEAK_OPS_S[r.config["peak"]]
