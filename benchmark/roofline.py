"""The yardstick's peaks and work counts: the least time the chip could take.

Peaks of one NVIDIA H100 SXM (the data sheet, dense rates, at the full
700 W limit): 1,979 TOP/s int8, 989 TFLOP/s bf16, 67 TFLOP/s float32
outside the tensor cores (TF32 off), 3.35 TB/s of HBM.  The
work is counted from the reference's own layer table (``layer_table``, a
pass on the meta device), so it reads the same whatever implements it.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from benchmark.reference.model import TOWER, Conv, layer_table

PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12

# The tower's convs that a served forward runs: neither the aux head nor
# the tower's own logits (the joint head serves the answer).
HEADS = (TOWER + "AuxLogits/", TOWER + "Logits/")

# Bytes of each element an int8 conv writes: int8 activations, except the
# average-pool branches' 1x1 (run before its pool, with which it commutes:
# the int32 pre-activation, so that the window sums are exact) and the
# last block's outputs, the feature the float head reads (bf16).
FEATURE = tuple(TOWER + "Mixed_7c/" + s for s in (
    "Branch_0/Conv2d_0a_1x1", "Branch_1/Conv2d_0b_1x3", "Branch_1/Conv2d_0c_3x1",
    "Branch_2/Conv2d_0c_1x3", "Branch_2/Conv2d_0d_3x1"))


def out_bytes(c: Conv) -> int:
    if "/Branch_3/" in c.name:
        return 4
    return 2 if c.name in FEATURE else 1


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """Least seconds: the larger of the operations over the peak rate and
    the bytes (each input read once, each output written once) over the
    memory rate."""
    return max(ops / peak, nbytes / HBM_BYTES_S)


def served_convs(image_size: int = 299, depth_multiplier: float = 1.0) -> List[Conv]:
    return [c for c in layer_table(image_size, depth_multiplier)
            if not c.name.startswith(HEADS)]


def served_launches(image_size: int = 299, depth_multiplier: float = 1.0) -> List[List[Conv]]:
    """The served convs as groups that read one input: the 1x1 stride-1
    convs that open a block's branches all read the block's input, so they
    are one group (one wide conv, the input read once); every other conv
    is a group of its own.  66 groups at depth 1."""
    launches: List[List[Conv]] = []
    openers: Dict[str, List[Conv]] = {}
    seen = set()
    for c in served_convs(image_size, depth_multiplier):
        block, _, rest = c.name.partition("/")
        branch = rest.split("/")[0] if rest else None
        first = branch is not None and (block, branch) not in seen
        seen.add((block, branch))
        if first and c.kernel == (1, 1) and c.stride == 1:
            if block not in openers:
                openers[block] = []
                launches.append(openers[block])
            openers[block].append(c)
        else:
            launches.append([c])
    return launches


def launch_bound_s(launches: Iterable[List[Conv]], batch: int, peak: float) -> float:
    """Sum over ``launches`` of each one's least time at ``batch`` images:
    2 x MACs at ``peak``, or its int8 input read once, its int8 kernels and
    its outputs (``out_bytes`` an element) written once, at the memory
    rate."""
    total = 0.0
    for group in launches:
        x = group[0]
        nbytes = batch * x.in_hw[0] * x.in_hw[1] * x.cin
        for c in group:
            nbytes += c.cout * c.cin * c.kernel[0] * c.kernel[1] + \
                out_bytes(c) * batch * c.out_hw[0] * c.out_hw[1] * c.cout
        total += bound_s(2.0 * sum(c.macs() for c in group) * batch, nbytes, peak)
    return total


def forward_ops(convs: Iterable[Conv]) -> float:
    """Operations (2 x MACs) of one image through ``convs``."""
    return 2.0 * sum(c.macs() for c in convs)
