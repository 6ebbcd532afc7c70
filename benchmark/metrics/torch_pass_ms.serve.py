"""Device milliseconds per served batch in kernels that are neither the
int8 convs (``conv_int8_wgmma``, ``conv_int8_bytes``) nor the int8 max
pools (``maxpool_vec_kernel``, ``maxpool_scalar_kernel``): the torch
passes around them (preprocess, pool-branch activations, dequantisation,
text, head)."""

OURS = (r"conv_int8", r"maxpool_")


def read(r):
    if r is None or r.trace is None or not r.units or not r.trace.kernels:
        return None
    return 1e3 * r.trace.kernel_s(OURS, match=False) / r.units
