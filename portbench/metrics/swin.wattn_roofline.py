"""The window attention's share of its roofline: the least time of a step's
window-attention work (`counts/swin_unet.py::stage_bound_s_per_step`, handed
as `stage_bound_s`) over the device time a step of the kernels of
`spcl_torch/ops/csrc/wattn.cu` in the traced stretch. Nothing where no such
kernel ran."""
import re

WATTN_KERNELS = re.compile(r"\bwattn_(fwd|bwd|dbias)_kernel\b")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx.get("stage_bound_s") is None:
        return None
    us = sum(d for name, d in tr["kernels"] if WATTN_KERNELS.search(name))
    if not us:
        return None
    return 100.0 * ctx["stage_bound_s"] * tr["steps"] / (us / 1e6)
