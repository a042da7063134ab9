"""The fused stage kernels' share of their roofline: the least time of the
passes a step runs (`counts/stage_bounds.py`) over their measured device
time a step, from the kernels of `spcl_torch/ops/csrc/convstage.cu` in the
traced stretch. Nothing where no stage kernel ran."""
import re

STAGE_KERNELS = re.compile(r"\b(conv_fwd|conv_bwd|conv_fwd_bf16|conv_bwd_bf16|bnpool|poolsums"
                           r"|poolsums_bf16|dz1|convstage_reduce)_kernel\b")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx.get("stage_bound_s") is None:
        return None
    us = sum(d for name, d in tr["kernels"] if STAGE_KERNELS.search(name))
    if not us:
        return None
    return 100.0 * ctx["stage_bound_s"] * tr["steps"] / (us / 1e6)
