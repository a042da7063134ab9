"""The model FLOPs of a step (`counts/`, recomputation not counted) over the
window's mean step time and the dense TF32 peak, in %."""


def read(ctx):
    step_s = ctx["window_s"] / ctx["steps"]
    return 100.0 * ctx["flops_per_step"] / step_s / ctx["peaks"]["tf32_flops"]
