"""spade_chain_bf16_roofline: the bf16 SPADE chains' share of their
roofline, %: the bound of the chain's work at every SPADE site of the clip
(benchmark/roofline.py::chain_bound_bf16: both convs at the bf16
peak, bytes once) over the device time a
marked clip spends in the kernels named here. Layer: kernels
(csrc/fused_multispade.cu)."""

from benchmark import roofline

KERNELS = ("chain_kernel_bf16",)


def read(ctx):
    tr = ctx.trace
    spent = sum(e[2] - e[1] for e in tr.device_events() if any(k in e[0] for k in KERNELS))
    if not tr.clips or spent <= 0:
        return None
    per_clip_s = spent / 1e6 / len(tr.clips)
    return 100.0 * roofline.clip_chain_bound(ctx.opt, ctx.batch, int8=False) / per_clip_s
