"""spade_chain_int8_roofline: the int8 SPADE chains' share of their
roofline, %: the bound of the chain's work at every SPADE site of the clip
(benchmark/roofline.py::chain_bound_int8: the hidden conv once at the bf16
peak, [gamma | beta] at the int8 peak, bytes once) over the device time a
marked clip spends in the kernels named here. Layer: kernels
(csrc/fused_multispade.cu)."""

from benchmark import roofline

KERNELS = ("chain_kernel_q_bf16", "hidden_absmax_kernel")


def read(ctx):
    tr = ctx.trace
    spent = sum(e[2] - e[1] for e in tr.device_events() if any(k in e[0] for k in KERNELS))
    if not tr.clips or spent <= 0:
        return None
    per_clip_s = spent / 1e6 / len(tr.clips)
    return 100.0 * roofline.clip_chain_bound(ctx.opt, ctx.batch, int8=True) / per_clip_s
