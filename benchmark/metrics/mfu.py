"""mfu: the whole clip's share of the card's dense bf16 peak, %: the
generator's analytic conv FLOPs (benchmark/roofline.py) of every frame of
every marked clip over the traced window's seconds, against 989 TFLOP/s,
in both modes (in int8 a lower bound). The warp, flow composite and
preprocessing FLOPs are not counted. Layer: models (models/sams_model.py,
the whole clip)."""

from benchmark import roofline


def read(ctx):
    tr = ctx.trace
    if not tr.clips or tr.window_s <= 0:
        return None
    flops = ctx.frames * roofline.generator_flops(ctx.opt, ctx.batch) * len(tr.clips)
    return 100.0 * flops / tr.window_s / roofline.BF16_FLOPS
