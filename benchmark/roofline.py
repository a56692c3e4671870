"""The benchmark's frozen arithmetic: the card's published peaks, the
operations and bytes of the SAMS generator's work, and its SPADE chains'
roofline bounds. The work comes from a configuration's shapes, never from
the kernels that happen to run it.

Peaks: NVIDIA H100 SXM data sheet, dense rates: 989 TFLOP/s bf16, 1979
TOP/s int8, 3.35 TB/s HBM3.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.reference.sams_clip import LABEL_CHANNELS, NHID, _blocks, enc_label_nc, label_keys

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def _conv(px, cin, cout, k):
    return 2.0 * k * k * cin * cout * px


def spade_sites(opt: dict, batch: int) -> List[Tuple[int, int, int, int, tuple]]:
    """Every SPADE site of one generator call: (B, H, W, C, segmap channels
    a label), in call order."""
    H, W = opt["fine_height"], opt["fine_width"]
    enc, cur = (enc_label_nc(opt),), tuple(LABEL_CHANNELS[k] for k in label_keys(opt))
    blocks = _blocks(opt)
    n_enc = sum(1 for b in blocks if b[0].startswith("encode"))
    sites, dec = [], 0
    for name, fin, fout, kind in blocks:
        if name.startswith("encode"):
            level = int(name.split("_")[1])
        elif name.startswith("middle"):
            level = n_enc
        else:
            level, dec = n_enc - 1 - dec, dec + 1
        seg = enc if kind == "enc" else cur
        h, w = H >> level, W >> level
        widths = ([fin] if fin != fout else []) + [fin, min(fin, fout)]
        sites += [(batch, h, w, c, seg) for c in widths]
    return sites


def generator_flops(opt: dict, batch: int) -> float:
    """The conv FLOPs of one generator call (every SPADE's three convs,
    the resblocks' convs, the in and out convs); the warp, flow composite
    and preprocessing are not counted. At the production options this is
    the serving bench's analytic count (12.35 TFLOP at batch 16)."""
    H, W = opt["fine_height"], opt["fine_width"]
    num_prev = max(opt["n_frames_total"] - 1, 1)
    ngf_out = opt["ngf_base"] ** opt["ngf_pow_outer"]
    out_ch = 4 if opt["flow_warp"] else 3
    total = _conv(batch * H * W, 3 * num_prev, ngf_out, 3) + _conv(batch * H * W, ngf_out, out_ch, 3)
    for B, h, w, c, seg in spade_sites(opt, batch):
        total += sum(_conv(B * h * w, cs, NHID, 3) + 2 * _conv(B * h * w, NHID, c, 3) for cs in seg)
    blocks = _blocks(opt)
    n_enc = sum(1 for b in blocks if b[0].startswith("encode"))
    dec = 0
    for name, fin, fout, _ in blocks:
        if name.startswith("encode"):
            level = int(name.split("_")[1])
        elif name.startswith("middle"):
            level = n_enc
        else:
            level, dec = n_enc - 1 - dec, dec + 1
        px = batch * (H >> level) * (W >> level)
        fmid = min(fin, fout)
        total += _conv(px, fin, fmid, 3) + _conv(px, fmid, fout, 3)
        if fin != fout:
            total += _conv(px, fin, fout, 1)
    return total


def _bound(op_seconds: float, nbytes: float) -> float:
    """Seconds: the larger of the operations' time at the peaks and the
    bytes' time at the memory rate."""
    return max(op_seconds, nbytes / HBM_BYTES_PER_S)


def chain_bound_bf16(B, H, W, C, seg) -> float:
    """Seconds the bf16 chain needs at a site: both 3x3 convs of every
    label at the bf16 peak; x read and y written once, the segmaps and
    weights read once in bf16, the folded norms and biases in f32."""
    cs, L, px = sum(seg), len(seg), B * H * W
    flops = 2 * 9 * px * (cs * NHID + L * NHID * 2 * C)
    nbytes = (2 * px * C + px * cs + 9 * cs * NHID + L * 9 * NHID * 2 * C) * 2 + 4 * (
        L * NHID + L * 2 * C + B * L * 2 * C)
    return _bound(flops / BF16_FLOPS, nbytes)


def chain_bound_int8(B, H, W, C, seg) -> float:
    """Seconds the int8 chain needs at a site: the hidden conv once at the
    bf16 peak (the work the chain needs; a pre-pass that computes it again
    is not counted), the [gamma | beta] conv at the int8 peak; x, y,
    segmaps and hidden weights in bf16, the [gamma | beta] weights in int8,
    each moved once, with the f32 biases, scales, folded norms and hidden
    abs-maxima."""
    cs, L, px = sum(seg), len(seg), B * H * W
    hid_flops = 2 * 9 * px * cs * NHID
    gb_ops = 2 * 9 * px * L * NHID * 2 * C
    nbytes = (2 * (2 * px * C + px * cs + 9 * cs * NHID) + L * 9 * NHID * 2 * C
              + 4 * (L * NHID + 2 * L * 2 * C + B * L * 2 * C + L))
    return _bound(hid_flops / BF16_FLOPS + gb_ops / INT8_OPS, nbytes)


def clip_chain_bound(opt: dict, batch: int, int8: bool) -> float:
    """Seconds the SPADE chains of one clip (every site of every frame)
    need at their bound."""
    f = chain_bound_int8 if int8 else chain_bound_bf16
    return opt["n_frames_total"] * sum(f(*site) for site in spade_sites(opt, batch))
