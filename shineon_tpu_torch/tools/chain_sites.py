"""Device time of the serving kernels at every shape the clips give them,
for the port's package in a given checkout: the MultiSPADE chains at every
chain site, the int8 3x3 conv and SAGAN attention at every clip shape.

    python3 shineon_tpu_torch/tools/chain_sites.py [--root DIR] [--tag NAME]

``--root`` is the checkout whose ``shineon_tpu_torch`` is measured (by
default this one); to compare two commits on one card, unpack the other
(``git archive``) into a git-ignored directory and run the script once for
each, in turns. Run it by path, not with ``-m``, so that the package is the
one under ``--root``. At every site of ``chip_smoke.SITES`` (batch 4, bf16,
operands from ``chip_smoke.chain_inputs``) it takes the full-precision
chain and the quantized chain with its pre-pass, each by the summed device
time of its own kernels in a torch.profiler trace (``chip_smoke.device_ms``),
prints one line a site with the bound and the share of the peak; then the
int8 conv at every shape of ``chip_smoke.CONVS`` (bf16, its kernel's own
device time and that of every kernel the call launches, abs-max and
quantize pass included, beside cuDNN's bf16 conv of the shape) and
attention at every clip shape of ``chip_smoke.ATTENTION_SHAPES`` (beside
scaled_dot_product_attention at scale 1); last one JSON object with every
time, the card and the tag.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parents[2]
# kernel names of the bf16 bodies, in this tree and in earlier designs
FP_KERNELS = ("chain_kernel_bf16",)
Q_KERNELS = ("chain_kernel_q", "hidden_absmax")
CONV_KERNELS = ("conv_wgmma", "int8_conv3x3_kernel")
ATTENTION_KERNELS = ("attention_wgmma", "attention_bf16_kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(THIS_ROOT), help="checkout to measure")
    ap.add_argument("--tag", default="", help="name printed with the results")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from shineon_tpu_torch.ops import fused_spade as fs

    # this checkout's chip_smoke.py, whichever checkout --root names
    spec = importlib.util.spec_from_file_location("chip_smoke", THIS_ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("chain_sites: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"chain_sites {args.tag}: {fs.__file__} [{card}]", flush=True)
    results, n_frames = [], 5
    with torch.no_grad():
        for i, site in enumerate(cs.SITES):
            H, W, C, seg, per_frame, per_frame_att = site
            x, ab, segs, wshs, bshs, wgbs, bgbs = cs.to_device(
                cs.chain_inputs(torch, cs.BATCH, H, W, C, seg, torch.bfloat16, seed=i), cs.DEVICE)
            chain_args = (x, ab, segs, wshs, bshs, wgbs, bgbs)
            packed = fs.pack_weights(wshs, bshs, wgbs, bgbs, torch.bfloat16)
            packed_q = fs.pack_weights(wshs, bshs, wgbs, bgbs, torch.bfloat16, quantized=True)
            fp = cs.device_ms(torch, lambda: fs.fused_multispade_modulate(
                *chain_args, packed=packed), 5, FP_KERNELS)
            q = cs.device_ms(torch, lambda: fs.fused_multispade_modulate(
                *chain_args, packed=packed_q, quantized=True), 5, Q_KERNELS)
            flops, nbytes = cs.site_cost(cs.BATCH, H, W, C, seg, 2)
            fp_bound, _ = cs.bound(flops / cs.H100_BF16_FLOPS, nbytes)
            q_bound, _, _ = cs.int8_site_bound(cs.BATCH, H, W, C, seg)
            print(f"site B={cs.BATCH} H={H} W={W} C={C} {cs.seg_name(seg)} "
                  f"x{per_frame}/{per_frame_att}/frame: bf16 chain {fp:.4f} ms (bound "
                  f"{fp_bound:.4f}, {100 * fp_bound / fp:.1f}% of the peak); int8 chain + "
                  f"pre-pass {q:.4f} ms (bound {q_bound:.4f}, {100 * q_bound / q:.1f}%)",
                  flush=True)
            results.append(dict(H=H, W=W, C=C, seg=list(seg), per_frame=per_frame,
                                per_frame_att=per_frame_att, bf16_ms=fp, bf16_bound_ms=fp_bound,
                                int8_ms=q, int8_bound_ms=q_bound))
    clip = {key: sum(r[key] * r["per_frame"] * n_frames for r in results)
            for key in ("bf16_ms", "int8_ms")}
    print(f"per clip ({n_frames} frames): bf16 chain {clip['bf16_ms']:.2f} ms, int8 chain + "
          f"pre-pass {clip['int8_ms']:.2f} ms", flush=True)
    out = dict(tag=args.tag, card=card, per_clip_ms=clip, sites=results,
               convs=time_convs(torch, cs), attention=time_attention(torch, cs))
    print(json.dumps(out), flush=True)
    return 0


def time_convs(torch, cs):
    """The int8 conv's kernel at every conv shape of the int8 clip, bf16,
    with cuDNN's bf16 conv of the shape."""
    from shineon_tpu_torch.ops import int8_conv as ic

    rows = []
    with torch.no_grad():
        for i, (H, W, cin, cout, per_frame) in enumerate(cs.CONVS):
            g = torch.Generator().manual_seed(200 + i)
            x = torch.nn.functional.leaky_relu(torch.randn(cs.BATCH, H, W, cin, generator=g), 0.2)
            x = x.to(cs.DEVICE, torch.bfloat16)
            w = (torch.randn(cout, cin, 3, 3, generator=g) * (9 * cin) ** -0.5).to(cs.DEVICE)
            b = (0.1 * torch.randn(cout, generator=g)).to(cs.DEVICE)
            qw = ic.quantize_weight(w)
            dev = cs.device_times(torch, lambda: ic.conv3x3_int8(x, qw, b, torch.bfloat16), 5,
                                  {"conv": CONV_KERNELS, "all": None})
            ms, all_ms = dev["conv"], dev["all"]
            xn, wb, bb = x.permute(0, 3, 1, 2), w.bfloat16(), b.bfloat16()
            lib = cs.device_ms(torch, lambda: torch.nn.functional.conv2d(xn, wb, bb, padding=1), 5)
            bound, by, _ = cs.conv_kernel_bound(cs.BATCH, H, W, cin, cout)
            call_bound, call_by, _ = cs.conv_call_bound(cs.BATCH, H, W, cin, cout)
            print(f"conv B={cs.BATCH} H={H} W={W} {cin}->{cout} x{per_frame}/frame: kernel "
                  f"{ms:.4f} ms (bound {bound:.4f} ms, {by}, reading int8 x), every kernel of "
                  f"the call, abs-max and quantize pass included: {all_ms:.4f} ms (bound "
                  f"{call_bound:.4f} ms, {call_by}, x read once in bf16), cuDNN bf16 conv "
                  f"{lib:.4f} ms", flush=True)
            rows.append(dict(H=H, W=W, Cin=cin, Cout=cout, per_frame=per_frame, ms=ms,
                             call_ms=all_ms, cudnn_bf16_ms=lib, bound_ms=bound, bound_by=by,
                             call_bound_ms=call_bound, call_bound_by=call_by))
    clip = {k: sum(r[k] * r["per_frame"] * 5 for r in rows)
            for k in ("ms", "call_ms", "cudnn_bf16_ms", "bound_ms", "call_bound_ms")}
    print(f"int8 conv per clip: kernel {clip['ms']:.2f} ms (bound {clip['bound_ms']:.2f}), "
          f"every kernel of the calls {clip['call_ms']:.2f} ms (bound "
          f"{clip['call_bound_ms']:.2f}), cuDNN bf16 {clip['cudnn_bf16_ms']:.2f} ms", flush=True)
    return dict(per_clip_ms=clip, shapes=rows)


def time_attention(torch, cs):
    """The attention kernel at every clip shape, bf16, flat score rows, with
    scaled_dot_product_attention at scale 1."""
    from shineon_tpu_torch.ops import fused_attention as fa

    rows = []
    with torch.no_grad():
        for i, (N, d, dv, per_frame) in enumerate(cs.ATTENTION_SHAPES):
            if not per_frame:
                continue
            q, k, v = cs.attention_inputs(torch, N, d, dv, torch.bfloat16,
                                          cs.SCORE_STDS["flat"], seed=300 + i)
            ms = cs.device_ms(torch, lambda: fa.sagan_attention(q, k, v), 5, ATTENTION_KERNELS)
            lib = cs.device_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None], scale=1.0), 5)
            bound, by = cs.bound(2 * cs.BATCH * N * N * (d + dv) / cs.H100_BF16_FLOPS,
                                 cs.BATCH * N * (2 * d + 2 * dv) * 2)
            print(f"attention B={cs.BATCH} N={N} d={d} dv={dv} x{per_frame}/frame: kernel "
                  f"{ms:.4f} ms, SDPA {lib:.4f} ms, bound {bound:.4f} ms ({by})", flush=True)
            rows.append(dict(N=N, d=d, dv=dv, per_frame=per_frame, ms=ms, sdpa_ms=lib,
                             bound_ms=bound, bound_by=by))
    clip = {k: sum(r[k] * r["per_frame"] * 5 for r in rows) for k in ("ms", "sdpa_ms", "bound_ms")}
    print(f"attention per clip: kernel {clip['ms']:.2f} ms, SDPA {clip['sdpa_ms']:.2f} ms, "
          f"bound {clip['bound_ms']:.2f} ms", flush=True)
    return dict(per_clip_ms=clip, shapes=rows)


if __name__ == "__main__":
    sys.exit(main())
