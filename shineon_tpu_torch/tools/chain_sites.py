"""Device time of the MultiSPADE chain kernels at every chain site of the
serving clips, for the port's package in a given checkout.

    python3 shineon_tpu_torch/tools/chain_sites.py [--root DIR] [--tag NAME]

``--root`` is the checkout whose ``shineon_tpu_torch`` is measured (by
default this one); to compare two commits on one card, unpack the other
(``git archive``) into a git-ignored directory and run the script once for
each, in turns. Run it by path, not with ``-m``, so that the package is the
one under ``--root``. At every site of ``chip_smoke.SITES`` (batch 4, bf16,
operands from ``chip_smoke.chain_inputs``) it takes the full-precision
chain and the quantized chain with its pre-pass, each by the summed device
time of its own kernels in a torch.profiler trace (``chip_smoke.device_ms``),
prints one line a site with the bound and the share of the peak, and last
one JSON object with every time, the card and the tag.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parents[2]
# kernel names of the chain bodies, in this tree and in the first design's
FP_KERNELS = ("chain_kernel_bf16",)
Q_KERNELS = ("chain_kernel_q", "hidden_absmax")


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
    results = []
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
    n_frames = 5
    clip = {key: sum(r[key] * r["per_frame"] * n_frames for r in results)
            for key in ("bf16_ms", "int8_ms")}
    print(f"per clip ({n_frames} frames): bf16 chain {clip['bf16_ms']:.2f} ms, int8 chain + "
          f"pre-pass {clip['int8_ms']:.2f} ms", flush=True)
    print(json.dumps({"tag": args.tag, "card": card, "per_clip_ms": clip, "sites": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
