"""Device time of the 15 layout probe kernels and of the one PyTorch call
that computes each, and of the conv probe's two tap-product kernels at its
four shapes, for the port's package in a given checkout.

    python3 shineon_tpu_torch/tools/probe_sites.py [--root DIR] [--tag NAME]

``--root`` is the checkout whose ``shineon_tpu_torch`` is measured (by
default this one); to compare two commits on one card, unpack the other
(``git archive``) into a git-ignored directory and run the script once for
each, in turns (parent, change, change, parent). Run it by path, not with
``-m``, so that the package is the one under ``--root``; the protocol is
this checkout's ``chip_smoke.py``, whichever checkout ``--root`` names. Each
probe runs on its seeded inputs of phase 3e (``probes.random_inputs``, at
the head of NaN-filled buffers), is checked against its plain version, then
timed by ``chip_smoke.time_layout_probe``: the kernel (its family's kernels
by name) and the library call (every kernel but the flush), 5 traces of 20
calls each, in turns, with L2 flushed before every call; median (min-max)
device time a call, beside the bound. Then the conv probe's mmonly and
taps9bf16 kernels at tools/conv_probe.py's four batch-16 shapes, on the
operands of phase 3e (``chip_smoke.conv_variant_operands``: the weight's
tap images made once, before any timed call, where the package has them),
each checked against its plain version and timed by
``chip_smoke.time_conv_variant``: in turns with the int8 conv kernel and,
for taps9bf16, cuDNN's bf16 conv of the same operands, 5 traces of 5 calls,
L2 flushed before every call. Prints one line a probe or conv, then one
JSON object with every time, the card and the tag.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(THIS_ROOT), help="checkout to measure")
    ap.add_argument("--tag", default="", help="name printed with the results")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from shineon_tpu_torch.ops import int8_conv as ic
    from shineon_tpu_torch.ops import probes as pr
    from shineon_tpu_torch.tools.conv_probe import SHAPES

    spec = importlib.util.spec_from_file_location("chip_smoke", THIS_ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("probe_sites: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"probe_sites {args.tag}: {pr.__file__} [{card}]", flush=True)
    flush = cs.L2Flush(torch)
    rows, failed = {}, []
    for i, name in enumerate(pr.SPECS):
        inputs = tuple(cs.guarded(torch, t) for t in pr.random_inputs(name, 500 + i, cs.DEVICE))
        out, ref = pr.WRAPPERS[name](*inputs), pr.plain_version(name)(*inputs)
        torch.cuda.synchronize()
        ok, err, _ = pr.agrees(name, out, ref)
        if not ok:
            failed.append(name)
            print(f"{name}: FAIL against its plain version (max_abs_err {err:.4g})", flush=True)
            continue
        t = cs.time_layout_probe(torch, pr, name, inputs, flush)
        k, lib = t["turns"]["kernel"], t["turns"].get("library")
        print(f"{name} ({pr.SPECS[name].family}): kernel {cs.spread(k)} ms, library "
              f"{'none' if lib is None else cs.spread(lib)} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}, {100 * t['bound_share']:.1f}% of the kernel's time)",
              flush=True)
        rows[name] = dict(family=pr.SPECS[name].family, kernel=k, library=lib,
                          library_kernels=t["library_kernels"], bound_ms=t["bound_ms"],
                          bound_by=t["bound_by"])
    convs = {}
    for j, shape in enumerate(SHAPES):
        operands = cs.conv_variant_operands(torch, pr, ic, shape, 600 + j)
        v, qw, xp, scale, bias = operands
        for name in pr.CONV_VARIANTS:
            out = pr.WRAPPERS[name](xp, qw, scale, bias)
            ok, err, _ = pr.agrees(name, out, pr.plain_version(name)(xp, qw, scale, bias))
            del out
            if not ok:
                failed.append(f"{name} {shape}")
                print(f"{name} {shape}: FAIL against its plain version (max_abs_err {err:.4g})",
                      flush=True)
                continue
            t = cs.time_conv_variant(torch, pr, ic, name, operands, flush)
            k, c, lib = t["turns"]["kernel"], t["turns"]["int8_conv"], t["turns"].get("library")
            print(f"{name} {shape}: kernel {cs.spread(k)} ms, int8 conv kernel {cs.spread(c)} ms, "
                  f"library {'none' if lib is None else cs.spread(lib)} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
                  f"{100 * t['bound_ms'] / k['median']:.1f}% of the kernel's time)", flush=True)
            convs[f"{name} {'x'.join(map(str, shape))}"] = dict(
                kernel=k, int8_conv=c, library=lib, library_kernels=t["library_kernels"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], bf16_floor_ms=t["bf16_floor_ms"])
        del v, qw, xp, operands
    print(json.dumps(dict(tag=args.tag, root=str(Path(args.root).resolve()), card=card,
                          probes=rows, convs=convs, failed=failed)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
