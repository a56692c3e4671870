"""Where probe M's chain kernel spends its device time: variants of the
kernel that each leave out one stage, built from a checkout's
csrc/probes.cu and timed as phase 3e of chip_smoke.py times probe M.

    python3 shineon_tpu_torch/tools/chain_anatomy.py [--root DIR] [--tag NAME]

Each variant is ``csrc/probes.cu`` of the checkout under ``--root`` (by
default this one) with one text edit of its chain kernel (EDITS: a loop's
bound set to 0, or a store or a wait made conditional on a test that never
holds, so that the compiler keeps the rest), built with nvcc as
``ops/cuda_build.py`` builds a source, into this checkout's git-ignored
``_build/anatomy/``, loaded with ctypes and called on probe M's seeded
inputs of phase 3e. The full kernel is checked against ``probe_m_plain``;
the variants' outputs are wrong by design and not checked. Device time of
the chain kernel by name, L2 flushed before every call, 5 traces of 20
calls, the variants in turns (``chip_smoke.in_turns``), median (min-max).
It knows the chain kernels of this tree (``chain_wgmma``) and of the tree
before it (``chain_kernel``). Run it by path; prints a line a variant, then
one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

THIS_ROOT = Path(__file__).resolve().parents[2]

# (old text, new text) edits of each design's chain kernel, by variant
EDITS = {
    "chain_wgmma": {
        "no wgb copy": [("      mbar_arrive_expect_tx(&bars[1 + di], M_WGB_BOX);\n"
                         "      tma_load_3d(wgb_s + di * M_WGB_BOX, &wgbmap, MNT * nh, MNH * di, 0, "
                         "&bars[1 + di]);", "      mbar_arrive(&bars[1 + di]);")],
        "no stage one": [("for (int p4 = 0; p4 < MHR; ++p4) {", "for (int p4 = 0; p4 < 0; ++p4) {")],
        "no products": [("    for (int di = 0; di < 3; ++di)\n#pragma unroll\n      for (int ks",
                         "    for (int di = 0; di < 0; ++di)\n#pragma unroll\n      for (int ks")],
        "no stores": [("    *reinterpret_cast<float4*>(o + c) = ",
                       "    if (W2 < 0) *reinterpret_cast<float4*>(o + c) = ")],
    },
    "chain_kernel": {
        "no wgb copy": [("for (int j = tid; j < 3 * MNH * (MC2 / 8); j += blockDim.x) {",
                         "for (int j = tid; j < 0; j += blockDim.x) {")],
        "no stage one": [("for (int j = tid; j < MHR * MTW * MNH; j += blockDim.x) {",
                          "for (int j = tid; j < 0; j += blockDim.x) {")],
        "no stage two": [("  for (int di = 0; di < 3; ++di) {\n    const __nv_bfloat16* wd",
                          "  for (int di = 0; di < 0; ++di) {\n    const __nv_bfloat16* wd")],
        "no stores": [("      store2(out + ", "      if (W2 < 0) store2(out + ")],
    },
}
# chain_wgmma's timeline: thread 0 of each block stamps %globaltimer (ns)
# and clock64 (cycles) after each phase into the output (its stores left
# out): word 16 b of block b its start time, then the phases' cycles and
# nanoseconds since (STAMP_PHASES)
STAMP_PHASES = ("segmap rows in", "stage one done", "wgb in", "products issued",
                "products done", "sums stored")
STAMP_DEF = (
    "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;\n",
    "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;\n"
    "  uint32_t* st_ = reinterpret_cast<uint32_t*>(out) +\n"
    "      16 * ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);\n"
    "  long long c0_ = clock64();\n  uint64_t g0_;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0_));\n"
    "  if (threadIdx.x == 0) st_[0] = (uint32_t)g0_;\n")
STAMP_AT = (("  mbar_wait(&bars[0], 0);\n", False),  # (anchor, stamp before it)
            ("  fence_proxy_async();  // h's generic stores before the products' reads", True),
            ("    for (int di = 0; di < 3; ++di) mbar_wait(&bars[1 + di], 0);\n", False),
            ("    wgmma_commit();\n    wgmma_wait<0>();\n    fence_regs(acc);\n    // sum e", True),
            ("    // sum e is position", True),
            ("staged + pos * M_OPITCH + c);\n  }\n", False))


def stamp(k):
    return ("  { uint64_t g_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_));\n"
            f"    if (threadIdx.x == 0) {{ st_[{k}] = (uint32_t)(clock64() - c0_); "
            f"st_[{k + 8}] = (uint32_t)(g_ - g0_); }} }}\n")


# every design: an empty body (the launch, the block's start and end)
ENTRY = {"chain_wgmma": "  unsigned char* wgb_s = smem;  ",
         "chain_kernel": "  extern __shared__ __align__(16) unsigned char smem[];\n"}


def variants(src: str) -> dict:
    """{variant name: source} of the chain kernel in ``src``: "full", each
    edit of EDITS, and "empty" (the body returns at once)."""
    design = "chain_wgmma" if "chain_wgmma(" in src else "chain_kernel"
    out = {"full": src}
    for name, edits in EDITS[design].items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                print(f"chain_anatomy: {name} left out: its anchor occurs {text.count(old)} times "
                      f"in {design}'s source", flush=True)
                break
            text = text.replace(old, new)
        else:
            out[name] = text
    entry = ENTRY[design]
    if src.count(entry) != 1:
        raise SystemExit(f"chain_anatomy: no single entry anchor in {design}'s source")
    out["empty"] = src.replace(entry, "  if (W2 > 0) return;\n" + entry)
    if design == "chain_wgmma" and "no stores" in out and src.count(STAMP_DEF[0]) == 1:
        text = out["no stores"].replace(*STAMP_DEF)
        for k, (anchor, before) in enumerate(STAMP_AT, 1):
            if text.count(anchor) != 1:
                print(f"chain_anatomy: no timeline: stamp {k}'s anchor occurs "
                      f"{text.count(anchor)} times", flush=True)
                break
            text = text.replace(anchor, stamp(k) + anchor if before else anchor + stamp(k))
        else:
            out["stamps"] = text
    return out


def timeline(words, blocks):
    """{phase: (median, max) over blocks} of the stamps variant's words, in
    ns since the block's start (globaltimer) and cycles (clock64), and the
    spread of the blocks' start times."""
    w = words[:16 * blocks].reshape(blocks, 16).astype("int64") & 0xFFFFFFFF
    starts = w[:, 0] - w[:, 0].min()
    rows = {"block start (ns after the first block's)": (float(np.median(starts)),
                                                         float(starts.max()))}
    for k, name in enumerate(STAMP_PHASES, 1):
        rows[f"{name} (ns)"] = (float(np.median(w[:, k + 8])), float(w[:, k + 8].max()))
        rows[f"{name} (cycles)"] = (float(np.median(w[:, k])), float(w[:, k].max()))
    return rows


def build(name: str, text: str, csrc: Path, out_dir: Path) -> Path:
    from shineon_tpu_torch.ops.cuda_build import NVCC_FLAGS, _nvcc

    stem = name.replace(" ", "_")
    src, lib = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
    src.write_text(text)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"chain_anatomy: {name} failed to build:\n{proc.stdout[-4000:]}")
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(THIS_ROOT), help="checkout whose kernel is taken")
    ap.add_argument("--tag", default="", help="name printed with the results")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(THIS_ROOT))
    import torch

    from shineon_tpu_torch.ops import probes as pr
    from shineon_tpu_torch.ops.cuda_build import BUILD_DIR

    spec = importlib.util.spec_from_file_location("chip_smoke", THIS_ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("chain_anatomy: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    csrc = Path(args.root).resolve() / "shineon_tpu_torch" / "csrc"
    src = (csrc / "probes.cu").read_text()
    out_dir = BUILD_DIR / "anatomy" / (args.tag or "tree")
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = variants(src)
    with ThreadPoolExecutor(len(texts)) as pool:
        libs = dict(zip(texts, pool.map(lambda kv: build(*kv, csrc, out_dir), texts.items())))

    p, i = ctypes.c_void_p, ctypes.c_int
    inputs = tuple(cs.guarded(torch, t) for t in pr.random_inputs(
        "probe_m", 500 + list(pr.SPECS).index("probe_m"), cs.DEVICE))
    s, wsh, wgb = inputs
    G, rows, W2 = (s.shape[1] - 6) // pr.MC_TH, s.shape[1], s.shape[2]
    out = torch.empty((G, pr.MC_TH, W2, 128), dtype=torch.float32, device=cs.DEVICE)
    calls = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).probe_chain
        fn.restype = i
        fn.argtypes = [p] * 4 + [i] * 3 + [p]

        def call(fn=fn, name=name):
            err = fn(*(t.data_ptr() for t in (s, wsh, wgb, out)), G, rows, W2,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"chain_anatomy: {name}: launch failed ({err})")

        calls[name] = (call, cs.PROBE_KERNELS["chain"])
    flush = cs.L2Flush(torch)
    stamps = None
    if "stamps" in calls:  # a timeline of the last of 5 flushed calls
        for _ in range(5):
            flush()
            calls["stamps"][0]()
        torch.cuda.synchronize()
        blocks = 1
        for d in pr.chain_plan(G, rows, W2).grid:
            blocks *= d
        stamps = timeline(out.view(torch.int32).reshape(-1).cpu().numpy(), blocks)
        del calls["stamps"]
    calls["full"][0]()
    ok, err, ratio = pr.agrees("probe_m", out, pr.probe_m_plain(*inputs))
    print(f"chain_anatomy {args.tag}: {csrc / 'probes.cu'} [{card}]; the full kernel against "
          f"probe_m_plain: max_abs_err {err:.3g}, ratio {ratio:.3g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    with torch.no_grad():
        turns = cs.in_turns(torch, calls, flush)
    for name, t in turns.items():
        print(f"{name}: {cs.spread(t)} ms", flush=True)
    for name, (med, top) in (stamps or {}).items():
        print(f"timeline, {name}: median {med:.0f}, max {top:.0f}", flush=True)
    print(json.dumps(dict(tag=args.tag, root=str(Path(args.root).resolve()), card=card,
                          ok=ok, variants={k: dict(median=v["median"], min=v["min"],
                                                   max=v["max"]) for k, v in turns.items()},
                          timeline=stamps)),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
