#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (shineon_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: torch's device name and count, and nvidia-smi's name and
     power limit;
  2. build the hand-written kernels from csrc/ (one nvcc a source, all at
     once) and print their ptxas reports; fail unless the bf16 serving
     bodies run on wgmma fed by bulk or tensor-map copies (cuobjdump's
     SASS: HGMMA in the bf16 chain and attention, IGMMA in the quantized
     chain and the int8 conv; UBLKCP or UTMALDG in each; the chains' every
     hidden-activation instance; likewise IGMMA in the conv probe's mmonly
     kernel, HGMMA in its taps9bf16 kernel, in probe M's chain kernel and in
     the probes' contraction kernel) and ptxas reports no spills for them
     nor for the three transpose kernels;
  3. hold each kernel against its plain PyTorch version at every shape the
     serving clips give it (the clips' batch), in bf16 and f32, plus a
     ragged tile, element by element, and time kernel and plain version on
     the same bf16 operands: the full-precision chain (3a, at the sites of
     the clips with and without attention and at the edges of its tiling,
     labels and segmap channels, EDGES, and the shapes the first kernels
     refused, REPAIRED), the quantized chain with its pre-pass (3b, the same
     sites, also held in rms, with two controls that must fail its limits,
     and timed against the full-precision chain on the same operands); the
     chains also by the device time of their own kernels (a torch.profiler
     trace), with the share of the peak; the int8 3x3 conv (3c, on inputs of both signs,
     at the clip's shapes and at channel counts off the 64-channel tile,
     also timed against cuDNN's bf16 conv of the same shape, the conv it
     replaces, beside the abs-max reduction it runs first) and SAGAN
     attention (3d, at flat and peaked score rows, with two controls that
     must fail at the peaked ones, at the clip's shapes and at widths off
     the first kernel's tiles, d = 8, 108 and 640, dv = 320 and 864, also
     timed against scaled_dot_product_attention with scale 1); and the probe kernels
     (3e, run last, after phase 5 has timed the clips, so that its
     profiler sessions precede no clip timing): the 15 layout probes on
     seeded random inputs of their own shapes, NaN-guarded, and a ragged
     sweep of the contraction kernel (M and N off its tile, K 12 to 144,
     A transposed or not, f32 and bf16 out, each A route), of the
     gather kernel (seeded maps of rank 1-4 with offset bases, every unit
     mode, f32 and bf16, each affine mode) and of the transposes (R and C
     off every tile of their three routes, 1 x 1 to 130 x 4100, misaligned
     inputs, exact, each launch's reported route the plan's), and probe
     M's chain at four more seeds, the outputs before NaN tails;
     then each probe timed by device time with L2 flushed before every
     call (a 128 MB fill, left out by kernel name), 5 traces of kernel and
     library call in turns, median (min-max), beside its bound, its plain
     version and a call's event time; the int8-conv probe's mmonly and
     taps9bf16 variants at its four batch-16 shapes (mmonly also against
     the int8 conv, which must fail) and at ragged shapes (H and W off
     every tile, batch 1-3, Cin 64-192, Cout 64-256, guarded inputs, NaN
     tails), timed the same way in turns with the int8 conv and, for
     taps9bf16, cuDNN's bf16 conv of the same operands (bounds from the
     products their functions need); then the port's two probe tools as a user
     runs them (layout_caps, and conv_probe for each of its seven
     variants), every launch count at 0 before each run, with the
     launches checked;
  4. check the whole clip on a small input: the kernel path on the card
     against the plain path on the CPU, same weights, f32; then the same
     with int8 serving, printing the int8 clip's distance from the fp one;
     then the same with attention blocks, every gamma nonzero;
  5. build the serving clip at full width (256x192, 5 frames, widths
     2^6..2^10, batch 4, bf16, random weights from a seed, warmed running
     statistics), run it once with every launch counter at 0, check the
     frames and that every kernel of the path was launched as often as the
     model has sites; then the same for the int8 serving clip
     (int8_spade=True), whose path runs the quantized chain, its pre-pass
     and the int8 conv, and for both clips with attention in the last
     middle block and decoder block 1 (options.ATTENTION_PLACEMENT), every
     gamma drawn nonzero before the warm-up; then time the four clips in
     turns (median of 5 each after a warm-up call);
  6. the SAMS training step (after the clips are timed, before phase 3e):
     (a) one small f32 exact step on the card against the same step on the
     CPU, from the same seeded state, without and with an attention block;
     (b) at full width (the clip's options, batch 4, bf16, remat on, as
     shineon_tpu_torch.bench.build_train sets them), for the production
     options and for ATTENTION_PLACEMENT (every gamma nonzero), 3 exact and
     3 fast_gan_step steps with every launch count at 0: every metric
     finite, all three networks' parameters changed; (c) the attention
     kernel launched once a block a frame in each pass over the clip (5
     blocks x 5 frames x 3 passes = 75 an exact step: the generator step,
     its remat recompute, the regeneration; 50 a fast step) and no serving
     kernel launched; (d) the step times, the peak device memory, and a
     traced exact attention step's device busy time, idle share and
     attention kernel time, beside that kernel's phase 3d time for as many
     calls, from the trace that writes phase 13's --profile step table;
  7. GMM and TOM training and SAMS's validation and visual steps (after
     phase 6, before phase 3e): (a) one small f32 step of the GMM (128x96,
     ngf 16) and of TOM (64x64, two frames, flow warp, three attention
     levels, every gamma nonzero) on the card against the same step on the
     CPU, from one seeded state; (b) at their documented configurations
     (256x192, batch 8, bf16: the GMM on agnostic + cocopose, TOM with
     --self_attn --num_attn 3 --activation swish, gammas nonzero) 3
     training steps, one validation and one visual step with every launch
     count at 0: every metric finite, every parameter tensor changed, the
     attention kernel launched 6 times a TOM step and no other kernel; (c)
     the production SAMS model's validation and visual steps (warmed
     statistics), the fused chain kernel launched 150 times each (225, and
     25 attention launches, with ATTENTION_PLACEMENT), checkpoint_on
     finite; (d) the GMM and TOM step times (median of 3 windows of 8), the
     peak memory, and a traced step of each: device busy time, idle share,
     the attention kernel's time and the top kernels;
  8. FlowNet2 flow annotation (after phase 3e; no hand kernel: the JAX
     package computes it in XLA): (a) seeded random weights built once on
     the CPU and copied to the card, a 64x64 pair at batch 1, f32: the
     card's flow with TF32 off against the CPU port's, |d| <= FLOW_TOL *
     (|ref| + rms(ref)), a control with one value moved that must fail, and
     the error with TF32 on; (b) FlowNet.__call__ on uint8 pairs at
     256x192, batch 4 and 8, with PyTorch's default TF32 and every launch
     count at 0 (none may move): median (min, max) of 5 calls, TFLOP/s
     against the analytic count from the convs and the cost volume, peak
     memory, a traced call (device busy, idle share, top kernels), the cost
     volume alone (device time, share) and the call's convs alone in
     channels_last against NCHW; (c) the chain: five flows of six
     synthetic frames a sample (batch 4) through write_flow and read_flow
     (the same bits), then the flow_raw of one production bf16 serving
     clip in the VVT dataset's order: finite frames, 150 chain launches;
  9. the training runtime and the host data, read from disk (after phase
     8): synthetic trees at 256x192 (tools/synthetic_data.py) in a
     temporary directory; (a) the production SAMS options (remat) through
     Trainer.fit over VVT with flows, 4 train batches, validation and a
     step save every 2 steps, images every 2, 4 decode threads, every
     launch count at 0: finite losses, hparams.json, 2 top-k saves, the
     step saves 2 and 4, FINAL, board events, the fused chain kernel 150
     times for each eval-mode clip (2 train image calls, 2 validation
     batches and their images) and no other kernel, the peak memory;
     (b) FINAL loaded with weights_only=True into a fresh model on the
     card equals the state bit for bit, and one more fit step from it
     gives a finite loss (the checkpoint's size, save and load seconds);
     (c) the GMM at gmm_options over VITON with a loader that raises at
     step 2: the fault propagates and interrupted_by_<its class> equals
     the state after step 1 bit for bit; (d) Trainer.test exports one
     PNG for each test clip (150 chain launches a batch) and, run again,
     writes and launches nothing; (e) tools/two_stage_chain.py at the
     documented GMM and TOM options (batch 8, over VVT): stage 1's files
     one a sample, its second export skipped, the attention kernel 6
     times for each TOM forward, SSIM and PSNR printed; (f) the trainer's
     step (synchronized, median of the steps after the first) against
     bench.time_train_steps on the same model, SAMS at 4 decode threads,
     the GMM and TOM at 0 and 4, and the loader alone in samples/s;
 10. (a) kernels 1 and 2 with the hidden activations gelu, swish and sine
     (relu is phases 3a and 3b) against their plain versions at the clip's
     site shapes, the ragged tile, the edges and the repaired shapes, bf16
     and f32, under fs.KERNEL_TOLERANCE and fs.int8_chain_agrees, with a
     control at every bf16 site that must fail (the relu kernels against
     the swish plain versions), then each activation's device time at the
     top site in turns with relu's; (b) the command line in process at full
     width on synthetic trees: shineon_tpu_torch.train.main with the
     production SAMS options as flags, --activation swish, --init_type
     orthogonal and --accumulated_batches 2 (its namespace against
     sams_options(), the parameters moving on even mini-steps only, the
     chain kernel 150 times an eval-mode clip), the same fit at
     accumulation 1 (the trainer's step against it), the test entry from
     its checkpoint with --int8_spade (kernel 2 and its pre-pass 150 times
     each a batch), the test entry without a checkpoint (refused), and the
     documented GMM and TOM commands with --fast_dev_run (attention 6 times
     a TOM forward), each with every launch count at 0 before it;
 11. (a) the QA loop, shineon_tpu_torch.tools.e2e_quality.run_e2e, at the
     production options (256x192, 5-frame clips, flow warp, widths
     2^6..2^10, 3 middle blocks, remat, bf16, the exact GAN step) on a
     synthetic VVT tree of 2 videos x QA_FRAMES frames: the export at init,
     Trainer.fit through train.run (QA_FRAMES / 4 steps), the trained
     export and its --int8_spade export, all scored by
     shineon_tpu_torch.calculate_metrics in a subprocess; every launch count
     at 0 before each stage and checked after it (kernel 1 150 times an fp
     export batch and once for the fit's step-0 images; kernel 2, its
     pre-pass, kernel 4 and its quantize pass 150, 150, 110 and 110 times an
     int8 export batch); SSIM and PSNR at init, trained and int8, the int8
     export within the JAX test's envelope of the fp export
     (tests/test_e2e_quality.py:61-62), the share of constant frames, each
     stage's wall time and the fit's steps; (b) a reference-layout SAMS
     generator checkpoint (Lightning names, seeded) at full width through
     tools.convert_lightning_checkpoint and the test entry's export (kernel
     1 150 times), its size and times; at phase 4's small widths the
     converted generator's f32 clip on the card against the CPU plain path;
     (c) the production SAMS exact step through parallel/ddp.py in an NCCL
     group of one rank against the bare step from the same state (bit for
     bit where two bare steps agree bit for bit, deterministic algorithms
     on), no kernel launched, and 3 timed steps with and without the group;
 12. the JAX system's measurement tools, ported (shineon_tpu_torch/tools),
     at full width with their repeats cut, every launch count at 0 before
     each (run_tools): (a) serving_stages at batch 16 int8 and batch 4
     bf16, each stage's launches a call exact and the stage functions
     composed against one_clip; (b) every train_ablate config, one window
     of 1 step; (c) flop_census of the fp graph within 10% of the
     analytic count; (d) serving_roof_census at the fp and int8 graphs'
     shapes above 0.01 TFLOP, beside a traced clip of each; (e)
     input_pipeline at 1 and 4 threads against (a)'s int8 clip rate.
 13. the JAX bench's inference half, ported (shineon_tpu_torch/bench.py),
     at full width with its repeats cut (run_bench): (a)
     bench.measure_inference on phase 12a's clips, batch 16 int8 and batch
     4 bf16, 2 repeats of 8 chained clips, every launch count at 0 before
     each: frames/s finite and within its min and max, each kernel's
     launches a clip exact, the 1-clip window against one_clip; (b)
     --flops within 10% of the analytic count; (c) both --profile tables
     written (the bf16 cell's clip table, phase 6's attention step table).

Phase 3d also holds the attention kernel at TOM's shapes: one frame and
five frames at TOM's batch of 8, each timed, and the small step's shapes
of phase 7a (N = 1 among them).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Exits non-zero, and prints no
result, without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BATCH = 4  # serving batch of the clip
FRAME = (256, 192)  # the clip's frame size (H, W)
DEVICE = "cuda"
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 rate, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
ENC, CUR = (8,), (4, 3, 3, 2)  # segmap channels of the encoder / current-frame labels
# (H, W, C, segmap channels of the site's labels, launches a frame in the
# clip without attention, in the attention clip) of every SPADE chain site.
# The attention clip's AttentiveMultiSpade blocks (middle_2 at 16x12,
# decode_1 at 64x48) run one one-label chain a current-frame label:
# agnostic (4 channels), cloth and densepose (3), flow (2).
SITES = (
    (256, 192, 64, ENC, 3, 3), (128, 96, 128, ENC, 3, 3), (64, 48, 256, ENC, 3, 3),
    (32, 24, 512, ENC, 3, 3),
    (16, 12, 1024, CUR, 6, 4),
    (32, 24, 1024, CUR, 2, 2), (32, 24, 512, CUR, 1, 1), (64, 48, 512, CUR, 2, 0),
    (64, 48, 256, CUR, 1, 0),
    (128, 96, 256, CUR, 2, 2), (128, 96, 128, CUR, 1, 1), (256, 192, 128, CUR, 2, 2),
    (256, 192, 64, CUR, 1, 1),
    (16, 12, 1024, (4,), 0, 2), (16, 12, 1024, (3,), 0, 4), (16, 12, 1024, (2,), 0, 2),
    (64, 48, 512, (4,), 0, 2), (64, 48, 512, (3,), 0, 4), (64, 48, 512, (2,), 0, 2),
    (64, 48, 256, (4,), 0, 1), (64, 48, 256, (3,), 0, 2), (64, 48, 256, (2,), 0, 1),
)
RAGGED = (20, 13, 64, CUR, 0, 0)
# edges of the bf16 chain kernels' tiling, labels and segmap channels,
# beside RAGGED's odd count of 3 ragged pixel tiles and its one channel tile:
# one pixel tile with L = 1, cs = 1; W below the tile width with L = 8,
# cs = 8
EDGES = ((8, 16, 128, (1,), 0, 0), (16, 12, 64, (8,) * 8, 0, 0))
# shapes the first chain kernels refused: labels of 12 and 18 segmap
# channels (two and three 8-channel segments), C off the 64-channel tile,
# and a label of 40 channels (five segments: streamed through the segmap
# buffer of four)
REPAIRED = ((20, 13, 64, (12,), 0, 0), (20, 13, 64, (18, 3), 0, 0), (20, 13, 96, (4, 3), 0, 0),
            (16, 12, 64, (40,), 0, 0))
CHAIN_KERNELS = ("chain_kernel_bf16",)  # device-time filters of phase 3a / 3b
CONV_KERNELS = ("conv_wgmma",)  # of phase 3c (the bf16 body)
QUANTIZE_KERNELS = ("quantize_kernel",)  # its quantize pass
ATTENTION_KERNELS = ("attention_wgmma",)  # of phase 3d
INT8_CHAIN_KERNELS = ("chain_kernel_q_bf16", "hidden_absmax_kernel")
# (N tokens, d, dv, launches a frame of the attention clip) of every SAGAN
# attention shape: middle_2 (16x12, 4 labels x 1024 channels) twice, decode_1
# norm_s and spade_0 (64x48, 4 x 512), decode_1 spade_1 (64x48, 4 x 256);
# then a ragged shape and a tiny one
ATTENTION_SHAPES = ((192, 512, 4096, 2), (3072, 256, 2048, 2), (3072, 128, 1024, 1),
                    (260, 64, 512, 0), (12, 16, 64, 0),
                    # widths the first kernel refused: SAMS attention at 64
                    # channels (d = 8), TOM's U-Net attention at 2 frames (d =
                    # 108, dv = 864), five 1024-channel labels (d = 640), and
                    # part of one 512-column block at a ragged query tile
                    (192, 8, 64, 0), (192, 108, 864, 0), (192, 640, 5120, 0), (150, 64, 320, 0))
# (N tokens, d, dv, launches a step) of TOM's U-Net attention at 256x192
# (tom_options: 3 levels, C = 8 ngf at the inner levels, 4 ngf at the
# (4, 8) level's up side; d = C // 8, dv = C), from the innermost level out:
# one frame (ngf 64), the batch 8 its training runs at, launched in every
# train and val step; and five frames (ngf 167: widths off every tile)
TOM_BATCH = 8
TOM_ATTENTION_SHAPES = ((12, 64, 512, 1), (48, 64, 512, 2), (192, 64, 512, 2),
                        (768, 32, 256, 1))
TOM5_ATTENTION_SHAPES = ((12, 167, 1336, 0), (48, 167, 1336, 0), (192, 167, 1336, 0),
                         (768, 83, 668, 0))
SCORE_STDS = {"flat": 0.3, "peaked": 8.0}  # std of the raw scores q.k
GAMMA_MEAN, GAMMA_STD = 0.5, 0.1  # the attention gammas the clips are run with
# (H, W, Cin, Cout, launches a frame) of every int8 3x3 conv of the int8 clip
CONVS = (
    (256, 192, 64, 64, 2), (256, 192, 64, 128, 1), (256, 192, 128, 64, 1),
    (128, 96, 128, 128, 2), (128, 96, 128, 256, 1), (128, 96, 256, 128, 1),
    (64, 48, 256, 256, 2), (64, 48, 256, 512, 1), (64, 48, 512, 256, 1),
    (32, 24, 512, 512, 2), (32, 24, 512, 1024, 1), (32, 24, 1024, 512, 1),
    (16, 12, 1024, 1024, 6),
)
RAGGED_CONV = (20, 13, 64, 128, 0)
# channel counts off the first kernel's 64-channel tiles
REPAIRED_CONVS = ((20, 13, 32, 96, 0), (20, 13, 96, 32, 0), (20, 13, 64, 100, 0))


def log(msg: str) -> None:
    print(msg, flush=True)


def sass_counts(cuda_build, source):
    """SASS instruction counts of the built library of ``source``, a
    function: {function name: {"HGMMA": n, "IGMMA": n, "bulk": n}}, bulk
    counting the bulk and tensor-map copies (UBLKCP, UTMALDG and their
    kin). Read with the toolkit's cuobjdump."""
    import re
    from pathlib import Path

    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(cuda_build.library_path(source))],
                         check=True, capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"HGMMA": 0, "IGMMA": 0, "bulk": 0}
        elif name is not None:
            for op in ("HGMMA", "IGMMA"):
                counts[name][op] += len(re.findall(rf"\b{op}\.", line))
            counts[name]["bulk"] += len(re.findall(r"\bU\w*(?:BLK|TMA)\w*", line))
    return counts


# The bf16 serving bodies of each kernel source (a name their symbols hold)
# and the wgmma their SASS must show (None: no wgmma, only no spills).
# The chain bodies are one instance a hidden activation (the template
# argument Act of csrc/fused_multispade.cu: 0 relu, 1 gelu, 2 swish, 3 sine).
SERVING_BODIES = {
    "fused_multispade": {**{f"chain_kernel_bf16ILi{a}E": "HGMMA" for a in range(4)},
                         **{f"chain_kernel_q_bf16ILi{a}E": "IGMMA" for a in range(4)}},
    "int8_conv3x3": {"conv_wgmma": "IGMMA"},
    "sagan_attention": {"attention_wgmma": "HGMMA"},
    # and the probes' kernels that no clip runs: the conv probe's tap
    # products, the mini chain, the contraction, the transposes
    "probes": {"mmonly_wgmma": "IGMMA", "taps9_wgmma": "HGMMA", "chain_wgmma": "HGMMA",
               "gemm_wgmma": "HGMMA", "transpose8_kernel": None, "transpose_cols_kernel": None,
               "transpose_slab_kernel": None},
}


def check_build(cuda_build, source, report):
    """Phase 2 for one library: each of its bf16 serving bodies runs on
    wgmma (SERVING_BODIES) fed by bulk or tensor-map copies, and ptxas
    reports no spills for it (nor for the bodies named without a wgmma)."""
    bodies = SERVING_BODIES[source]
    failed, seen = [], set()
    for name, c in sass_counts(cuda_build, source).items():
        log(f"  sass {name[:100]}: HGMMA {c['HGMMA']}, IGMMA {c['IGMMA']}, bulk or tensor-map "
            f"copies {c['bulk']}")
        body = next((b for b in bodies if b in name), None)
        if body is None:
            continue
        seen.add(body)
        if bodies[body] is not None and (c[bodies[body]] == 0 or c["bulk"] == 0):
            failed.append(f"{name[:80]} has no {bodies[body]} or no bulk copy")
    failed += [f"no function {b} in the {source} library" for b in bodies if b not in seen]
    lines = report.splitlines()
    if not lines:
        failed.append(f"no ptxas report for the {source} library")
    for i, line in enumerate(lines):
        body = next((b for b in bodies if b in line and "Function properties" in line), None)
        if body and i + 1 < len(lines) and " 0 bytes spill stores" not in lines[i + 1]:
            failed.append(f"{body} spills: {lines[i + 1].strip()}")
    if failed:
        raise SystemExit(f"{source} build check failed: " + "; ".join(failed))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def chain_inputs(torch, B, H, W, C, seg, dtype, seed):
    """Random chain operands at a site, made on the CPU from a seed."""
    g = torch.Generator().manual_seed(seed)
    L = len(seg)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    x = rn(B, H, W, C, scale=0.5)
    ab = torch.cat([1.0 + rn(B, L, C, scale=0.1), rn(B, L, C, scale=0.1)], dim=-1)
    segs, wshs, bshs, wgbs, bgbs = [], [], [], [], []
    for cs in seg:
        segs.append(rn(B, H, W, cs).to(dtype))
        wshs.append(rn(128, cs, 3, 3, scale=(9 * cs) ** -0.5))
        bshs.append(rn(128, scale=0.1))
        wgbs.append(rn(2 * C, 128, 3, 3, scale=(9 * 128) ** -0.5))
        bgbs.append(rn(2 * C, scale=0.05))
    return x.to(dtype), ab, segs, wshs, bshs, wgbs, bgbs


def to_device(args, device):
    out = []
    for a in args:
        out.append([t.to(device) for t in a] if isinstance(a, list) else a.to(device))
    return out


def site_cost(B, H, W, C, seg, itemsize):
    """(FLOPs, bytes) the chain needs at a site: both 3x3 convs of every
    label, x read once, y written once, segmaps and weights read once."""
    cs, L = sum(seg), len(seg)
    px = B * H * W
    flops = 2 * 9 * px * (cs * 128 + L * 128 * 2 * C)
    nbytes = (2 * px * C + px * cs + 9 * cs * 128 + L * 9 * 128 * 2 * C) * itemsize + 4 * (
        L * 128 + L * 2 * C + B * L * 2 * C)
    return flops, nbytes


def bound(ops_s, nbytes):
    """(bound ms, what bounds it): the larger of the operations' time at the
    card's peak rates and the bytes' time at its memory rate."""
    byte_s = nbytes / H100_BYTES_PER_S
    return 1e3 * max(ops_s, byte_s), "operations" if ops_s >= byte_s else "bytes"


def int8_site_bound(B, H, W, C, seg):
    """The quantized chain with its pre-pass at a site, bf16: the hidden conv
    twice (pre-pass and chain) at the bf16 rate, the gamma/beta conv at the
    int8 rate; x, y, segmaps and hidden weights in bf16, gamma/beta weights
    in int8, each moved once."""
    cs, L = sum(seg), len(seg)
    px = B * H * W
    hid_flops = 2 * (2 * 9 * px * cs * 128)
    gb_ops = 2 * 9 * px * L * 128 * 2 * C
    nbytes = (2 * (2 * px * C + px * cs + 9 * cs * 128) + L * 9 * 128 * 2 * C
              + 4 * (L * 128 + 2 * L * 2 * C + B * L * 2 * C + L))
    ms, by = bound(hid_flops / H100_BF16_FLOPS + gb_ops / H100_INT8_OPS, nbytes)
    return ms, by, hid_flops + gb_ops


def conv_bound(B, H, W, cin, cout, x_bytes):
    """The int8 3x3 conv at the int8 rate against its bytes moved once: x
    (x_bytes a pixel), y in bf16, the int8 weights, the f32 scales, bias
    and abs-max."""
    ops = 2 * 9 * B * H * W * cin * cout
    nbytes = B * H * W * (x_bytes + 2 * cout) + 9 * cin * cout + 4 * (2 * cout + 1)
    ms, by = bound(ops / H100_INT8_OPS, nbytes)
    return ms, by, ops


def conv_kernel_bound(B, H, W, cin, cout):
    """The bf16 conv kernel alone: it reads the quantize pass's int8 copy
    of x, Cin rounded up to 16 channels a pixel
    (ops/int8_conv.py::quantized_channels)."""
    return conv_bound(B, H, W, cin, cout, -(-cin // 16) * 16)


def conv_call_bound(B, H, W, cin, cout):
    """The whole bf16 call (abs-max, quantize pass and conv as one
    function): x read once in bf16."""
    return conv_bound(B, H, W, cin, cout, 2 * cin)


def cuda_ms(torch, fn, reps):
    """Mean device time of fn over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timing():
    """The device-time protocol (traced, marked calls), the one in
    shineon_tpu_torch/tools/__init__.py of the checkout that holds this
    script, loaded by its path: tools/chain_sites.py and tools/probe_sites.py
    time another checkout's kernels with this one's protocol."""
    if "chip_smoke_timing" not in sys.modules:
        path = Path(__file__).resolve().parent / "shineon_tpu_torch" / "tools" / "__init__.py"
        spec = importlib.util.spec_from_file_location("chip_smoke_timing", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules["chip_smoke_timing"] = module
    return sys.modules["chip_smoke_timing"]


def device_times(torch, fn, reps, groups):
    """Device time a call of fn, for each group of kernel names: the summed
    device time of the kernels whose name holds one of the group's names
    (None: every kernel of the call), the mean over the last reps traced
    calls, each marked by torch.cuda._sleep(0) (tools.device_times). At the
    probes' sizes a call's event time measures the host path (wrapper,
    allocation, launch), this the kernels alone; at the chain sites it
    leaves out the wrapper's segmap concatenation and allocation."""
    return timing().device_times(fn, groups, reps)


def device_ms(torch, fn, reps, names=None):
    """Device time a call of the kernels fn launches (device_times), only
    those whose name holds one of ``names`` where given."""
    return device_times(torch, fn, reps, {"all": names})["all"]


def seg_name(seg):
    return "enc" if seg == ENC else "cur" if seg == CUR else "seg" + "-".join(map(str, seg))


def time_site(torch, fs, args, site):
    """Kernel and plain version on the same bf16 operands, with the bound."""
    H, W, C, seg, per_frame, per_frame_att = site
    packed = fs.pack_weights(args[3], args[4], args[5], args[6], torch.bfloat16)
    chain = lambda: fs.fused_multispade_modulate(*args, packed=packed)  # noqa: E731
    with torch.no_grad():
        k_ms = cuda_ms(torch, chain, 5)
        dev_ms = device_ms(torch, chain, 5, CHAIN_KERNELS)
        p_ms = cuda_ms(torch, lambda: fs.multispade_modulate_plain(*args), 5)
    flops, nbytes = site_cost(BATCH, H, W, C, seg, 2)
    bound_ms = 1e3 * max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S)
    by = "operations" if flops / H100_BF16_FLOPS >= nbytes / H100_BYTES_PER_S else "bytes"
    peak = flops / (dev_ms * 1e-3) / H100_BF16_FLOPS
    log(f"time bf16 B={BATCH} H={H} W={W} C={C} {seg_name(seg)} "
        f"x{per_frame}/{per_frame_att}/frame: "
        f"kernel device {dev_ms:.4f} ms (event {k_ms:.4f} ms, wrapper included) "
        f"plain {p_ms:.4f} ms bound {bound_ms:.4f} ms ({by}) "
        f"kernel {flops / dev_ms / 1e9:.2f} TFLOP/s, {100 * peak:.1f}% of the bf16 peak")
    return dict(ms=k_ms, device_ms=dev_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by,
                peak_share=peak, per_frame=per_frame, per_frame_att=per_frame_att, flops=flops)


def check_chain_kernel(torch, fs):
    """Phase 3: kernel against plain version at every site of the clip, at
    the clip's batch, and at a ragged tile, in bf16 and f32 (elementwise, see
    fs.KERNEL_TOLERANCE); each bf16 site is then timed on the same operands.
    Every case is checked and printed before a failure ends the run."""
    errors, timings, failed = {}, {}, []
    for i, site in enumerate(SITES + (RAGGED,) + EDGES + REPAIRED):
        H, W, C, seg, per_frame, per_frame_att = site
        for dtype in (torch.bfloat16, torch.float32):
            args = to_device(chain_inputs(torch, BATCH, H, W, C, seg, dtype, seed=i), DEVICE)
            out = fs.fused_multispade_modulate(*args)
            ref = fs.multispade_modulate_plain(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ratio = fs.error_ratio(out, ref)
            tol = fs.KERNEL_TOLERANCE[dtype]
            name = str(dtype).split(".")[-1]
            ok = bool(torch.isfinite(out.float()).all()) and ratio <= tol
            log(f"check {name:8s} B={BATCH} H={H} W={W} C={C} {seg_name(seg)}: "
                f"max_abs_err={err:.4g} max_ref={ref.float().abs().max().item():.4g} "
                f"max|d|/(|ref|+rms)={ratio:.3g} (limit {tol:g}) {'ok' if ok else 'FAIL'}")
            errors[(H, W, C, seg, name)] = err
            if not ok:
                failed.append(f"{(H, W, C, seg)} {name}")
            elif dtype == torch.bfloat16 and (per_frame or per_frame_att):
                timings[(H, W, C, seg)] = time_site(torch, fs, args, site)
            del args, out, ref
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version at {', '.join(failed)}")
    return errors, timings


def int8_timings(torch, fs, args, site):
    """The quantized chain (pre-pass + chain, as the wrapper runs them), its
    pre-pass alone, its plain version and the full-precision chain kernel on
    the same bf16 operands, with the bound."""
    H, W, C, seg, per_frame, per_frame_att = site
    x, ab, segs, wshs, bshs, wgbs, bgbs = args
    packed_q = fs.pack_weights(wshs, bshs, wgbs, bgbs, torch.bfloat16, quantized=True)
    packed = fs.pack_weights(wshs, bshs, wgbs, bgbs, torch.bfloat16)
    chain_q = lambda: fs.fused_multispade_modulate(  # noqa: E731
        *args, packed=packed_q, quantized=True)
    chain = lambda: fs.fused_multispade_modulate(*args, packed=packed)  # noqa: E731
    with torch.no_grad():
        k_ms = cuda_ms(torch, chain_q, 5)
        dev = device_times(torch, lambda: (chain_q(), chain()), 5, {
            "chain_q": INT8_CHAIN_KERNELS[:1], "pre": INT8_CHAIN_KERNELS[1:],
            "fp": CHAIN_KERNELS})
        dev_ms, pre_ms, fp_ms = dev["chain_q"] + dev["pre"], dev["pre"], dev["fp"]
        p_ms = cuda_ms(torch, lambda: fs.multispade_modulate_plain_int8(*args), 3)
    bound_ms, by, ops = int8_site_bound(BATCH, H, W, C, seg)
    # the share of the int8 peak: the bound's own mix of bf16 and int8 operations
    peak = bound_ms / dev_ms if by == "operations" else float("nan")
    log(f"time int8 bf16 B={BATCH} H={H} W={W} C={C} {seg_name(seg)} "
        f"x{per_frame}/{per_frame_att}/frame: "
        f"kernel device {dev_ms:.4f} ms (pre-pass {pre_ms:.4f}; event {k_ms:.4f} ms, wrapper "
        f"included) plain {p_ms:.4f} ms bound {bound_ms:.4f} ms ({by}) bf16 chain device "
        f"{fp_ms:.4f} ms kernel {ops / dev_ms / 1e9:.2f} Tops/s, {100 * peak:.1f}% of the "
        f"peak")
    return dict(ms=k_ms, device_ms=dev_ms, prepass_ms=pre_ms, plain_ms=p_ms, bound_ms=bound_ms,
                bound_by=by, peak_share=peak, bf16_chain_device_ms=fp_ms, per_frame=per_frame,
                per_frame_att=per_frame_att, ops=ops)


def check_int8_chain(torch, fs):
    """Phase 3b: the quantized chain (pre-pass + chain) against its plain
    version at every site and the ragged tile, bf16 and f32, element by
    element and in rms (fs.int8_chain_agrees); each bf16 site is timed. Two
    controls at every case must FAIL those limits, or the limits could not
    tell a fault from rounding: the full-precision chain kernel (no int8 at
    all) and the quantized kernel given gamma/beta weights quantized from
    their bf16 cast (a planted fault of the int8 stage)."""
    errors, timings, failed = {}, {}, []
    for i, site in enumerate(SITES + (RAGGED,) + EDGES + REPAIRED):
        H, W, C, seg, per_frame, per_frame_att = site
        for dtype in (torch.bfloat16, torch.float32):
            args = to_device(chain_inputs(torch, BATCH, H, W, C, seg, dtype, seed=100 + i),
                             DEVICE)
            x, ab, segs, wshs, bshs, wgbs, bgbs = args
            out = fs.fused_multispade_modulate(*args, quantized=True)
            ref = fs.multispade_modulate_plain_int8(*args)
            fp = fs.fused_multispade_modulate(*args)
            bf16_w = [w.to(torch.bfloat16).float() for w in wgbs]
            planted = fs.fused_multispade_modulate(*args, quantized=True, packed=fs.pack_weights(
                wshs, bshs, bf16_w, bgbs, dtype, quantized=True))
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok, ratio, rms = fs.int8_chain_agrees(out, ref)
            fp_ok, fp_ratio, fp_rms = fs.int8_chain_agrees(fp, ref)
            pl_ok, pl_ratio, pl_rms = fs.int8_chain_agrees(planted, ref)
            name = str(dtype).split(".")[-1]
            good = ok and not fp_ok and not pl_ok
            log(f"check int8 {name:8s} B={BATCH} H={H} W={W} C={C} {seg_name(seg)}: "
                f"max_abs_err={err:.4g} max|d|/(|ref|+rms)={ratio:.3g} rms(d)/rms(ref)={rms:.3g} "
                f"(limits {fs.KERNEL_TOLERANCE[(dtype, 'int8')]:g}, "
                f"{fs.INT8_RMS_TOLERANCE:g}); must fail: fp chain {fp_ratio:.3g}/{fp_rms:.3g}, "
                f"bf16-cast weights {pl_ratio:.3g}/{pl_rms:.3g} {'ok' if good else 'FAIL'}")
            errors[(H, W, C, seg, name)] = (err, ratio, rms)
            if not good:
                failed.append(f"{(H, W, C, seg)} {name}")
            elif dtype == torch.bfloat16 and (per_frame or per_frame_att):
                timings[(H, W, C, seg)] = int8_timings(torch, fs, args, site)
            del args, out, ref, fp, planted
    if failed:
        raise SystemExit(f"quantized chain disagrees with its plain version (or a control "
                         f"passes) at {', '.join(failed)}")
    return errors, timings


# phase 10a: the chain kernels' other hidden activations (relu is phases
# 3a and 3b), at the clip's site shapes without attention, the ragged tile,
# the tiling's edges and the repaired shapes
ACTIVATION_SITES = SITES[:13] + (RAGGED,) + EDGES + REPAIRED
OTHER_ACTIVATIONS = ("gelu", "swish", "sine")


def check_activations(torch, fs, card):
    """Phase 10a: kernels 1 and 2 (the full-precision chain, the quantized
    chain with its pre-pass) with each of gelu, swish and sine against
    their plain versions on the same operands, at ACTIVATION_SITES in bf16
    and f32, under fs.KERNEL_TOLERANCE and fs.int8_chain_agrees. A control
    at every bf16 site must fail: the relu kernels against the swish plain
    versions. Then the device time of each activation's kernels at the top
    site, in turns with relu's. Every case is printed before a failure ends
    the run."""
    errors, failed = {}, []
    for i, site in enumerate(ACTIVATION_SITES):
        H, W, C, seg = site[:4]
        for dtype in (torch.bfloat16, torch.float32):
            args = to_device(chain_inputs(torch, BATCH, H, W, C, seg, dtype, seed=1000 + i),
                             DEVICE)
            name = str(dtype).split(".")[-1]
            tol = fs.KERNEL_TOLERANCE[dtype]
            for act in OTHER_ACTIVATIONS:
                out = fs.fused_multispade_modulate(*args, act_name=act)
                ref = fs.multispade_modulate_plain(*args, act_name=act)
                q_out = fs.fused_multispade_modulate(*args, act_name=act, quantized=True)
                q_ref = fs.multispade_modulate_plain_int8(*args, act_name=act)
                torch.cuda.synchronize()
                ratio = fs.error_ratio(out, ref)
                ok = bool(torch.isfinite(out.float()).all()) and ratio <= tol
                q_ok, q_ratio, q_rms = fs.int8_chain_agrees(q_out, q_ref, act)
                err = (out.float() - ref.float()).abs().max().item()
                q_err = (q_out.float() - q_ref.float()).abs().max().item()
                control = ""
                if act == "swish" and dtype == torch.bfloat16:
                    relu = fs.error_ratio(fs.fused_multispade_modulate(*args), ref)
                    q_relu_ok, q_relu, q_relu_rms = fs.int8_chain_agrees(
                        fs.fused_multispade_modulate(*args, quantized=True), q_ref, act)
                    control = (f"; must fail: relu kernels {relu:.3g} (fp), "
                               f"{q_relu:.3g}/{q_relu_rms:.3g} (int8)")
                    ok = ok and relu > tol
                    q_ok = q_ok and not q_relu_ok
                log(f"check {act:5s} {name:8s} B={BATCH} H={H} W={W} C={C} {seg_name(seg)}: "
                    f"fp max_abs_err={err:.4g} max|d|/(|ref|+rms)={ratio:.3g} (limit {tol:g}); "
                    f"int8 max_abs_err={q_err:.4g} {q_ratio:.3g}/{q_rms:.3g} (limits "
                    f"{fs.int8_limit(dtype, act):g}, {fs.INT8_RMS_TOLERANCE:g})"
                    f"{control} {'ok' if ok and q_ok else 'FAIL'}")
                errors[(H, W, C, seg, name, act)] = (err, q_err)
                if not (ok and q_ok):
                    failed.append(f"{act} {(H, W, C, seg)} {name}")
                del out, ref, q_out, q_ref
            del args
    if failed:
        raise SystemExit(f"a chain kernel with another activation disagrees with its plain "
                         f"version (or its control passes) at {', '.join(failed)}")

    # the top site's device time of each activation, relu's first and last
    top = max(SITES, key=lambda s: site_cost(BATCH, *s[:4], 2)[0])
    H, W, C, seg = top[:4]
    args = to_device(chain_inputs(torch, BATCH, H, W, C, seg, torch.bfloat16, seed=999), DEVICE)
    packed = fs.pack_weights(*args[3:], torch.bfloat16)
    packed_q = fs.pack_weights(*args[3:], torch.bfloat16, quantized=True)
    times = {}
    with torch.no_grad():
        for act in ("relu",) + OTHER_ACTIVATIONS + ("relu",):
            dev = device_times(torch, lambda: (
                fs.fused_multispade_modulate(*args, act_name=act, packed=packed),
                fs.fused_multispade_modulate(*args, act_name=act, packed=packed_q,
                                             quantized=True)), 5, {
                "fp": CHAIN_KERNELS, "chain_q": INT8_CHAIN_KERNELS[:1],
                "pre": INT8_CHAIN_KERNELS[1:]})
            times.setdefault(act, []).append(dev)
    bound_ms = bound(site_cost(BATCH, H, W, C, seg, 2)[0] / H100_BF16_FLOPS,
                     site_cost(BATCH, H, W, C, seg, 2)[1])[0]
    q_bound_ms = int8_site_bound(BATCH, H, W, C, seg)[0]
    out = {}
    for act, runs in times.items():
        fp = [r["fp"] for r in runs]
        q = [r["chain_q"] + r["pre"] for r in runs]
        pre = [r["pre"] for r in runs]
        out[act] = dict(device_ms=fp, int8_device_ms=q, prepass_ms=pre)
        log(f"time {act:5s} bf16 B={BATCH} H={H} W={W} C={C} {seg_name(seg)}: kernel 1 device "
            f"{', '.join(f'{v:.4f}' for v in fp)} ms (bound {bound_ms:.4f}); kernel 2 with its "
            f"pre-pass {', '.join(f'{v:.4f}' for v in q)} ms (pre-pass "
            f"{', '.join(f'{v:.4f}' for v in pre)}; bound {q_bound_ms:.4f}) [{card}]")
    return errors, out, top


def check_int8_conv(torch, ic, fs):
    """Phase 3c: the int8 3x3 conv against its plain version at every conv
    shape of the int8 clip, a ragged one and channel counts off the 64-
    channel tile, bf16 and f32, element by element
    (ic.INT8_CONV_TOLERANCE); each bf16 clip shape is timed against its
    plain version, its bound and cuDNN's bf16 conv of the same shape: the
    kernel by its own device time, beside it the abs-max reduction the
    wrapper runs before it."""
    F = torch.nn.functional
    errors, timings, failed = {}, {}, []
    for i, shape in enumerate(CONVS + (RAGGED_CONV,) + REPAIRED_CONVS):
        H, W, cin, cout, per_frame = shape
        g = torch.Generator().manual_seed(200 + i)
        # the clip feeds the conv leaky_relu(0.2) output: both signs
        x0 = torch.nn.functional.leaky_relu(torch.randn(BATCH, H, W, cin, generator=g), 0.2)
        x0 = x0.to(DEVICE)
        w = (torch.randn(cout, cin, 3, 3, generator=g) * (9 * cin) ** -0.5).to(DEVICE)
        b = (0.1 * torch.randn(cout, generator=g)).to(DEVICE)
        qw = ic.quantize_weight(w)
        for dtype in (torch.bfloat16, torch.float32):
            x = x0.to(dtype)
            if dtype == torch.bfloat16:  # the bf16 conv's quantize pass: exact
                absmax = torch.linalg.vector_norm(x, float("inf"), dtype=torch.float32)
                xq, xq_ref = ic.quantize_int8(x, absmax), ic.quantize_int8_plain(x, absmax)
                q_err = (xq.int() - xq_ref.int()).abs().max().item()
                log(f"check quantize pass B={BATCH} H={H} W={W} Cin={cin}: max_abs_err={q_err} "
                    f"(exact) {'ok' if q_err == 0 else 'FAIL'}")
                errors[(H, W, cin, cout, "quantize")] = q_err
                if q_err:
                    failed.append(f"{(H, W, cin, cout)} quantize pass")
            out = ic.conv3x3_int8(x, qw, b, dtype)
            ref = ic.conv3x3_int8_plain(x, qw, b, dtype)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ratio = fs.error_ratio(out, ref)
            tol = ic.INT8_CONV_TOLERANCE[dtype]
            name = str(dtype).split(".")[-1]
            ok = bool(torch.isfinite(out.float()).all()) and ratio <= tol
            log(f"check conv {name:8s} B={BATCH} H={H} W={W} {cin}->{cout}: "
                f"max_abs_err={err:.4g} max|d|/(|ref|+rms)={ratio:.3g} (limit {tol:g}) "
                f"{'ok' if ok else 'FAIL'}")
            errors[(H, W, cin, cout, name)] = err
            if not ok:
                failed.append(f"{(H, W, cin, cout)} {name}")
            elif dtype == torch.bfloat16 and per_frame:
                w_bf, b_bf = w.to(dtype), b.to(dtype)
                x_nchw = x.permute(0, 3, 1, 2)
                absmax_fn = lambda: torch.linalg.vector_norm(  # noqa: E731
                    x, float("inf"), dtype=torch.float32)
                with torch.no_grad():
                    k_ms = cuda_ms(torch, lambda: ic.conv3x3_int8(x, qw, b, dtype), 10)
                    dev = device_times(torch, lambda: ic.conv3x3_int8(x, qw, b, dtype), 5,
                                       {"kernel": CONV_KERNELS})
                    am_ms = device_ms(torch, absmax_fn, 5)
                    p_ms = cuda_ms(torch, lambda: ic.conv3x3_int8_plain(x, qw, b, dtype), 3)
                    lib_ms = cuda_ms(torch, lambda: F.conv2d(x_nchw, w_bf, b_bf, padding=1), 10)
                k_dev = dev["kernel"]
                with torch.no_grad():
                    qz = lambda: ic.quantize_int8(x, absmax)  # noqa: E731
                    qz_ms = cuda_ms(torch, qz, 10)
                    qz_dev = device_ms(torch, qz, 5, QUANTIZE_KERNELS)
                    qz_plain = cuda_ms(torch, lambda: ic.quantize_int8_plain(x, absmax), 3)
                qz_bound, qz_by = bound(0.0, bytes_of(x) + bytes_of(xq) + 4)
                log(f"time quantize pass bf16 B={BATCH} H={H} W={W} Cin={cin}: kernel device "
                    f"{qz_dev:.4f} ms (event {qz_ms:.4f}) plain {qz_plain:.4f} ms bound "
                    f"{qz_bound:.4f} ms ({qz_by})")
                bound_ms, by, ops = conv_kernel_bound(BATCH, H, W, cin, cout)
                call_bound, call_by, _ = conv_call_bound(BATCH, H, W, cin, cout)
                split = ic.plan(BATCH, H, W, cin, cout)[1]
                log(f"time conv bf16 B={BATCH} H={H} W={W} {cin}->{cout} x{per_frame}/frame: "
                    f"kernel device {k_dev:.4f} ms (K split {split}) bound {bound_ms:.4f} ms "
                    f"({by}, int8 x); the call (abs-max, quantize pass, conv) event "
                    f"{k_ms:.4f} ms bound {call_bound:.4f} ms ({call_by}, bf16 x); abs-max "
                    f"device {am_ms:.4f} ms plain {p_ms:.4f} ms cuDNN bf16 conv {lib_ms:.4f} ms "
                    f"kernel {ops / k_dev / 1e9:.2f} Tops/s")
                timings[(H, W, cin, cout)] = dict(
                    ms=k_dev, call_ms=k_ms, device_ms=k_dev, absmax_ms=am_ms, plain_ms=p_ms,
                    bound_ms=bound_ms, bound_by=by, call_bound_ms=call_bound,
                    cudnn_bf16_ms=lib_ms, per_frame=per_frame, ops=ops, ksplit=split,
                    quantize=dict(ms=qz_ms, device_ms=qz_dev, plain_ms=qz_plain,
                                  bound_ms=qz_bound, bound_by=qz_by, bytes=bytes_of(x, xq)))
    if failed:
        raise SystemExit(f"int8 conv disagrees with its plain version at {', '.join(failed)}")
    return errors, timings


def attention_inputs(torch, N, d, dv, dtype, score_std, seed, batch=BATCH):
    """q, k (batch, N, d) and v (batch, N, dv) on the card from a seed, with
    raw scores q.k of std about ``score_std``."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    sigma = (score_std / d ** 0.5) ** 0.5
    rn = lambda *shape: torch.randn(shape, generator=g, device=DEVICE)  # noqa: E731
    return (sigma * rn(batch, N, d)).to(dtype), (sigma * rn(batch, N, d)).to(dtype), \
        rn(batch, N, dv).to(dtype)


def attention_over_queries(torch, q, k, v):
    """A control: the plain version with its softmax over the query axis."""
    attn = torch.softmax(torch.bmm(q.float(), k.float().transpose(1, 2)), dim=1).to(q.dtype)
    return torch.bmm(attn.float(), v.float()).to(q.dtype)


def attention_work(B, N, d, dv, chunk):
    """(the operations the function needs, the operations the kernel does:
    QK^T once per block of ``chunk`` value columns) at batch B."""
    need = 2 * B * N * N * (d + dv)
    done = 2 * B * N * N * (d * -(-dv // chunk) + dv)
    return need, done


def check_attention(torch, fa, fs, shapes=ATTENTION_SHAPES, batch=BATCH, time_all=False):
    """Phase 3d: the attention kernel against its plain version at every
    shape of the attention clip, a ragged one and a tiny one, at the clips'
    batch (then, called again, at TOM's shapes and batch), bf16 and f32, at
    flat and at peaked score rows, element by element
    (fa.ATTENTION_TOLERANCE). At every peaked case two controls must FAIL
    the limit, or it could not tell a fault from rounding: the kernel on
    1/sqrt(d)-scaled scores (q / sqrt(d), a library's default scale) and
    the plain version's softmax over the query axis. Each bf16 clip shape
    (with ``time_all`` every shape) is timed against its plain version, its
    bound and scaled_dot_product_attention with scale 1 (heads a unit
    dimension)."""
    F = torch.nn.functional
    errors, timings, failed = {}, {}, []
    for i, (N, d, dv, per_frame) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            tol = fa.ATTENTION_TOLERANCE[dtype]
            for rows, std in SCORE_STDS.items():
                q, k, v = attention_inputs(torch, N, d, dv, dtype, std, seed=300 + i,
                                           batch=batch)
                out = fa.sagan_attention(q, k, v)
                ref = fa.attention_plain(q, k, v)
                controls = {}
                # at N = 1 a softmax is 1 on any scale and either axis: the
                # controls compute the same function there
                if rows == "peaked" and N > 1:
                    scaled = fa.sagan_attention((q.float() / d ** 0.5).to(dtype), k, v)
                    controls = {"1/sqrt(d) scores": fs.error_ratio(scaled, ref),
                                "query-axis softmax": fs.error_ratio(
                                    attention_over_queries(torch, q, k, v), ref)}
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ratio = fs.error_ratio(out, ref)
                ok = (bool(torch.isfinite(out.float()).all()) and ratio <= tol
                      and all(c > tol for c in controls.values()))
                must_fail = ", ".join(f"{c} {r:.3g}" for c, r in controls.items())
                log(f"check attention {name:8s} B={batch} N={N} d={d} dv={dv} {rows}: "
                    f"max_abs_err={err:.4g} max|d|/(|ref|+rms)={ratio:.3g} (limit {tol:g})"
                    f"{'; must fail: ' + must_fail if must_fail else ''} "
                    f"{'ok' if ok else 'FAIL'}")
                errors[(N, d, dv, name, rows)] = (err, ratio, controls)
                if not ok:
                    failed.append(f"{(N, d, dv)} {name} {rows}")
                elif dtype == torch.bfloat16 and (per_frame or time_all) and rows == "flat":
                    timings[(N, d, dv)] = time_attention(torch, fa, F, q, k, v, per_frame)
                del q, k, v, out, ref
    if failed:
        raise SystemExit(f"attention kernel disagrees with its plain version (or a control "
                         f"passes) at {', '.join(failed)}")
    return errors, timings


def shape_times(t):
    """The numbers of one attention shape's timing for the kernels line."""
    return {k: t[k] for k in ("ms", "device_ms", "plain_ms", "sdpa_ms", "bound_ms", "bound_by")}


def time_attention(torch, fa, F, q, k, v, per_frame):
    """Kernel, plain version and SDPA (scale 1) on the same bf16 operands,
    with the bound: the operations at the bf16 peak against q, k, v and o
    moved once."""
    B, N, d = q.shape
    dv = v.shape[-1]
    with torch.no_grad():
        k_ms = cuda_ms(torch, lambda: fa.sagan_attention(q, k, v), 10)
        k_dev = device_ms(torch, lambda: fa.sagan_attention(q, k, v), 5, ATTENTION_KERNELS)
        p_ms = cuda_ms(torch, lambda: fa.attention_plain(q, k, v), 3)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], scale=1.0), 10)
    chunk = fa.BLOCK_COLS
    need, done = attention_work(B, N, d, dv, chunk)
    bound_ms, by = bound(need / H100_BF16_FLOPS, B * N * (2 * d + 2 * dv) * 2)
    log(f"time attention bf16 B={B} N={N} d={d} dv={dv} x{per_frame}: "
        f"kernel device {k_dev:.4f} ms (event {k_ms:.4f}) plain {p_ms:.4f} ms SDPA {lib_ms:.4f} "
        f"ms bound {bound_ms:.4f} ms ({by}) kernel {need / k_dev / 1e9:.2f} TFLOP/s "
        f"({done / k_dev / 1e9:.2f} TFLOP/s of the {done / need:.2f}x work it does; QK^T "
        f"{-(-dv // chunk)}x the minimum)")
    return dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, sdpa_ms=lib_ms, bound_ms=bound_ms,
                bound_by=by, per_frame=per_frame, per_frame_att=per_frame, flops=need,
                work=done / need, qk_ratio=-(-dv // chunk))


def probe_library(torch, name, args):
    """The one PyTorch call that computes a layout probe's function, timed as
    its yardstick (the port never calls it), or None. Operands it needs in
    f32 are converted outside the call."""
    x = args[0]
    if name in ("probe_a2", "probe_d", "probe_i"):
        a, b = (t.float() for t in args)
        if name == "probe_a2":
            return lambda: torch.einsum("chw,cn->hwn", a, b)
        return lambda: torch.matmul(a, b)
    return {
        "probe_a": lambda: torch.matmul(x, args[1]),
        "probe_b": lambda: x + 1.0,
        "probe_b2": lambda: x.view(8, 200, 128)[:, 4:196].contiguous(),
        "probe_c": lambda: x.t().contiguous(),
        "probe_c2": lambda: x.t().contiguous(),
        "probe_e": lambda: x * args[1] + 1.0,
        "probe_f": lambda: x.view(400, 12).clone(),
        "probe_g": lambda: x[3:35].clone(),  # rows 3:35 of x are contiguous already
        "probe_h": lambda: x * 2.0,
        "probe_k": lambda: x[:, :, 3:51].contiguous(),
        "probe_l": lambda: x.as_strided((2, 4, 16, 56), (448, 3584, 56, 1), 168).contiguous(),
    }.get(name)


def bytes_of(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def probe_bound(pr, name, args, out):
    """(bound ms, what bounds it) of a layout probe on these inputs:
    contractions and the chain at the bf16 tensor peak, movement's
    elementwise operations at the f32 peak outside the tensor cores; bytes
    are the output written once and what it needs read once (a gather reads
    one input element an output element), at the HBM rate. Phase 3e flushes
    L2 before every timed call (L2Flush), so the bytes the bound counts are
    bytes the kernel really moves through HBM: its reads come from there,
    and its writes are counted as if they went there too (at these sizes
    they stay in L2 until after the kernel ends)."""
    family = pr.SPECS[name].family
    if family == "contraction":
        K = args[1].shape[0]
        return bound(2 * out.numel() * K / H100_BF16_FLOPS, bytes_of(*args, out))
    if family == "chain":
        G, th, w2, c2 = out.shape
        cs, nh = args[1].shape[1:]
        ops = 2 * G * w2 * ((th + 2) * 9 * cs * nh + th * 3 * nh * c2)
        return bound(ops / H100_BF16_FLOPS, bytes_of(*args, out))
    elementwise = {"probe_b": 1, "probe_e": 2, "probe_h": 1}.get(name, 0) * out.numel()
    return bound(elementwise / H100_F32_FLOPS, 2 * bytes_of(out) + bytes_of(*args[1:]))


def tap_products_needed(name):
    """The int8 products (M = pixels, K = Cin, N = Cout) a conv variant's
    function needs, as its kernel issues them. taps9bf16 computes the int8
    conv: all nine taps. mmonly's function is the centre tap times the sum
    of the nine weight taps, one product with weights in [-1143, 1143],
    which split exactly into two int8 parts (128 hi + lo)."""
    return {"conv_mmonly": 2, "conv_taps9bf16": 9}[name]


def guarded(torch, t, guard=1 << 14):
    """t copied to the head of a buffer whose tail (guard elements) is NaN,
    so that a kernel reading past the tensor reads NaN and fails its check:
    whatever lies past a fresh allocation may happen to be zero. An integer
    tensor's tail holds its type's largest value instead."""
    fill = float("nan") if t.is_floating_point() else torch.iinfo(t.dtype).max
    buf = torch.full((t.numel() + guard,), fill, dtype=t.dtype, device=t.device)
    head = buf[:t.numel()].view(t.shape)
    head.copy_(t)
    return head


def guarded_out(torch, shape, dtype, guard=1 << 12):
    """(out, tail): an output tensor at the head of a buffer whose tail
    (guard elements) is NaN, so that a store past the output shows."""
    n = 1
    for d in shape:
        n *= d
    buf = torch.full((n + guard,), float("nan"), dtype=dtype, device=DEVICE)
    return buf[:n].view(shape), buf[n:]


# the ragged sweep of the contraction kernel: (M, N, K, A given (K, M)),
# each with f32 and bf16 out; M and N off the 64 x 64 tile; K a tail of a
# 16-deep step (12), one step (16), two (32), three (48), and more than a
# stage through the ring of two (100: two stages, flat A; 144: three);
# (4001, 8, 12): a slab whose last bytes are under 16; (1, 8, 12): one row
GEMM_SWEEP = tuple((200, 72, K, False) for K in (12, 16, 32, 48, 100, 144)) + tuple(
    (136, 200, K, True) for K in (12, 16, 32, 48, 100, 144)) + (
    (4001, 8, 12, False), (1, 8, 12, False), (65, 4000, 12, False), (1000, 136, 32, True))


def gemm_sweep(torch, pr, fs):
    """pr._gemm at GEMM_SWEEP against the f32 product of the same bf16
    operands (pr.TOLERANCE's limits: 1e-5 f32 out, 4e-3 bf16), inputs at
    the head of NaN-filled buffers, the output before a NaN tail that must
    stay NaN. Returns the failures."""
    failed, routes = [], set()
    for i, (M, N, K, a_trans) in enumerate(GEMM_SWEEP):
        g = torch.Generator().manual_seed(700 + i)
        a = torch.randn((K, M) if a_trans else (M, K), generator=g).to(torch.bfloat16)
        b = torch.randn((K, N), generator=g).to(torch.bfloat16)
        a, b = guarded(torch, a.to(DEVICE)), guarded(torch, b.to(DEVICE))
        ref = (a.float().t() if a_trans else a.float()) @ b.float()
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 4e-3)):
            out, tail = guarded_out(torch, (M, N), dtype)
            plan = pr.gemm_plan(M, N, K, a_trans, (a.data_ptr(), b.data_ptr(), out.data_ptr()))
            routes.add(plan.a_route)
            pr._gemm(a, b, M, N, K, a_trans, dtype, out=out)
            torch.cuda.synchronize()
            ratio = fs.error_ratio(out, ref.to(dtype))
            ok = bool(torch.isfinite(out.float()).all()) and ratio <= tol and bool(
                torch.isnan(tail.float()).all())
            if not ok:
                failed.append(f"gemm {(M, N, K, a_trans)} {dtype} ({plan.a_route}): {ratio:.3g}")
    log(f"ragged sweep, contraction: {2 * len(GEMM_SWEEP)} cases, A routes {sorted(routes)}: "
        f"{'ok' if not failed else 'FAIL ' + '; '.join(failed)}")
    return failed


def gather_cases(seed, n=48):
    """Seeded strided maps of rank 1-4 into a contiguous input: (input
    numel, shape, strides, base). Each output dim takes a slice with a
    start and a step of an input dim; every third map keeps the last dim
    contiguous with a length and a row pitch of 16-byte multiples, its
    start at or off 16-byte alignment (the kernel's VEC and SHIFT units);
    every fifth swaps two dims' strides (a transposing map)."""
    import random

    rng = random.Random(seed)
    cases = []
    for c in range(n):
        rank = 1 + c % 4
        dims = [rng.randint(1, 6) for _ in range(rank)]
        steps = [rng.randint(1, 3) for _ in range(rank)]
        starts = [rng.randint(0, 4) for _ in range(rank)]
        if c % 3 == 0:
            dims[-1], steps[-1] = 8 * rng.randint(1, 4), 1
            starts[-1] = rng.choice((0, 8, 16, 1, 3, 6))
        parent = [s + d * st + rng.randint(0, 3) for s, d, st in zip(starts, dims, steps)]
        if c % 3 == 0:
            parent[-1] = -(-parent[-1] // 8) * 8
        pitch = [1] * rank
        for k in range(rank - 2, -1, -1):
            pitch[k] = pitch[k + 1] * parent[k + 1]
        strides = [st * p for st, p in zip(steps, pitch)]
        base = sum(s * p for s, p in zip(starts, pitch))
        if c % 5 == 4 and rank > 1:
            strides[0], strides[-1] = strides[-1], strides[0]
            dims[0], dims[-1] = min(dims[0], dims[-1]), min(dims[0], dims[-1])
        cases.append((pitch[0] * parent[0], tuple(dims), tuple(strides), base))
    return cases


def gather_sweep(torch, pr):
    """pr._gather on gather_cases in f32 and bf16, each with an affine mode
    in turn (copy, a x, a x + b, chan[c] x + b), exactly against
    as_strided(...).contiguous() and the same roundings (a multiply, then
    an add), the input at the head of a NaN-filled buffer and the output
    before a NaN tail. Returns the failures; the (dtype, unit mode) pairs
    run must be all six."""
    failed, modes = [], set()
    for dtype in (torch.float32, torch.bfloat16):
        for i, (numel, shape, strides, base) in enumerate(gather_cases(800)):
            g = torch.Generator().manual_seed(900 + i)
            x = guarded(torch, torch.randn(numel, generator=g).to(dtype).to(DEVICE))
            affine = i % 4
            chan = (torch.randn(shape[-1], generator=g).to(DEVICE)
                    if affine == pr.CHAN_SCALE_ADD else None)
            a, b = 1.5, -0.25
            out, tail = guarded_out(torch, shape, dtype)
            plan = pr.gather_plan(shape, strides, base, x.element_size(), chan=chan is not None)
            modes.add((str(dtype), plan.mode))
            pr._gather(x, shape, strides, base, chan=chan, a=a, b=b, affine=affine, out=out)
            ref = torch.as_strided(x, shape, strides, base).float()
            if affine == pr.SCALE:
                ref = ref * a
            elif affine == pr.SCALE_ADD:
                ref = ref * a + b
            elif affine == pr.CHAN_SCALE_ADD:
                ref = ref * chan + b
            torch.cuda.synchronize()
            if not (torch.equal(out, ref.to(dtype)) and bool(torch.isnan(tail.float()).all())):
                failed.append(f"gather {dtype} {shape} {strides} base {base} affine {affine} "
                              f"(mode {plan.mode})")
    log(f"ragged sweep, movement: {2 * len(gather_cases(800))} maps, (dtype, unit mode) "
        f"{sorted(modes)}: {'ok' if not failed else 'FAIL ' + '; '.join(failed[:8])}")
    if len(modes) < 6:
        failed.append(f"the movement sweep ran only {sorted(modes)}")
    return failed


# the ragged sweep of the transposes (R, C, x off 16-byte alignment by an
# element): one element, a row, a column; R and C off every tile edge of
# the three routes (8 x 8 blocks; 8-column groups of 12 rows; slabs of up
# to 64 rows and 48 to 256 columns) up to 130 x 4100; aligned shapes that
# the first two routes leave to the slabs; probe C's and C2's shapes beside
# them; misaligned inputs
TRANSPOSE_SWEEP = ((1, 1, 0), (1, 9, 0), (7, 1, 0), (13, 37, 0), (13, 40, 0), (8, 264, 0),
                   (12, 4001, 0), (12, 4000, 1), (12, 4008, 0), (2, 8, 0), (14, 72, 0),
                   (6, 4000, 0), (65, 4000, 0), (65, 4001, 0), (64, 4096, 0), (127, 4000, 0),
                   (128, 4008, 0), (130, 4100, 0), (136, 20, 0), (72, 24, 1), (16, 257, 0),
                   (4001, 7, 0))
CHAIN_SEEDS = (1400, 1401, 1402, 1403)  # probe M's inputs beyond phase 3e's own seed


def transpose_sweep(torch, pr):
    """pr.transpose_routed at TRANSPOSE_SWEEP exactly against x.t(), the
    input at the head of a NaN-filled buffer (one element in where the case
    says so), the output before a NaN tail that must stay NaN. Returns the
    failures; the route the kernels report must be pr.transpose_plan's at
    every case, and all three routes must run."""
    failed, routes = [], set()
    for R, C, shift in TRANSPOSE_SWEEP:
        g = torch.Generator().manual_seed(R * C + shift)
        x = torch.randn(R * C + shift, generator=g).to(torch.bfloat16).to(DEVICE)
        x = guarded(torch, x)[shift:].view(R, C)
        out, tail = guarded_out(torch, (C, R), torch.bfloat16)
        _, route = pr.transpose_routed(x, out=out)
        routes.add(route)
        planned = pr.transpose_plan(R, C, (x.data_ptr(), out.data_ptr())).route
        torch.cuda.synchronize()
        if not (torch.equal(out, x.t()) and bool(torch.isnan(tail.float()).all())):
            failed.append(f"transpose {(R, C)} shift {shift}")
        if route != planned:
            failed.append(f"transpose {(R, C)} shift {shift}: launched {route}, planned {planned}")
    log(f"ragged sweep, transposes: {len(TRANSPOSE_SWEEP)} cases, routes {sorted(routes)}: "
        f"{'ok' if not failed else 'FAIL ' + '; '.join(failed)}")
    if routes != set(pr.TRANSPOSE_ROUTES):
        failed.append(f"the transpose sweep ran only {sorted(routes)}")
    return failed


def chain_sweep(torch, pr):
    """Probe M's chain at CHAIN_SEEDS against probe_m_plain (pr.TOLERANCE),
    inputs guarded, the output before a NaN tail that must stay NaN.
    Returns the failures."""
    failed, ratios = [], []
    for seed in CHAIN_SEEDS:
        args = tuple(guarded(torch, t) for t in pr.random_inputs("probe_m", seed, DEVICE))
        out, tail = guarded_out(torch, pr.SPECS["probe_m"].out[0], torch.float32)
        pr._chain(*args, out=out)
        ref = pr.probe_m_plain(*args)
        torch.cuda.synchronize()
        ok, err, ratio = pr.agrees("probe_m", out, ref)
        ratios.append(ratio)
        if not (ok and bool(torch.isnan(tail).all())):
            failed.append(f"probe_m seed {seed}: {ratio:.3g}")
    log(f"sweep, chain: {len(CHAIN_SEEDS)} seeds, max|d|/(|ref|+rms) "
        f"{', '.join(f'{r:.3g}' for r in ratios)} (limit {pr.TOLERANCE['probe_m']:g}): "
        f"{'ok' if not failed else 'FAIL ' + '; '.join(failed)}")
    return failed


# the ragged sweep of the tap-product kernels (B, H, W, Cin, Cout): H and W
# off every tile (17 x 23), one pixel, several column bands (64 x 200);
# batches 1-3, Cin 64, 128 and 192, Cout 64, 128, 192 and 256
TAP_SWEEP = ((1, 17, 23, 64, 64), (2, 17, 23, 128, 192), (3, 17, 23, 192, 256),
             (1, 1, 1, 64, 128), (2, 1, 1, 192, 64), (3, 1, 1, 128, 256),
             (1, 64, 200, 128, 128), (2, 64, 200, 192, 192), (3, 64, 200, 64, 256))


def tap_sweep(torch, pr, ic):
    """pr._taps (both tap-product kernels) at TAP_SWEEP against their plain
    versions (pr.TOLERANCE), every input at the head of a guarded buffer
    (the weight's tap images too), the output before a NaN tail that must
    stay NaN. Returns the failures."""
    failed = []
    for i, shape in enumerate(TAP_SWEEP):
        B, H, W, cin, cout = shape
        g = torch.Generator().manual_seed(1000 + i)
        w = 0.05 * torch.randn((cout, cin, 3, 3), generator=g)
        qw = pr.with_tap_images(ic.quantize_weight(w.to(DEVICE)))
        qw = qw._replace(taps=pr.TapImages(*(guarded(torch, t) for t in qw.taps)))
        xp, s = pr.quantize_padded(torch.randn((B, H, W, cin), generator=g).to(DEVICE))
        xp, scale = guarded(torch, xp), guarded(torch, (s * qw.scale).contiguous())
        bias = guarded(torch, (0.1 * torch.randn((cout,), generator=g)).to(DEVICE))
        for name in pr.CONV_VARIANTS:
            out, tail = guarded_out(torch, (B, H, W, cout), torch.bfloat16)
            pr._taps(name == "conv_taps9bf16", xp, qw, scale, bias, out=out)
            ref = pr.plain_version(name)(xp, qw, scale, bias)
            torch.cuda.synchronize()
            ok, err, ratio = pr.agrees(name, out, ref)
            if not (ok and bool(torch.isnan(tail.float()).all())):
                failed.append(f"{name} {shape}: {ratio:.3g}")
    log(f"ragged sweep, tap products: {len(pr.CONV_VARIANTS) * len(TAP_SWEEP)} cases: "
        f"{'ok' if not failed else 'FAIL ' + '; '.join(failed)}")
    return failed


L2_FLUSH_BYTES = 128 << 20  # a fill of more than twice the card's 50 MB L2
PROBE_TRACES = 5  # traces of each probe call, kernel and library in turns
PROBE_REPS = 20  # calls a trace, each after a flush
# phase 3e's device-time filter: each probe family's kernels, in this tree
# and in the designs before it (probe_sites.py times the parent's too)
PROBE_KERNELS = {"contraction": ("gemm_wgmma", "gemm_kernel"),
                 "movement": ("gather32_kernel", "gather_kernel", "transpose8_kernel",
                              "transpose_cols_kernel", "transpose_slab_kernel",
                              "transpose_kernel"),
                 "chain": ("chain_wgmma", "chain_kernel"),
                 "tap products": ("taps_kernel", "mmonly_wgmma", "taps9_wgmma")}


class L2Flush:
    """A call that writes L2_FLUSH_BYTES before each timed call, so that a
    probe finds its inputs in HBM, not in L2, whatever ran before it. Its
    kernel (PyTorch's fill) is named by FLUSH_EVENTS; the device-time sums
    leave it out and count it."""

    FLUSH_EVENTS = ("FillFunctor",)

    def __init__(self, torch):
        self.buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=DEVICE)

    def __call__(self):
        self.buf.fill_(1.0)

    def owns(self, key):
        return any(n in key for n in self.FLUSH_EVENTS)


def flushed_device_ms(torch, fn, flush, names=None, reps=PROBE_REPS):
    """Device time a call of fn with L2 flushed before each call: the mean
    over the last reps (flush, call) pairs of one trace (tools.device_times,
    the flush's fill as the marker) of the summed duration of a call's
    events, or of those whose name holds one of ``names`` where given."""
    return timing().device_times(fn, {"call": names}, reps, flush, flush.owns)["call"]


def in_turns(torch, calls, flush, traces=PROBE_TRACES, reps=PROBE_REPS):
    """{label: (fn, names)} -> {label: dict(median, min, max, samples)}:
    each call's flushed_device_ms, ``traces`` times, the labels in turns."""
    samples = {label: [] for label in calls}
    for _ in range(traces):
        for label, (fn, names) in calls.items():
            samples[label].append(flushed_device_ms(torch, fn, flush, names, reps))
    return {label: dict(median=statistics.median(v), min=min(v), max=max(v), samples=v)
            for label, v in samples.items()}


def device_kernels(torch, fn):
    """The device events (kernels, copies) of a call of fn, by name, from a
    trace of PROBE_REPS calls (taken again, up to five times, where it
    comes back empty)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROBE_REPS):
                fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages() if e.device_type.name == "CUDA"})
        if names:
            return names
    return ["the profiler showed no device event"]


def spread(t):
    return f"{t['median']:.5f} ({t['min']:.5f}-{t['max']:.5f})"


def time_layout_probe(torch, pr, name, args, flush):
    """A layout probe's kernel (its family's kernels by name) and its
    library call (every kernel but the flush's), in_turns; and the bound."""
    wrapper, family = pr.WRAPPERS[name], pr.SPECS[name].family
    calls = {"kernel": (lambda: wrapper(*args), PROBE_KERNELS[family])}
    library = probe_library(torch, name, args)
    if library is not None:
        calls["library"] = (library, None)
    with torch.no_grad():
        turns = in_turns(torch, calls, flush)
        out = wrapper(*args)
        library_kernels = [] if library is None else device_kernels(torch, library)
    bound_ms, by = probe_bound(pr, name, args, out)
    return dict(turns=turns, bound_ms=bound_ms, bound_by=by, library_kernels=library_kernels,
                bound_share=bound_ms / turns["kernel"]["median"])


def conv_variant_operands(torch, pr, ic, shape, seed):
    """The conv probe's operands at ``shape`` as phase 3e and
    tools/probe_sites.py time them: (v, qw, xp, scale, bias), with the
    weight's tap images made once, outside every timed call, where the
    package under test has them."""
    from shineon_tpu_torch.tools.conv_probe import conv_inputs

    v, w, bias = conv_inputs(shape, DEVICE, seed=seed)
    qw = ic.quantize_weight(w)
    if hasattr(pr, "with_tap_images"):
        qw = pr.with_tap_images(qw)
    xp, s = pr.quantize_padded(v)
    return v, qw, xp, (s * qw.scale).contiguous(), bias


def cudnn_taps_call(torch, xp, qw):
    """cuDNN's bf16 conv of taps9bf16's operands: F.conv2d of xp and wq as
    bf16, channels_last, no padding (the same products, without the
    kernel's epilogue), the operands converted outside the call."""
    cout, cin = qw.wq.shape[1:]
    xb = xp.to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = qw.wq.view(3, 3, cout, cin).permute(2, 3, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    return lambda: torch.nn.functional.conv2d(xb, wb)


def time_conv_variant(torch, pr, ic, name, operands, flush):
    """A conv variant's kernel beside kernel 4 on the same input and, for
    taps9bf16, cuDNN's bf16 conv (cudnn_taps_call), in_turns (5 calls a
    trace, L2 flushed before each); its bound (the tap products its
    function needs at the int8 peak, or the bytes) and, for taps9bf16, the
    bf16 peak's floor for the same products."""
    v, qw, xp, scale, bias = operands
    B, Hp, Wp, cin = xp.shape
    cout = qw.wq.shape[1]
    wrapper = pr.WRAPPERS[name]
    calls = {"kernel": (lambda: wrapper(xp, qw, scale, bias), PROBE_KERNELS["tap products"]),
             "int8_conv": (lambda: ic.conv3x3_int8(v, qw, bias, torch.bfloat16), CONV_KERNELS)}
    library = cudnn_taps_call(torch, xp, qw) if name == "conv_taps9bf16" else None
    if library is not None:
        calls["library"] = (library, None)
    with torch.no_grad():
        turns = in_turns(torch, calls, flush, reps=5)
        out = wrapper(xp, qw, scale, bias)
        library_kernels = [] if library is None else device_kernels(torch, library)
    ops = 2 * 9 * B * (Hp - 2) * (Wp - 2) * cin * cout
    bound_ms, by = bound(tap_products_needed(name) * ops / 9 / H100_INT8_OPS,
                         bytes_of(xp, qw.wq, scale, bias, out))
    return dict(turns=turns, bound_ms=bound_ms, bound_by=by, library=library,
                library_kernels=library_kernels, ops=ops,
                bf16_floor_ms=1e3 * ops / H100_BF16_FLOPS if library is not None else None)


def check_probes(torch, pr, ic, fs, card):
    """Phase 3e: each of the 15 layout probe kernels against its plain
    version on seeded random inputs of the probe's shapes and dtypes (exact
    for movement and transposes; pr.TOLERANCE for contractions and the
    chain), each input at the head of a NaN-filled buffer so that a read
    past it shows; the ragged sweeps of the contraction, gather and
    transpose kernels (gemm_sweep, gather_sweep, transpose_sweep) and probe
    M at more seeds (chain_sweep); then each probe timed: its kernel
    and the one PyTorch call that computes it by device time with L2
    flushed before every call, PROBE_TRACES traces each in turns (median,
    min, max), beside its bound, its plain version and the event time of a
    call. The two conv variants (mmonly, taps9bf16) against their plain
    versions at all four conv-probe shapes (batch 16), with one control
    that must fail (mmonly against the int8 conv), and in a ragged sweep
    (tap_sweep); each timed the same way in turns with kernel 4 at the same
    shape and, for taps9bf16, with cuDNN's bf16 conv of the same operands
    (its library call)."""
    from shineon_tpu_torch.tools.conv_probe import SHAPES

    errors, timings, failed = {}, {}, []
    for i, name in enumerate(pr.SPECS):
        args = tuple(guarded(torch, t) for t in pr.random_inputs(name, 500 + i, DEVICE))
        wrapper, plain = pr.WRAPPERS[name], pr.plain_version(name)
        out, ref = wrapper(*args), plain(*args)
        torch.cuda.synchronize()
        ok, err, ratio = pr.agrees(name, out, ref)
        tol = pr.TOLERANCE[name]
        log(f"check {name} ({pr.SPECS[name].family}) {[tuple(a.shape) for a in args]}: "
            f"max_abs_err={err:.4g} max|d|/(|ref|+rms)={ratio:.3g} "
            f"({'exact' if tol == 0 else f'limit {tol:g}'}) {'ok' if ok else 'FAIL'}")
        errors[name] = err
        if not ok:
            failed.append(name)
    failed += (gemm_sweep(torch, pr, fs) + gather_sweep(torch, pr) + transpose_sweep(torch, pr)
               + chain_sweep(torch, pr) + tap_sweep(torch, pr, ic))
    if failed:
        raise SystemExit(f"probe kernels disagree with their plain versions at "
                         f"{', '.join(failed)}")

    flush = L2Flush(torch)
    log(f"L2 flush: {L2_FLUSH_BYTES >> 20} MB written before every timed call, its device "
        f"events (names holding {' or '.join(flush.FLUSH_EVENTS)}) left out of the times")
    for i, name in enumerate(pr.SPECS):
        args = tuple(guarded(torch, t) for t in pr.random_inputs(name, 500 + i, DEVICE))
        wrapper, plain = pr.WRAPPERS[name], pr.plain_version(name)
        calls = {"kernel": lambda: wrapper(*args), "plain": lambda: plain(*args),
                 "library": probe_library(torch, name, args)}
        with torch.no_grad():
            ms = {k: None if fn is None else cuda_ms(torch, fn, 100) for k, fn in calls.items()}
            plain_dev = flushed_device_ms(torch, calls["plain"], flush, reps=5)
        t = time_layout_probe(torch, pr, name, args, flush)
        k, lib = t["turns"]["kernel"], t["turns"].get("library")
        log(f"time {name}: device, L2 flushed, median (min-max) of {PROBE_TRACES} traces in "
            f"turns: kernel {spread(k)} ms, library {'none' if lib is None else spread(lib)} ms; "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}, {100 * t['bound_share']:.1f}% of "
            f"the kernel's time); plain {plain_dev:.5f} ms; a call (event) " + ", ".join(
                f"{c} {'none' if v is None else f'{v:.4f} ms'}" for c, v in ms.items())
            + f"; the library call runs {[k[:70] for k in t['library_kernels']]} [{card}]")
        timings[name] = dict(
            ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=ms["library"], device_ms=k["median"],
            device_ms_min=k["min"], device_ms_max=k["max"], plain_device_ms=plain_dev,
            library_device_ms=None if lib is None else lib["median"],
            library_device_ms_min=None if lib is None else lib["min"],
            library_device_ms_max=None if lib is None else lib["max"],
            bound_share=t["bound_share"], library_kernels=t["library_kernels"],
            shape=[list(a.shape) for a in args] + [list(pr.SPECS[name].out[0])])
    for j, shape in enumerate(SHAPES):
        operands = conv_variant_operands(torch, pr, ic, shape, 600 + j)
        v, qw, xp, scale, bias = operands
        conv = ic.conv3x3_int8(v, qw, bias, torch.bfloat16)
        for name in pr.CONV_VARIANTS:
            wrapper, plain = pr.WRAPPERS[name], pr.plain_version(name)
            out, ref = wrapper(xp, qw, scale, bias), plain(xp, qw, scale, bias)
            torch.cuda.synchronize()
            ok, err, ratio = pr.agrees(name, out, ref)
            control = ""
            if name == "conv_mmonly":
                c_ok, _, c_ratio = pr.agrees(name, out, conv)
                ok, control = ok and not c_ok, f"; must fail: against the int8 conv {c_ratio:.3g}"
            log(f"check {name} {shape}: max_abs_err={err:.4g} max|d|/(|ref|+rms)={ratio:.3g} "
                f"(limit {pr.TOLERANCE[name]:g}){control} {'ok' if ok else 'FAIL'}")
            errors[(name, shape)] = err
            if not ok:
                failed.append(f"{name} {shape}")
                continue
            t = time_conv_variant(torch, pr, ic, name, operands, flush)
            with torch.no_grad():
                k_ms = cuda_ms(torch, lambda: wrapper(xp, qw, scale, bias), 10)
                p_ms = cuda_ms(torch, lambda: plain(xp, qw, scale, bias), 2)
                lib_ms = None if t["library"] is None else cuda_ms(torch, t["library"], 10)
            k, c, lib = t["turns"]["kernel"], t["turns"]["int8_conv"], t["turns"].get("library")
            rate = tap_products_needed(name) * t["ops"] / 9 / k["median"] / 1e9
            floor = ("" if t["bf16_floor_ms"] is None else
                     f", bf16-peak floor {t['bf16_floor_ms']:.4f} ms "
                     f"({100 * t['bf16_floor_ms'] / k['median']:.1f}%)")
            log(f"time {name} {shape}: device, L2 flushed, in turns: kernel {spread(k)} ms (the "
                f"products it issues at {rate:.1f} Tops/s), int8 conv kernel {spread(c)} ms "
                f"({t['ops'] / c['median'] / 1e9:.1f} Tops/s), library "
                f"{'none' if lib is None else spread(lib)} ms; bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}, {100 * t['bound_ms'] / k['median']:.1f}%){floor}; event: "
                f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
                f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; the library call runs "
                f"{[n[:70] for n in t['library_kernels']]} [{card}]")
            timings[(name, shape)] = dict(
                ms=k_ms, plain_ms=p_ms, bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=lib_ms, device_ms=k["median"], device_ms_min=k["min"],
                device_ms_max=k["max"], int8_conv_ms=c["median"], int8_conv_ms_min=c["min"],
                int8_conv_ms_max=c["max"],
                library_device_ms=None if lib is None else lib["median"],
                library_device_ms_min=None if lib is None else lib["min"],
                library_device_ms_max=None if lib is None else lib["max"],
                library_kernels=t["library_kernels"], bf16_floor_ms=t["bf16_floor_ms"],
                mma_rate_tops=rate, bound_share=t["bound_ms"] / k["median"],
                shape=dict(zip("B H W Cin Cout".split(), shape)))
            del out, ref
        del v, xp, conv, operands
    if failed:
        raise SystemExit(f"probe kernels disagree with their plain versions (or the control "
                         f"passes) at {', '.join(failed)}")
    return errors, timings


def run_probe_tools(pr, ic):
    """The port's two probe tools as a user runs them, every launch count at
    0 before each run: layout_caps (each of the 15 probes once: 4
    contraction, 10 movement and 1 chain launch) and conv_probe, check only,
    at SHAPES[0] for each of its seven variants (one tap-product launch for
    mmonly and taps9bf16, one kernel-4 launch for the five others). Returns
    each probe wrapper's launches in the run that drives it."""
    from collections import Counter

    from shineon_tpu_torch.tools import conv_probe, layout_caps

    counters = {**pr.WRAPPERS, "int8_conv3x3": ic.conv3x3_int8}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    reset()
    rc = layout_caps.main()
    got = counts()
    families = Counter()
    for name, spec in pr.SPECS.items():
        families[spec.family] += got[name]
    want = {name: int(name in pr.SPECS) for name in counters}
    log(f"layout_caps: exit {rc}, launches by family {dict(families)} "
        f"(expected contraction 4, movement 10, chain 1)")
    if rc != 0 or got != want:
        raise SystemExit(f"layout_caps failed or launched {got}, expected {want}")
    tool_launches = {name: got[name] for name in pr.SPECS}
    for variant in conv_probe.VARIANTS:
        reset()
        rc = conv_probe.main(["--variant", variant, "--only", "0", "--iters", "0"])
        got = counts()
        diagnostic = conv_probe.DIAGNOSTIC.get(variant)
        kernel = "int8_conv3x3" if diagnostic is None else diagnostic.__name__
        want = {name: int(name == kernel) for name in counters}
        log(f"conv_probe --variant {variant}: exit {rc}, {kernel} launches {got[kernel]}")
        if rc != 0 or got != want:
            raise SystemExit(f"conv_probe --variant {variant} failed or launched {got}")
        if kernel in pr.CONV_VARIANTS:
            tool_launches[kernel] = got[kernel]
    return tool_launches


def set_gammas(torch, network, seed):
    """Every attention gamma of ``network`` drawn from N(GAMMA_MEAN,
    GAMMA_STD), seeded: at 0 an attention block is the identity, whatever
    the kernel computes."""
    from shineon_tpu_torch.networks.attention import SelfAttention

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in network.modules():
            if isinstance(m, SelfAttention):
                m.gamma.copy_(GAMMA_MEAN + GAMMA_STD * torch.randn(m.gamma.shape, generator=g))


def build_attention_clip(torch, batch, device, seed, **overrides):
    """build_inference's steps for the attention clip, with one cut: every
    attention gamma is drawn from N(GAMMA_MEAN, GAMMA_STD) (seeded) before
    the warm-up rollouts. At its init value 0 an attention block is the
    identity whatever the kernel computes, so the clip would check nothing."""
    from shineon_tpu_torch.options import ATTENTION_PLACEMENT
    from shineon_tpu_torch.serving import build_models, make_one_clip, warm_up

    warp, sams, raw = build_models(batch, device, seed, **{**ATTENTION_PLACEMENT, **overrides})
    set_gammas(torch, sams.generator, seed + 2)
    warm_up(sams, raw)
    return make_one_clip(warp, sams), warp, sams, raw, sams.n_frames_total


def check_small_clip(torch):
    """Phase 4: a small f32 clip through the kernels on the card against
    the same weights and batch through the plain versions on the CPU; then
    the same clip with int8 serving (every chain quantized, and the conv
    gate's floor at 256 channels, so the middle block's two 3x3 convs run
    the int8 conv). The int8 clip's card-vs-CPU distance is printed beside
    its distance from the fp clip, and the first frame's must be under a
    quarter of it. (Quantization flips from one-ulp differences of the f32
    sums cascade through the int8 convs and the frames fed back: at these
    random weights a 1e-6 change of one weight tensor moves the whole int8
    clip by a third of its int8-vs-fp distance at this floor, by all of it
    at the default floor of 64, and its first frame by 0.07 of it here.)
    Last, the fp clip with attention in the middle block (32x24, 768
    tokens) and decoder block 0 (64x48, 3072 tokens), every gamma nonzero:
    its first frame within the fp clip's limit, every frame printed. Its
    later frames are chaotic at these random weights (peaked attention rows,
    frames fed back): beside them the CPU clip's own change under a 1e-6
    relative change of one conv weight (encode_conv_in) is printed."""
    from shineon_tpu_torch.models.sams_model import SamsModel
    from shineon_tpu_torch.models.warp_model import WarpModel
    from shineon_tpu_torch.ops.fused_attention import sagan_attention
    from shineon_tpu_torch.ops.fused_spade import fused_multispade_modulate as fmm
    from shineon_tpu_torch.ops.int8_conv import conv3x3_int8
    from shineon_tpu_torch.serving import build_inference, make_one_clip

    def rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()

    small = dict(fine_height=128, fine_width=96, n_frames_total=3, n_frames_now=3,
                 ngf_pow_outer=6, ngf_pow_inner=8, num_middle=1, precision=32)
    refs = {}
    variants = {"fp": {}, "int8": dict(int8_spade=True, int8_min_channels=256),
                "attention": dict(attention_decoder_indices=("0",))}
    for variant, opts in variants.items():
        build = build_attention_clip if variant == "attention" else (
            lambda torch, *a, **kw: build_inference(*a, **kw))
        one_clip, warp, sams, raw, _ = build(torch, 2, device=DEVICE, seed=7, **small, **opts)
        count = lambda: (fmm.launches, fmm.int8_launches, fmm.absmax_launches,  # noqa: E731
                         conv3x3_int8.launches, sagan_attention.launches)
        before = count()
        out = one_clip(raw).cpu()
        launched = [a - b for a, b in zip(count(), before)]
        cpu_sams, cpu_warp = SamsModel(sams.opt, "cpu"), WarpModel(warp.opt, "cpu")
        cpu_sams.generator.load_state_dict(sams.generator.state_dict())
        cpu_warp.gmm.load_state_dict(warp.gmm.state_dict())
        ref = make_one_clip(cpu_warp, cpu_sams)({k: v.cpu() for k, v in raw.items()})
        refs[variant] = ref
        err = rel(out, ref)
        finite = bool(torch.isfinite(out).all())
        if variant != "int8":
            frames = [rel(out[:, i], ref[:, i]) for i in range(out.shape[1])]
            held = frames[0] if variant == "attention" else err
            ok = launched[0] > 0 and finite and held <= 1e-3
            ok = ok and (launched[4] > 0) == (variant == "attention")
            shifts = ""
            if variant == "attention":
                with torch.no_grad():
                    cpu_sams.generator.encode_conv_in.weight.mul_(1 + 1e-6)
                moved = make_one_clip(cpu_warp, cpu_sams)({k: v.cpu() for k, v in raw.items()})
                shifts = (", CPU clip moved by a 1e-6 weight change: frames " + ", ".join(
                    f"{rel(moved[:, i], ref[:, i]):.3g}" for i in range(ref.shape[1])))
            log(f"small clip f32 {variant} (2, 3, 128, 96): card vs CPU plain max rel err "
                f"{err:.3g} (frames {', '.join(f'{e:.3g}' for e in frames)}{shifts}), "
                f"{launched[0]} chain and {launched[4]} attention launches "
                f"{'ok' if ok else 'FAIL'}")
        else:
            gap, err1 = rel(refs["int8"], refs["fp"]), rel(out[:, 0], ref[:, 0])
            gap1 = rel(refs["int8"][:, 0], refs["fp"][:, 0])
            ok = (launched[0] == 0 and min(launched[1:4]) > 0 and launched[4] == 0 and finite
                  and err1 < 0.25 * gap1)
            log(f"small clip f32 int8 (2, 3, 128, 96): card vs CPU plain max rel err "
                f"{err:.3g} (first frame {err1:.3g}), CPU int8 vs fp {gap:.3g} (first frame "
                f"{gap1:.3g}, limit a quarter of it); launches chain {launched[1]} "
                f"pre-pass {launched[2]} conv {launched[3]} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("small clip on the card disagrees with the CPU plain path")


def run_clip(torch, label, build, counters, expected):
    """Phase 5: build the full-width clip (``build()`` returns what
    build_inference does), run it once with every launch count at 0, check
    frames and launches. Returns the clip (a function of no argument), the
    launches, the frames and the number of convs the built generator runs
    in int8."""
    from shineon_tpu_torch.networks.layers import Conv2d
    from shineon_tpu_torch.networks.normalization import SpectralConv2d

    t0 = time.perf_counter()
    one_clip, warp, sams, raw, n_frames = build()
    int8_convs = sum(1 for m in sams.generator.modules()
                     if isinstance(m, (Conv2d, SpectralConv2d)) and m.int8)
    torch.cuda.synchronize()
    log(f"clip {label} built and warmed (3 rollouts): {time.perf_counter() - t0:.1f} s")
    one_clip(raw)  # warm-up call
    torch.cuda.synchronize()
    for owner, attr in counters.values():
        setattr(owner, attr, 0)
    frames = one_clip(raw)
    torch.cuda.synchronize()
    launches = {name: getattr(owner, attr) for name, (owner, attr) in counters.items()}
    shape = (BATCH, n_frames) + FRAME + (3,)
    finite = bool(torch.isfinite(frames.float()).all())
    want = {name: n_frames * per_frame for name, per_frame in expected.items()}
    log(f"clip {label}: frames {tuple(frames.shape)} {frames.dtype} finite={finite} "
        f"max|frame|={frames.float().abs().max().item():.4g} launches {launches} "
        f"(expected {want})")
    if tuple(frames.shape) != shape or not finite or launches != want:
        raise SystemExit(f"serving clip {label} failed its checks")
    return (lambda: one_clip(raw)), launches, n_frames, int8_convs


def time_clips(torch, clips, rounds=5):
    """Host time of each clip, in turns (a, b, a, b, ...), ending in a
    synchronize: median and samples in ms."""
    samples = {name: [] for name in clips}
    for _ in range(rounds):
        for name, clip in clips.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clip()
            torch.cuda.synchronize()
            samples[name].append(1e3 * (time.perf_counter() - t0))
    return {name: (statistics.median(v), v) for name, v in samples.items()}


# phase 6: the training step. The small step's options (f32, card against
# CPU), and the full-width steps run: TRAIN_STEPS exact steps, then as many
# fast_gan_step steps, of each configuration, remat on as build_train sets it
TRAIN_SMALL = dict(fine_height=64, fine_width=48, n_frames_total=3, n_frames_now=3,
                   ngf_pow_outer=4, ngf_pow_inner=6, num_middle=1, ndf=16, precision=32)
TRAIN_STEPS = 3
# passes over the clip that launch attention, remat on: the generator step,
# its backward recompute and (exact step only) the regeneration
TRAIN_PASSES = {"exact": 3, "fast": 2}
STAT_NAMES = ("running_mean", "running_var", ".u", ".sigma")


def train_nets(model):
    return {"generator": model.generator, "d_multi": model.multiscale_discriminator,
            "d_temporal": model.temporal_discriminator}


def state_dicts(model):
    return {name: {k: v.detach().float().cpu().clone() for k, v in net.state_dict().items()}
            for name, net in train_nets(model).items()}


def step_disagreement(before, out, ref, metrics, ref_metrics, lrs):
    """The card's step against the CPU's from the same state, as the CPU
    tests hold the port against the JAX step: (the worst metric's
    |diff| / max(|ref|, 1), the worst statistic's |diff| / max |ref|, the
    share of each network's parameter entries whose Adam move differs by
    more than 1e-3 lr: after Adam's first step every entry moves by about
    lr * sign(g), and entries whose gradient lies within the two devices'
    f32 difference of zero take either sign)."""
    m_err = max(abs(metrics[k] - r) / max(abs(r), 1.0) for k, r in ref_metrics.items())
    s_err, flips = 0.0, {}
    for net, ref_sd in ref.items():
        lr = lrs[net]
        flipped = total = 0
        for key, r in ref_sd.items():
            o, p0 = out[net][key], before[net][key]
            if key.endswith(STAT_NAMES):
                s_err = max(s_err, ((o - r).abs().max() / r.abs().max().clamp_min(1e-12)).item())
            else:
                moved = ((o - p0) - (r - p0)).abs() > 1e-3 * lr + 2.4e-7 * p0.abs()
                flipped += int(moved.sum())
                total += r.numel()
        flips[net] = flipped / total
    return m_err, s_err, flips


def check_small_step(torch):
    """Phase 6a: one small f32 exact step (TRAIN_SMALL, batch 2, remat) on
    the card against the same step on the CPU, from the same seeded state;
    then the same with an attention block (decoder block 0, 32x24, 768
    tokens, every gamma nonzero), whose forward on the card is the kernel.
    Limits: metrics and statistics within 1e-3, at most 0.5% of the
    generator's parameter entries and 3% of a discriminator's flipped (the
    CPU tests hold the port against the JAX step to 0.1% and 3%; the card's
    convs round otherwise than the CPU's, and a relu kink within that
    rounding of zero takes the other side: 0.04-0.08% of the generator's
    entries flipped in the first runs)."""
    from shineon_tpu_torch.bench import build_train
    from shineon_tpu_torch.ops.fused_attention import sagan_attention

    for variant, opts in (("plain", {}), ("attention", dict(attention_decoder_indices=("0",)))):
        runs = []
        before_launches = sagan_attention.launches
        for device in (DEVICE, "cpu"):
            model, state, step, raw, _ = build_train(2, device=device, seed=7,
                                                     **TRAIN_SMALL, **opts)
            set_gammas(torch, model.generator, 8)
            before = state_dicts(model)
            metrics = {k: float(v) for k, v in step(state, raw).items()}
            runs.append((state_dicts(model), metrics))
        launched = sagan_attention.launches - before_launches
        (out, metrics), (ref, ref_metrics) = runs
        lrs = {"generator": model.opt.lr, "d_multi": model.opt.lr_D,
               "d_temporal": model.opt.lr_D}
        m_err, s_err, flips = step_disagreement(before, out, ref, metrics, ref_metrics, lrs)
        finite = all(v == v and abs(v) != float("inf") for v in metrics.values())
        ok = (finite and m_err <= 1e-3 and s_err <= 1e-3 and flips["generator"] <= 5e-3
              and max(flips["d_multi"], flips["d_temporal"]) <= 3e-2
              and (launched > 0) == (variant == "attention"))
        log(f"small step f32 {variant} (2, 3, 64, 48): card vs CPU worst metric {m_err:.3g}, "
            f"worst statistic {s_err:.3g}, flipped parameter entries "
            + ", ".join(f"{k} {v:.2%}" for k, v in flips.items())
            + f", {launched} attention launches {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the small training step on the card disagrees with the CPU")


def step_readings(t, names, top=5):
    """Readings of marked exact steps (shineon_tpu_torch.bench.step_trace's
    ``t``): wall ms, device busy ms, idle share, the device ms and launches
    a step of the kernels whose name holds one of ``names``, and the
    ``top`` kernels by device time (name, ms, launches)."""
    mine = [v for name, v in t["ops"].items() if any(n in name for n in names)]
    ranked = sorted(t["ops"].items(), key=lambda kv: -kv[1][0])[:top]
    return dict(wall_ms=t["wall"], busy_ms=t["busy"], idle_share=1 - t["busy"] / t["wall"],
                kernel_ms=sum(ms for ms, _ in mine), kernel_calls=sum(n for _, n in mine),
                top=[(name[:90], ms, n) for name, (ms, n) in ranked])


def run_training(torch, label, counters, card, attention, profile_dir):
    """Phase 6b-d: build the full-width training step (256x192, 5 frames,
    widths 2^6..2^10, bf16, batch 4, remat, seeded weights; with
    ``attention`` the clip's ATTENTION_PLACEMENT, every gamma nonzero); with
    every launch count at 0, run TRAIN_STEPS exact steps, then TRAIN_STEPS
    fast_gan_step steps; check every metric finite, all three networks'
    parameters changed, and the launches: attention once a block a frame a
    pass (TRAIN_PASSES), the first exact step on its own too, no serving
    kernel; time the steps and read the peak device memory. With
    ``attention``, trace one marked exact step through bench.profile_train
    (bench --profile --attention's step table, written into
    ``profile_dir``). Returns the readings."""
    from shineon_tpu_torch.bench import TRAIN_BATCH, build_train, profile_train
    from shineon_tpu_torch.networks.attention import SelfAttention
    from shineon_tpu_torch.ops.fused_attention import sagan_attention
    from shineon_tpu_torch.options import ATTENTION_PLACEMENT

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, state, _, raw, n_frames = build_train(
        TRAIN_BATCH, **(ATTENTION_PLACEMENT if attention else {}))
    if attention:
        set_gammas(torch, model.generator, 422)
    blocks = sum(isinstance(m, SelfAttention) for m in model.generator.modules())
    before = {n: [p.detach().clone() for p in net.parameters()]
              for n, net in train_nets(model).items()}
    torch.cuda.synchronize()
    log(f"training {label} built: {time.perf_counter() - t0:.1f} s, {blocks} attention blocks")
    for owner, attr in counters.values():
        setattr(owner, attr, 0)
    times, first_step = {}, None
    t_steps = time.perf_counter()
    for kind in ("exact", "fast"):
        model.opt.fast_gan_step = kind == "fast"
        step = model.make_train_step()
        times[kind] = []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, raw)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) * 1e3)
            if first_step is None:
                first_step = sagan_attention.launches
            values = [float(v) for v in metrics.values()]
            if not all(v == v and abs(v) != float("inf") for v in values):
                raise SystemExit(f"training {label} {kind}: a metric is not finite: {metrics}")
    launches = {name: getattr(owner, attr) for name, (owner, attr) in counters.items()}
    log(f"training {label}: {2 * TRAIN_STEPS} steps {time.perf_counter() - t_steps:.1f} s")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    changed = {n: any(not torch.equal(a, b) for a, b in zip(ps, train_nets(model)[n].parameters()))
               for n, ps in before.items()}
    per_step = {kind: passes * n_frames * blocks for kind, passes in TRAIN_PASSES.items()}
    want = {name: 0 for name in counters}
    want["sagan_attention"] = TRAIN_STEPS * (per_step["exact"] + per_step["fast"])
    log(f"training {label}: loss {loss:.4g}, parameters changed {changed}, launches {launches} "
        f"(expected {want}; attention in the first exact step {first_step}, expected "
        f"{per_step['exact']})")
    if launches != want or first_step != per_step["exact"] or not all(changed.values()):
        raise SystemExit(f"training {label} failed its checks")
    med = {kind: statistics.median(v) for kind, v in times.items()}
    log(f"training {label} step times (batch {TRAIN_BATCH} x {n_frames} frames, remat): exact "
        f"{[round(v, 1) for v in times['exact']]} ms, fast {[round(v, 1) for v in times['fast']]}"
        f" ms; medians {med['exact']:.1f} / {med['fast']:.1f} ms; peak memory {peak:.2f} GiB "
        f"above the {base / 2**30:.2f} GiB held before [{card}]")
    trace = None
    if attention:
        model.opt.fast_gan_step = False
        trace = step_readings(profile_train(
            profile_dir, med["exact"], attention=True, steps=1,
            warmed=(model.make_train_step(), state, raw, n_frames)), ATTENTION_KERNELS)
        log(f"training {label} traced exact step: wall {trace['wall_ms']:.1f} ms, device busy "
            f"{trace['busy_ms']:.1f} ms, idle share {trace['idle_share']:.3f}, attention "
            f"kernel {trace['kernel_ms']:.3f} ms in {trace['kernel_calls']:g} calls [{card}]")
    del model, state, raw, before
    return dict(times=times, median_ms=med, peak_gib=peak, launches=launches,
                step_launches=per_step, trace=trace)


# phase 7: GMM and TOM training, and SAMS's validation and visual steps. The
# small steps (f32, card against CPU): the GMM at 128x96, the smallest fine
# size its regression tower takes (a correlation map of 8x6), ngf 16; TOM
# at 64x64, two frames, the flow warp, its three attention levels
SMALL_GMM = dict(fine_height=128, fine_width=96, ngf=16, precision=32)
SMALL_TOM = dict(fine_height=64, fine_width=64, n_frames_total=2, flow_warp=True, precision=32)
# the small TOM's attention shapes at batch 2 (ngf 108: C = 864 inside, 432
# at the (4, 8) level's up side), N = 1 at the innermost level
SMALL_TOM_ATTENTION_SHAPES = ((1, 108, 864, 0), (4, 108, 864, 0), (16, 108, 864, 0),
                              (64, 54, 432, 0))
# share of a network's parameter entries whose Adam move may differ between
# card and CPU (Adam's first step is lr * sign(g)): a GMM sample point that
# straddles a pixel edge within the two devices' f32 difference moves the
# TPS gradient by percents at random weights (the CPU tests see 0.7% of
# the entries flip against the JAX package); TOM at 64x64 has a 1x1
# innermost map, whose upconv's centre tap (1.1% of the entries) and the
# biases that feed a norm have an exact gradient of 0
STAGE_FLIP_LIMIT = 0.02
STAGE_STEPS = 3
STAGE_ATTENTION = {"warp": 0, "unet_mask": 6}  # attention launches a step, one frame


def module_state(module):
    return {k: v.detach().float().cpu().clone() for k, v in module.state_dict().items()}


def check_small_stage_steps(torch):
    """Phase 7a: one small f32 training step of the GMM (SMALL_GMM) and of
    TOM (SMALL_TOM, every gamma nonzero) on the card against the same step
    on the CPU, from the same seeded state (batch 2). Limits: every metric
    and the GMM's running statistics within 1e-3; at most STAGE_FLIP_LIMIT
    of the parameter entries flipped; TOM's step on the card launches the
    attention kernel once a block (6), the GMM's none."""
    from shineon_tpu_torch.bench import build_train
    from shineon_tpu_torch.ops.fused_attention import sagan_attention

    for kind, opts in (("warp", SMALL_GMM), ("unet_mask", SMALL_TOM)):
        runs = []
        for device in (DEVICE, "cpu"):
            model, state, step, raw, _ = build_train(2, device=device, seed=7, model=kind,
                                                     **opts)
            (name, net), = state.nets.items()
            if kind == "unet_mask":
                set_gammas(torch, net.module, 8)
            before = {name: module_state(net.module)}
            launches = sagan_attention.launches
            metrics = {k: float(v) for k, v in step(state, raw).items()}
            runs.append(({name: module_state(net.module)}, metrics,
                         sagan_attention.launches - launches))
        (out, metrics, launched), (ref, ref_metrics, _) = runs
        m_err, s_err, flips = step_disagreement(before, out, ref, metrics, ref_metrics,
                                                {name: model.opt.lr})
        finite = all(v == v and abs(v) != float("inf") for v in metrics.values())
        ok = (finite and m_err <= 1e-3 and s_err <= 1e-3 and flips[name] <= STAGE_FLIP_LIMIT
              and launched == STAGE_ATTENTION[kind])
        log(f"small step f32 {kind} (batch 2, {opts['fine_height']}x{opts['fine_width']}): "
            f"card vs CPU worst metric {m_err:.3g}, worst statistic {s_err:.3g}, flipped "
            f"parameter entries {flips[name]:.2%} (limit {STAGE_FLIP_LIMIT:.0%}), {launched} "
            f"attention launches {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the small {kind} training step on the card disagrees with the CPU")


def finite_metrics(metrics):
    values = [float(v) for v in metrics.values()]
    return all(v == v and abs(v) != float("inf") for v in values)


def run_stage_training(torch, kind, counters, card):
    """Phase 7b and 7d for ``kind`` ("warp", the GMM; "unet_mask", TOM) at
    its documented configuration (256x192, batch 8, bf16, seeded weights;
    TOM's gammas drawn nonzero): with every launch count at 0, STAGE_STEPS
    training steps, then one validation and one visual step; every metric
    finite, every parameter tensor changed, the attention kernel launched
    STAGE_ATTENTION times a step (train, val and visual alike) and no other
    kernel. Then the step time (shineon_tpu_torch.bench.time_train_steps:
    median, min and max of 3 windows of 8 steps), the peak device memory
    and one traced training step. Returns the readings."""
    from shineon_tpu_torch.bench import build_train, step_trace, time_train_steps

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, state, step, raw, _ = build_train(TOM_BATCH, model=kind)
    (name, net), = state.nets.items()
    if kind == "unet_mask":
        set_gammas(torch, net.module, 423)
    before = {n: p.detach().clone() for n, p in net.module.named_parameters()}
    torch.cuda.synchronize()
    log(f"training {kind} built: {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in before.values())} parameters")
    for owner, attr in counters.values():
        setattr(owner, attr, 0)
    read = lambda: {n: getattr(owner, attr) for n, (owner, attr) in counters.items()}  # noqa: E731
    metrics = [step(state, raw) for _ in range(STAGE_STEPS)]
    torch.cuda.synchronize()
    train_launches = read()
    val = model.make_val_step()(state, raw)
    torch.cuda.synchronize()
    val_launches = read()
    visuals = model.make_visual_step()(state, raw)
    torch.cuda.synchronize()
    vis_launches = read()
    finite = (all(finite_metrics(m) for m in metrics) and finite_metrics(val)
              and all(bool(torch.isfinite(v.float()).all()) for v in visuals.values()))
    unchanged = [n for n, p in net.module.named_parameters() if torch.equal(p, before[n])]
    per_step = STAGE_ATTENTION[kind]
    want = [{**{n: 0 for n in counters}, "sagan_attention": per_step * calls}
            for calls in (STAGE_STEPS, STAGE_STEPS + 1, STAGE_STEPS + 2)]
    loss_key = "loss/G"
    log(f"training {kind}: losses {[round(float(m[loss_key]), 5) for m in metrics]}, val "
        f"checkpoint_on {float(val['checkpoint_on']):.5g}, launches after the train steps "
        f"{train_launches}, after the val step {val_launches}, after the visual step "
        f"{vis_launches} (expected {want}), unchanged parameter tensors {unchanged}")
    if not finite or unchanged or [train_launches, val_launches, vis_launches] != want:
        raise SystemExit(f"training {kind} failed its checks")
    median, lo, hi = time_train_steps(step, state, raw, repeats=3, loss_key=loss_key)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"training {kind} step time (batch {TOM_BATCH}, 256x192, bf16): median {median * 1e3:.2f}"
        f" ms (min {lo * 1e3:.2f}, max {hi * 1e3:.2f}) of 3 windows of 8 steps; peak memory "
        f"{peak:.2f} GiB above the {base / 2**30:.2f} GiB held before [{card}]")
    trace = step_readings(step_trace(step, state, raw, 1), ATTENTION_KERNELS)
    log(f"training {kind} traced step: wall {trace['wall_ms']:.2f} ms, device busy "
        f"{trace['busy_ms']:.2f} ms, idle share {trace['idle_share']:.3f}, attention kernel "
        f"{trace['kernel_ms']:.4f} ms in {trace['kernel_calls']:g} calls; top device time "
        + "; ".join(f"{name} {ms:.3f} ms x{n:g}" for name, ms, n in trace["top"]) + f" [{card}]")
    del model, state, step, raw, metrics, val, visuals, before
    return dict(median_ms=median * 1e3, min_ms=lo * 1e3, max_ms=hi * 1e3, peak_gib=peak,
                launches=vis_launches, step_launches=per_step, trace=trace)


def run_sams_val(torch, label, counters, card, expected, attention):
    """Phase 7c: the production SAMS model (batch 4, bf16; with
    ``attention`` ATTENTION_PLACEMENT, every gamma nonzero), its running
    statistics warmed by serving.warm_up's train-mode rollouts, then one
    validation step and one visual step, each with every launch count at 0:
    the fused chain kernel (and attention) launched as often as the clip
    has sites, no other kernel; the metrics and checkpoint_on finite, the
    visual clip finite and (B, 5, 256, 192, 3). Times the val step (median
    of 3 after the checked call). Returns the readings."""
    from shineon_tpu_torch.bench import TRAIN_BATCH, build_train
    from shineon_tpu_torch.options import ATTENTION_PLACEMENT
    from shineon_tpu_torch.serving import warm_up

    gc.collect()
    torch.cuda.empty_cache()
    model, state, _, raw, n_frames = build_train(
        TRAIN_BATCH, **(ATTENTION_PLACEMENT if attention else {}))
    if attention:
        set_gammas(torch, model.generator, 424)
    warm_up(model, raw)
    launches = []

    def counted(fn):
        torch.cuda.synchronize()
        for owner, attr in counters.values():
            setattr(owner, attr, 0)
        out = fn(state, raw)
        torch.cuda.synchronize()
        launches.append({n: getattr(owner, attr) for n, (owner, attr) in counters.items()})
        return out

    val = counted(model.make_val_step())
    frames = counted(model.make_visual_step())["all_gen_frames"]
    want = {n: expected.get(n, 0) * n_frames for n in counters}
    shape = (TRAIN_BATCH, n_frames) + FRAME + (3,)
    ok = (finite_metrics(val) and bool(torch.isfinite(frames).all())
          and tuple(frames.shape) == shape and launches == [want, want])
    val_step = model.make_val_step()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(val_step(state, raw)["checkpoint_on"])
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"SAMS {label} val step: checkpoint_on {float(val['checkpoint_on']):.5g}, loss "
        f"{float(val['loss']):.5g}, launches {launches[0]}; visual step: frames "
        f"{tuple(frames.shape)}, launches {launches[1]} (expected {want} each); val step "
        f"{statistics.median(times):.1f} ms (median of {[round(t, 1) for t in times]}) "
        f"[{card}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the SAMS {label} val or visual step failed its checks")
    del model, state, raw, val, frames
    return dict(launches=launches[0], val_ms=statistics.median(times))



# phase 8: FlowNet2 flow annotation. The path holds no Pallas kernel (the JAX
# package computes it in XLA), so it runs PyTorch's and cuDNN's kernels and
# launches none of the hand-written ones. 8a holds the card against the CPU
# port with TF32 off: |card - CPU| <= FLOW_TOL * (|ref| + rms(ref)).
FLOW_SEED = 420
FLOW_TOL = 1e-4
FLOW_BATCHES = (4, 8)  # generate_flow_annotations' default batch, and twice it
FLOW_CALLS = 5  # timed calls a batch, after a warm-up call
H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core peak, H100 SXM data sheet


def cudnn_defaults(torch, allow_tf32):
    """PyTorch's default cuDNN settings, TF32 as asked, for the block it
    wraps (main turns TF32 off for the kernel phases)."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                      allow_tf32=allow_tf32)


def flow_disagreement(out, ref):
    """max |out - ref| / (|ref| + rms(ref)), elementwise."""
    rms = ref.pow(2).mean().sqrt()
    return ((out - ref).abs() / (ref.abs() + rms)).max().item()


def check_flownet_card(torch):
    """Phase 8a: seeded random FlowNet2 weights built once on the CPU and
    copied to the card; a 64x64 uint8 pair at batch 1, f32. The card's flow
    with TF32 off against the CPU port's, a control with one flow value
    moved by ten times its tolerance that must fail, and the card's error
    with TF32 on, for information."""
    import copy

    import numpy as np

    from shineon_tpu_torch.models.flownet import build_flownet2

    cpu_net = build_flownet2(FLOW_SEED, "cpu")
    card_net = copy.deepcopy(cpu_net).to(DEVICE)
    rng = np.random.RandomState(FLOW_SEED)
    im1, im2 = (torch.from_numpy(rng.randint(0, 256, (1, 64, 64, 3)).astype(np.float32))
                for _ in range(2))
    with torch.no_grad():
        ref = cpu_net(im1, im2)
        outs = {}
        for tf32 in (False, True):
            with cudnn_defaults(torch, tf32):
                outs[tf32] = card_net(im1.to(DEVICE), im2.to(DEVICE)).cpu()
    err, err_tf32 = flow_disagreement(outs[False], ref), flow_disagreement(outs[True], ref)
    perturbed = outs[False].clone()
    rms = ref.pow(2).mean().sqrt()
    perturbed[0, 31, 17, 1] += 10 * FLOW_TOL * (ref[0, 31, 17, 1].abs() + rms)
    control = flow_disagreement(perturbed, ref)
    finite = bool(torch.isfinite(outs[False]).all())
    log(f"flownet2 card against CPU (64x64, batch 1, f32, TF32 off): max |d|/(|ref| + rms) "
        f"{err:.3g} (tolerance {FLOW_TOL:g}), max |ref| {ref.abs().max().item():.4g}, rms "
        f"{rms.item():.4g}; control with one value moved {control:.3g} (must exceed it); "
        f"TF32 on: {err_tf32:.3g}")
    if ref.shape != (1, 64, 64, 2) or not finite or err > FLOW_TOL or control <= FLOW_TOL:
        raise SystemExit("FlowNet2 on the card disagrees with the CPU port")
    return {"max_rel_err": err, "control": control, "max_rel_err_tf32": err_tf32}


def flownet_work(torch, model, im1, im2):
    """The analytic operations of one FlowNet2 forward at these inputs (2 per
    multiply-add): every conv and deconv by its shapes, read off forward
    hooks, plus the cost volume (2 * C * D^2 at each pixel of FlowNetC's
    conv3 map). Also returns the cost volume's share of them, that conv3
    map's two frames (NHWC, for timing the cost volume alone) and each conv
    with its input shape."""
    import torch.nn as nn

    total, feats, convs = [0], {}, []

    def conv_hook(m, inputs, out):
        taps = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
        pixels = (inputs[0].numel() // m.in_channels if m.transposed
                  else out.numel() // m.out_channels)
        total[0] += 2 * pixels * taps * m.out_channels
        convs.append((m, tuple(inputs[0].shape)))

    def corr_hook(m, inputs, out):
        feats["c"] = out.permute(0, 2, 3, 1)

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    hooks.append(model.flownetc.conv3.register_forward_hook(corr_hook))
    try:
        with torch.no_grad():
            model(im1, im2)
    finally:
        for h in hooks:
            h.remove()
    c = feats["c"]
    B = im1.shape[0]
    D = 2 * (model.flownetc.max_displacement // model.flownetc.corr_stride) + 1
    corr_ops = 2 * B * c.shape[1] * c.shape[2] * c.shape[3] * D * D
    return total[0] + corr_ops, corr_ops, c[:B], c[B:], convs


def conv_layout_ms(torch, convs, memory_format, reps=3):
    """Event time of every conv and deconv of one FlowNet2 call, run alone
    on random inputs of its shape, input and weight in ``memory_format``
    (channels_last or contiguous NCHW): the layout the network should keep."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEVICE).manual_seed(FLOW_SEED)
    calls = []
    for m, shape in convs:
        x = torch.randn(shape, generator=gen, device=DEVICE).contiguous(memory_format=memory_format)
        w = m.weight.detach().contiguous(memory_format=memory_format)
        if m.transposed:
            calls.append((F.conv_transpose2d, x, w, m.bias, m.stride, m.padding))
        else:
            calls.append((F.conv2d, x, w, m.bias, m.stride, m.padding))

    def run():
        for fn, *args in calls:
            fn(*args)

    with torch.no_grad():
        return cuda_ms(torch, run, reps)


def run_flownet(torch, net, batch, counters, card):
    """Phase 8b at one batch: FlowNet.__call__ on uint8 pairs at 256x192 with
    PyTorch's default TF32, every launch count at 0 (none may move): the
    median (min, max) of FLOW_CALLS calls after a warm-up, TFLOP/s against
    the analytic count, peak memory, one traced call (device busy, idle
    share, top kernels), the cost volume alone at its shapes (device time
    and share of the call's device time) and the call's convs alone in
    channels_last and in NCHW (event time: host-bound where the convs are
    small)."""
    from torch.profiler import ProfilerActivity, profile

    from shineon_tpu_torch.ops.correlation import cost_volume

    H, W = FRAME
    gen = torch.Generator().manual_seed(FLOW_SEED + batch)
    im1, im2 = (torch.randint(0, 256, (batch, H, W, 3), generator=gen, dtype=torch.uint8
                              ).to(DEVICE) for _ in range(2))
    with cudnn_defaults(torch, True):
        ops, corr_ops, c1, c2, convs = flownet_work(torch, net.model, im1.float(), im2.float())
        layouts = {name: conv_layout_ms(torch, convs, fmt) for name, fmt in (
            ("channels_last", torch.channels_last), ("NCHW", torch.contiguous_format))}
        for owner, attr in counters.values():
            setattr(owner, attr, 0)
        flow, conf = net(im1, im2)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        samples = []
        for _ in range(FLOW_CALLS):
            t0 = time.perf_counter()
            flow, conf = net(im1, im2)
            torch.cuda.synchronize()
            samples.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated()
        launches = {name: getattr(owner, attr) for name, (owner, attr) in counters.items()}
        for _ in range(2):  # the first session pays the profiler's start-up
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                net(im1, im2)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        cv_ms = device_ms(torch, lambda: cost_volume(c1, c2, 20, 2), 3)
    ms = statistics.median(samples)
    finite = bool(torch.isfinite(flow).all())
    shapes_ok = tuple(flow.shape) == (batch, H, W, 2) and tuple(conf.shape) == (batch, H, W, 1)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"flownet2 batch {batch} ({H}x{W}, f32, TF32 on): median {ms:.2f} ms "
        f"(min {min(samples):.2f}, max {max(samples):.2f}) of {[round(v, 2) for v in samples]}, "
        f"{ms / batch:.3f} ms a pair; {ops / 1e9:.2f} GFLOP a call ({ops / batch / 1e9:.2f} a "
        f"pair, cost volume {corr_ops / batch / 1e9:.3f}), {ops / ms / 1e9:.1f} TFLOP/s, "
        f"{ops / ms / 1e9 / (H100_TF32_FLOPS / 1e12):.3f} of the TF32 peak; peak memory "
        f"{peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} above the {held / 2**30:.3f} held); "
        f"flow finite={finite}, max|flow| {flow.abs().max().item():.4g}, confident share "
        f"{conf.mean().item():.4f}; hand-kernel launches {launches} [{card}]")
    log(f"  traced call: wall {wall:.2f} ms, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / wall:.3f} ({1 - busy / ms:.3f} of the untraced median), "
        f"{sum(e.count for e in kernels)} kernels; the cost volume alone {cv_ms:.3f} ms device "
        f"time, {cv_ms / busy:.3f} of the call's device time [{card}]")
    log(f"  its {len(convs)} convs and deconvs alone (event time, TF32): "
        + ", ".join(f"{name} {ms:.3f} ms" for name, ms in layouts.items()) + f" [{card}]")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:100]}")
    if not (finite and shapes_ok) or any(launches.values()):
        raise SystemExit(f"FlowNet at batch {batch} failed its checks")
    return dict(ms=ms, samples=samples, ops=ops, peak=peak, held=held, wall=wall, busy=busy,
                cv_ms=cv_ms, layouts=layouts)


def run_flow_chain(torch, net, counters, expected, card):
    """Phase 8c: six synthetic frames a sample (batch 4, 256x192: a seeded
    image drifting one pixel a frame, with noise); the five flows of
    consecutive frames from FlowNet go through write_flow into a temporary
    directory and read_flow must give back the same bits; they become the
    flow_raw of one production bf16 serving clip in the VVT dataset's order
    (frame t's flow is the .flo named after it: from frame t to t + 1),
    whose frames must be finite and of the clip's shape, with the chain
    kernel launched as phase 5 counts it."""
    import os
    import tempfile

    import numpy as np

    from shineon_tpu_torch.datasets.flow_utils import read_flow, write_flow
    from shineon_tpu_torch.serving import build_inference

    one_clip, _, _, raw, n_frames = build_inference(BATCH)
    H, W = FRAME
    rng = np.random.RandomState(FLOW_SEED)
    base = rng.randint(0, 256, (BATCH, H, W + n_frames, 3))
    video = np.stack([np.clip(base[:, :, t:t + W] + rng.randint(-6, 7, (BATCH, H, W, 3)), 0, 255)
                      for t in range(n_frames + 1)], axis=1).astype(np.uint8)
    frames = torch.from_numpy(video).to(DEVICE)
    for owner, attr in counters.values():
        setattr(owner, attr, 0)
    flows, exact = [], True
    with tempfile.TemporaryDirectory() as tmp, cudnn_defaults(torch, True):
        for t in range(n_frames):
            flow, _ = net(frames[:, t], frames[:, t + 1])
            flow = flow.cpu().numpy()
            read = []
            for b in range(BATCH):
                path = os.path.join(tmp, f"video{b}", f"frame_{t:03d}.flo")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write_flow(path, flow[b])
                read.append(read_flow(path))
                exact = exact and read[-1].tobytes() == flow[b].tobytes()
            flows.append(np.stack(read))
    flow_launches = {name: getattr(owner, attr) for name, (owner, attr) in counters.items()}
    raw = {**raw, "image_u8": frames[:, :n_frames].contiguous(),
           "flow_raw": torch.from_numpy(np.stack(flows, axis=1)).to(DEVICE)}
    out = one_clip(raw)
    torch.cuda.synchronize()
    launches = {name: getattr(owner, attr) for name, (owner, attr) in counters.items()}
    want = {name: n_frames * expected.get(name, 0) for name in counters}
    finite = bool(torch.isfinite(out.float()).all())
    shape = (BATCH, n_frames) + FRAME + (3,)
    log(f"flow chain: {n_frames} flows of batch {BATCH} written and read back, bits equal "
        f"{exact}; max|flow| {max(np.abs(f).max() for f in flows):.4g}; the clip on them: "
        f"frames {tuple(out.shape)} {out.dtype} finite={finite}; launches while flowing "
        f"{flow_launches}, in the clip {launches} (expected {want}) [{card}]")
    if (not exact or not finite or tuple(out.shape) != shape or any(flow_launches.values())
            or launches != want):
        raise SystemExit("the flow annotation chain failed its checks")
    return {"exact": exact, "launches": launches}


# phase 9: the training runtime and the host data, read from disk. Trees
# at 256x192 from tools/synthetic_data.py: VVT, two videos of
# RUNTIME_FRAMES frames (the train split the first, 6 SAMS batches of 4;
# the val split the second), a VVT test tree of one video of
# RUNTIME_TEST_FRAMES frames, and VITON, RUNTIME_VITON samples
RUNTIME_FRAMES = 24
RUNTIME_TEST_FRAMES = 6
RUNTIME_VITON = 64
# 9a's cadence: 4 train batches, validation (one batch) and a step save
# every 2 steps, scalars and images every 2 steps, one epoch, 4 threads
SAMS_RUNTIME = dict(limit_train_batches="4", val_check_interval="2", display_count=2,
                    save_count=2, keep_epochs=1, decay_epochs=0, workers=4, limit_val_batches="1")
# the runs that time steps: no validation, images at step 0 only, no step save
QUIET = dict(display_count=10**6, val_check_interval="1000000", save_count=10**6)


def launch_counts(counters):
    return {n: getattr(owner, attr) for n, (owner, attr) in counters.items()}


def zero_counts(counters):
    for owner, attr in counters.values():
        setattr(owner, attr, 0)


def record_steps(torch, model, sync):
    """Wrap the model's train step (its class's, so wrappers never nest):
    every step's metrics, left on the device, and with ``sync`` the host
    clock after a synchronize at the end of each step."""
    rec = {"metrics": [], "marks": []}
    make = type(model).make_train_step.__get__(model)

    def make_train_step():
        step = make()

        def recorded(state, batch):
            metrics = step(state, batch)
            if sync:
                torch.cuda.synchronize()
                rec["marks"].append(time.perf_counter())
            rec["metrics"].append(metrics)
            return metrics

        return recorded

    model.make_train_step = make_train_step
    return rec


def interval_ms(marks):
    """(median, min, max) ms between consecutive step ends: each step after
    the first with what the trainer did before it (loader wait, copies)."""
    d = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return statistics.median(d), min(d), max(d)


def state_tensors(state):
    """Every tensor of a train state by name, and its counts."""
    out = {"step": state.step}
    for name, net in state.nets.items():
        out.update({f"{name}.{k}": v for k, v in net.module.state_dict().items()})
        out.update({f"{name}.mu.{i}": t for i, t in enumerate(net.optimizer.mu)})
        out.update({f"{name}.nu.{i}": t for i, t in enumerate(net.optimizer.nu)})
        out[f"{name}.count"] = net.optimizer.count
    return out


def payload_tensors(payload):
    """state_tensors' names over a checkpoint's raw dict."""
    out = {"step": payload["step"]}
    for name, net in payload["nets"].items():
        out.update({f"{name}.{k}": v for k, v in net["module"].items()})
        for key in ("mu", "nu"):
            out.update({f"{name}.{key}.{i}": t for i, t in enumerate(net["optimizer"][key])})
        out[f"{name}.count"] = net["optimizer"]["count"]
    return out


def differing(torch, a, b):
    """The names whose values differ between two state_tensors maps, bit for
    bit (a tensor's bytes, on the first one's device)."""
    if sorted(a) != sorted(b):
        return ["the names differ"]
    bad = []
    for k, v in a.items():
        w = b[k]
        if isinstance(v, torch.Tensor):
            same = v.dtype == w.dtype and v.shape == w.shape and torch.equal(v, w.to(v.device))
        else:
            same = v == w
        if not same:
            bad.append(k)
    return bad


def finite_losses(records, key):
    values = [float(m[key]) for m in records]
    return values, bool(values) and all(v == v and abs(v) != float("inf") for v in values)


def run_runtime(torch, counters, clip_sites, card):
    """Phase 9 (module docstring); ``clip_sites`` is the fused chain's
    launches in one eval-mode production clip. Returns the readings."""
    import glob
    import os
    import shutil
    import tempfile

    from shineon_tpu_torch.bench import time_train_steps
    from shineon_tpu_torch.datasets import find_dataset_using_name
    from shineon_tpu_torch.datasets.loader import DataLoader
    from shineon_tpu_torch.datasets.tryon_dataset import GRID_VIS_PATH
    from shineon_tpu_torch.models.sams_model import SamsModel
    from shineon_tpu_torch.models.unet_mask_model import UnetMaskModel
    from shineon_tpu_torch.models.warp_model import WarpModel
    from shineon_tpu_torch.options import gmm_options, sams_options, tom_options
    from shineon_tpu_torch.serving import synthetic_raw_batch
    from shineon_tpu_torch.tools import synthetic_data
    from shineon_tpu_torch.tools.two_stage_chain import run_chain
    from shineon_tpu_torch.training.checkpointing import load_checkpoint, save_checkpoint
    from shineon_tpu_torch.training.loop import Trainer

    tmp = tempfile.mkdtemp(prefix="shineon_runtime_")
    out = {}
    try:
        t0 = time.perf_counter()
        vvt, viton, exp = (os.path.join(tmp, d) for d in ("vvt", "viton", "exp"))
        synthetic_data.make_vvt_tree(vvt, n_videos=2, frames=RUNTIME_FRAMES, seed=1)
        synthetic_data.make_vvt_tree(vvt, n_videos=1, frames=RUNTIME_TEST_FRAMES,
                                     datamode="test", seed=2)
        synthetic_data.make_viton_tree(viton, n=RUNTIME_VITON, seed=3)
        log(f"phase 9 trees written: {time.perf_counter() - t0:.1f} s")

        # 9a: SAMS through the trainer
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        opt = sams_options(vvt_dataroot=vvt, experiments_dir=exp, name="sams", remat=True,
                           **SAMS_RUNTIME)
        t0 = time.perf_counter()
        model = SamsModel(opt, DEVICE)
        rec = record_steps(torch, model, sync=False)
        zero_counts(counters)
        state = Trainer(opt).fit(model)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = launch_counts(counters)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        losses, finite = finite_losses(rec["metrics"], "loss")
        ckpt = os.path.join(exp, "sams", "checkpoints")
        listing = {d: sorted(os.listdir(os.path.join(ckpt, d))) for d in ("topk", "steps", "named")}
        events = glob.glob(os.path.join(exp, "sams", "tb", "events.*"))
        # eval-mode generator calls: the train images at steps 0 and 2; at
        # steps 2 and 4 a validation batch and its images
        calls = 2 + 2 * 2
        want = {n: 0 for n in counters}
        want["fused_multispade"] = calls * clip_sites
        final = os.path.join(ckpt, "named", "FINAL_step=4")
        size_gib = os.path.getsize(os.path.join(final, "state.pt")) / 2**30
        ok = (finite and len(losses) == 4 and state.step == 4 and launches == want
              and os.path.exists(os.path.join(ckpt, "hparams.json"))
              and len(listing["topk"]) == 2 and listing["steps"] == ["2", "4"]
              and listing["named"] == ["FINAL_step=4"] and events
              and all(os.path.getsize(e) > 0 for e in events))
        log(f"9a SAMS trainer (production options, 256x192, batch 4, remat, 4 decode threads): "
            f"fit {fit_s:.1f} s, losses {[round(v, 4) for v in losses]}, checkpoints {listing}, "
            f"hparams.json, board events {[os.path.getsize(e) for e in events]} bytes, launches "
            f"{launches} (expected {want}: {calls} eval-mode clips of {clip_sites}); peak memory "
            f"{peak:.2f} GiB above the {base / 2**30:.2f} GiB held before the build "
            f"[{card}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("9a: the SAMS trainer failed its checks")
        out["fit"] = dict(launches=launches["fused_multispade"], calls=calls, fit_s=fit_s,
                          peak_gib=peak)
        shutil.rmtree(os.path.join(ckpt, "topk"))
        shutil.rmtree(os.path.join(ckpt, "steps"))
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(tmp, "timed_save"), state)
        save_s = time.perf_counter() - t0
        shutil.rmtree(os.path.join(tmp, "timed_save"))

        # 9b: FINAL into a fresh model on the card, bit for bit; one more step
        opt_r = sams_options(vvt_dataroot=vvt, experiments_dir=exp, name="sams_resumed",
                             remat=True, limit_train_batches="0.1", keep_epochs=1,
                             decay_epochs=0, workers=4, **QUIET)
        fresh = SamsModel(opt_r, DEVICE)
        template = fresh.make_state(4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_checkpoint(final, template, map_location=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        bad = differing(torch, state_tensors(state), state_tensors(template))
        n_tensors = len(state_tensors(state))
        del model, state, rec
        gc.collect()
        torch.cuda.empty_cache()
        rec = record_steps(torch, fresh, sync=False)
        trainer = Trainer(opt_r)
        template = trainer.fit(fresh, template)
        losses, finite = finite_losses(rec["metrics"], "loss")
        ok = not bad and finite and len(losses) == 1 and template.step == 5
        log(f"9b resume: FINAL_step=4 ({size_gib:.3f} GiB) loaded with weights_only=True into a "
            f"fresh model on the card in {load_s:.2f} s; {n_tensors} tensors and counts, "
            f"differing bit for bit: {bad or 'none'}; saved in {save_s:.2f} s; one more fit step "
            f"from step 4: loss {losses}, step {template.step} [{card}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("9b: the resume failed its checks")
        out["checkpoint"] = dict(gib=size_gib, save_s=save_s, load_s=load_s)

        # 9f (SAMS): the trainer's step against the bare step, same model
        opt_t = sams_options(vvt_dataroot=vvt, experiments_dir=exp, name="sams_timed",
                             remat=True, limit_train_batches="0.84", keep_epochs=1,
                             decay_epochs=0, workers=4, **QUIET)
        fresh.override_hparams(opt_t)
        rec = record_steps(torch, fresh, sync=True)
        template = Trainer(opt_t).fit(fresh, template)
        trainer_ms = interval_ms(rec["marks"])
        bare = time_train_steps(type(fresh).make_train_step(fresh), template,
                                synthetic_raw_batch(opt_t, opt_t.batch_size, device=DEVICE),
                                repeats=2, steps=3)
        out["sams"] = dict(trainer_ms=trainer_ms, bare_ms=bare[0] * 1e3, workers=4)
        log(f"9f SAMS step (batch 4, remat): trainer {trainer_ms[0]:.1f} ms (min "
            f"{trainer_ms[1]:.1f}, max {trainer_ms[2]:.1f}; {len(rec['marks']) - 1} steps after "
            f"the first, synchronized, 4 decode threads) against the bare step "
            f"(bench.time_train_steps, median of 2 windows of 3) {bare[0] * 1e3:.1f} ms (min "
            f"{bare[1] * 1e3:.1f}, max {bare[2] * 1e3:.1f}): "
            f"{trainer_ms[0] / (bare[0] * 1e3):.3f}x [{card}]")

        # 9d: SAMS's test export of the test tree, then again
        opt_x = sams_options(vvt_dataroot=vvt, is_train=False, name="sams", workers=4,
                             experiments_dir=exp, result_dir=os.path.join(tmp, "results"))
        fresh.override_hparams(opt_x)
        runs = []
        for _ in range(2):
            zero_counts(counters)
            Trainer(opt_x).test(fresh, template)
            torch.cuda.synchronize()
            files = sorted(glob.glob(os.path.join(tmp, "results", "**", "*.png"), recursive=True))
            runs.append((launch_counts(counters), {f: os.stat(f).st_mtime_ns for f in files}))
        batches = -(-RUNTIME_TEST_FRAMES // opt_x.batch_size)
        want = [{**{n: 0 for n in counters}, "fused_multispade": batches * clip_sites},
                {n: 0 for n in counters}]
        ok = (len(runs[0][1]) == RUNTIME_TEST_FRAMES and runs[1][1] == runs[0][1]
              and [r[0] for r in runs] == want)
        log(f"9d test export: {len(runs[0][1])} PNGs for {RUNTIME_TEST_FRAMES} clips "
            f"({batches} batches, the last ragged), launches {runs[0][0]}; run again: files "
            f"unchanged {runs[1][1] == runs[0][1]}, launches {runs[1][0]} (expected {want}) "
            f"[{card}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("9d: the test export failed its checks")
        del fresh, template, rec
        gc.collect()
        torch.cuda.empty_cache()

        # 9c: the loader raises at step 2; the GMM at gmm_options on VITON
        class LoaderFault(OSError):
            """The fault 9c plants in the loader."""

        class FaultyLoader(DataLoader):
            def __iter__(self):
                for i, batch in enumerate(super().__iter__()):
                    if i == 2:
                        raise LoaderFault("planted at step 2")
                    yield batch

        opt_g = gmm_options(viton_dataroot=viton, experiments_dir=exp, name="gmm_interrupt",
                            workers=4, keep_epochs=1, decay_epochs=0, **QUIET)
        gmm = WarpModel(opt_g, DEVICE)
        snaps = []
        make = type(gmm).make_train_step.__get__(gmm)

        def snapshot_steps():
            step = make()

            def recorded(state, batch):
                metrics = step(state, batch)
                snaps.append({k: v.clone() if isinstance(v, torch.Tensor) else v
                              for k, v in state_tensors(state).items()})
                return metrics

            return recorded

        gmm.make_train_step = snapshot_steps
        loader = type(gmm).train_dataloader.__get__(gmm)

        def faulty():
            built = loader()
            built.__class__ = FaultyLoader
            return built

        gmm.train_dataloader = faulty
        raised = None
        try:
            Trainer(opt_g).fit(gmm)
        except LoaderFault as exc:
            raised = exc
        saved = os.path.join(exp, "gmm_interrupt", "checkpoints", "named",
                             "interrupted_by_LoaderFault")
        bad = (differing(torch, snaps[-1], payload_tensors(load_checkpoint(saved)))
               if os.path.isdir(saved) else ["no checkpoint"])
        ok = raised is not None and len(snaps) == 2 and not bad
        log(f"9c interrupt: the loader raised {raised!r} at step 2 and it propagated; "
            f"{len(snaps)} steps done; interrupted_by_LoaderFault against the state after step 1, "
            f"differing bit for bit: {bad or 'none'} [{card}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("9c: the interrupt save failed its checks")
        del gmm, snaps

        # 9e: the two-stage chain, GMM -> TOM at their documented options
        zero_counts(counters)
        t0 = time.perf_counter()
        chain = run_chain(FRAME[0], FRAME[1], frames_per_video=8, batch_size=TOM_BATCH,
                          workdir=os.path.join(tmp, "chain"), device=DEVICE)
        torch.cuda.synchronize()
        launches = launch_counts(counters)
        # TOM's train steps, its images at step 0 and its test batches
        calls = chain["tom_train_steps"] + 1 + chain["tom_test_batches"]
        want = {**{n: 0 for n in counters}, "sagan_attention": STAGE_ATTENTION["unet_mask"] * calls}
        ok = (chain["stage1_warp_cloth_files"] == chain["stage1_samples"] > 0
              and chain["stage1_resume_skipped_all"] and launches == want
              and chain["frames_scored"] == chain["stage1_samples"]
              and 0 <= chain["ssim_tryon"] <= 1 and chain["psnr_tryon"] == chain["psnr_tryon"])
        log(f"9e two-stage chain (VVT, 256x192, batch 8): {time.perf_counter() - t0:.1f} s; "
            f"stage 1 {chain['stage1_warp_cloth_files']} warp cloths for "
            f"{chain['stage1_samples']} samples, the second export skipped all {chain['stage1_resume_skipped_all']}; stage 2 "
            f"{chain['tom_train_steps']} TOM steps, {chain['frames_scored']} frames scored: SSIM "
            f"{chain['ssim_tryon']:.4f}, PSNR {chain['psnr_tryon']:.2f} dB (random weights: not "
            f"quality numbers); launches {launches} (expected {want}: {calls} TOM forwards) "
            f"[{card}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("9e: the two-stage chain failed its checks")
        out["chain"] = dict(launches=launches["sagan_attention"], calls=calls,
                            ssim=chain["ssim_tryon"], psnr=chain["psnr_tryon"])

        # 9f: GMM (VITON) and TOM (VVT, one frame, both videos) trainer
        # steps at 0 and 4 decode threads against the bare step
        for kind, cls, builder, data in (
                ("warp", WarpModel, gmm_options, dict(viton_dataroot=viton)),
                ("unet_mask", UnetMaskModel, tom_options,
                 dict(dataset="vvt", vvt_dataroot=vvt, val_fraction=0))):
            net, st, readings = None, None, {}
            for workers in (0, 4):
                o = builder(experiments_dir=exp, name=f"{kind}_w{workers}", workers=workers,
                            keep_epochs=1, decay_epochs=0, **data, **QUIET)
                if net is None:
                    net = cls(o, DEVICE)
                else:
                    net.override_hparams(o)
                rec = record_steps(torch, net, sync=True)
                st = Trainer(o).fit(net, st)
                readings[workers] = interval_ms(rec["marks"])
            bare = time_train_steps(type(net).make_train_step(net), st,
                                    synthetic_raw_batch(o, TOM_BATCH, device=DEVICE),
                                    loss_key="loss/G")
            out[kind] = dict(trainer_ms={w: r[0] for w, r in readings.items()},
                             bare_ms=bare[0] * 1e3, steps=len(rec["marks"]) - 1)
            log(f"9f {kind} step (batch 8, 256x192, bf16): trainer " + ", ".join(
                f"{w} threads {r[0]:.2f} ms (min {r[1]:.2f}, max {r[2]:.2f}), "
                f"{r[0] / (bare[0] * 1e3):.3f}x" for w, r in readings.items())
                + f" ({len(rec['marks']) - 1} steps after the first, synchronized) against the "
                f"bare step (bench.time_train_steps) {bare[0] * 1e3:.2f} ms [{card}]")
            del net, st

        # 9f: the loader alone
        rates = {}
        sets = (("VVT 5-frame clips", find_dataset_using_name("vvt")(opt), 4),
                ("VITON", find_dataset_using_name("viton")(gmm_options(viton_dataroot=viton)), 8))
        for name, dataset, batch in sets:
            for workers in (0, 4):
                t0 = time.perf_counter()
                n = sum(len(b["image_name"]) for b in DataLoader(dataset, batch, workers=workers))
                rates[(name, workers)] = n / (time.perf_counter() - t0)
        log("9f loader alone, samples/s: " + ", ".join(
            f"{name} at {w} threads {r:.1f}" for (name, w), r in rates.items()) + f" [{card}]")
        out["loader"] = {f"{name}, {w} threads": r for (name, w), r in rates.items()}
        # what a sample's decode spends, one thread: ms a file of each kind
        clips, images = sets[0][1], sets[1][1]
        kinds = {
            "person JPEG (VITON)": lambda i: images.open_image_u8(images.get_person_image_path(i)),
            "label PNG (VITON)": lambda i: images.open_label_u8(images.get_person_parsed_path(i)),
            "keypoint JSON (VITON)": images.get_cocopose_keypoints,
            "grid PNG (the GMM's, every sample)": lambda i: images.open_image_u8(GRID_VIS_PATH),
            "frame PNG (VVT)": lambda i: clips.open_image_u8(clips.get_person_image_path(i)),
            "densepose PNG (VVT)": lambda i: clips.open_image_u8(
                clips.get_person_densepose_path(i)),
            "flow .flo (VVT)": clips.get_flow_raw,
        }
        per_file = {}
        for name, fn in kinds.items():
            t0 = time.perf_counter()
            for i in range(RUNTIME_FRAMES):
                fn(i)
            per_file[name] = (time.perf_counter() - t0) * 1e3 / RUNTIME_FRAMES
        log("9f decode, ms a file (one thread, 24 files each): " + ", ".join(
            f"{name} {ms:.3f}" for name, ms in per_file.items()) + f" [{card}]")
        out["decode_ms"] = per_file
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 10b: the command line at full width. The SAMS run: the production
# options of sams_options() as flags (5-frame VVT clips, flow warp, batch
# 4, bf16, the random-filter VGG), with swish, orthogonal discriminator
# kernels and two mini-steps an update; 4 train batches, validation (one
# batch) every 2 steps, one epoch, 4 decode threads
CLI_SAMS_FLAGS = ["--model", "sams", "--dataset", "vvt", "--flow_warp", "--n_frames_total", "5",
                  "--batch_size", "4", "--allow_random_vgg", "--activation", "swish",
                  "--workers", "4"]
CLI_EPOCH_FLAGS = ["--keep_epochs", "1", "--decay_epochs", "0", "--init_type", "orthogonal",
                   "--limit_train_batches", "4"]
CLI_FIT_FLAGS = CLI_EPOCH_FLAGS + ["--accumulated_batches", "2", "--val_check_interval", "2",
                                   "--limit_val_batches", "1"]
# the same keys as builder overrides, for the namespace check
CLI_SAMS_KEYS = dict(n_frames_total=5, flow_warp=True, batch_size=4, allow_random_vgg=True,
                     activation="swish", keep_epochs=1, decay_epochs=0, workers=4,
                     init_type="orthogonal", accumulated_batches=2, limit_train_batches="4",
                     val_check_interval="2", limit_val_batches="1")
CLI_ATTENTION_PER_FORWARD = 6  # TOM's --num_attn 3: 3 levels, each end


def step_watch(torch, model_cls):
    """Wrap ``model_cls.make_train_step`` (the class's, so that the model
    the command line builds runs it): for each step, which networks'
    parameters moved and the host time to a synchronize at its end. Returns
    (records, restore)."""
    orig = model_cls.make_train_step
    rec = {"moved": [], "ms": []}

    def make_train_step(self):
        step = orig(self)

        def watched(state, batch):
            before = {n: [p.detach().clone() for p in net.module.parameters()]
                      for n, net in state.nets.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["moved"].append({n: any(not torch.equal(a, b) for a, b in zip(
                before[n], net.module.parameters())) for n, net in state.nets.items()})
            del before
            return metrics

        return watched

    model_cls.make_train_step = make_train_step
    return rec, lambda: setattr(model_cls, "make_train_step", orig)


def run_cli(torch, counters, clip_sites, card):
    """Phase 10b: ``shineon_tpu_torch.train.main`` and ``.test``'s entry, in
    process, on synthetic trees at 256x192 (tools/synthetic_data.py), every
    launch count at 0 before each entry and read after it. Returns the
    readings."""
    import glob
    import os
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from shineon_tpu_torch import train as cli
    from shineon_tpu_torch.models.sams_model import SamsModel
    from shineon_tpu_torch.options import TrainOptions, sams_options
    from shineon_tpu_torch.tools import synthetic_data

    tmp = tempfile.mkdtemp(prefix="shineon_cli_")
    out = {}
    try:
        vvt, viton, exp, res = (os.path.join(tmp, d) for d in ("vvt", "viton", "exp", "res"))
        synthetic_data.make_vvt_tree(vvt, n_videos=2, frames=RUNTIME_FRAMES, seed=5)
        synthetic_data.make_vvt_tree(vvt, n_videos=1, frames=RUNTIME_TEST_FRAMES,
                                     datamode="test", seed=6)
        synthetic_data.make_viton_tree(viton, n=16, seed=7)
        where = ["--vvt_dataroot", vvt, "--experiments_dir", exp]

        # the namespace the command line gives against the builder's
        argv = CLI_SAMS_FLAGS + CLI_FIT_FLAGS + where + ["--name", "cli_sams"]
        parsed = vars(TrainOptions().parse(argv))
        built = vars(sams_options(vvt_dataroot=vvt, experiments_dir=exp, name="cli_sams",
                                  **CLI_SAMS_KEYS))
        norm = lambda v: list(v) if isinstance(v, tuple) else v  # noqa: E731
        shared = sorted(set(parsed) & set(built))
        differ = {k: (parsed[k], built[k]) for k in shared if norm(parsed[k]) != norm(built[k])}
        log(f"10b the command line's namespace against sams_options(): {len(shared)} shared "
            f"keys, differing: {differ or 'none'} {'ok' if not differ else 'FAIL'}")
        if differ:
            raise SystemExit("10b: the parsed namespace differs from sams_options()")

        # train: accumulation 2; parameters move on even mini-steps only
        gc.collect()
        torch.cuda.empty_cache()
        rec, restore = step_watch(torch, SamsModel)
        zero_counts(counters)
        t0 = time.perf_counter()
        try:
            state = cli.main(True, argv)
        finally:
            restore()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = launch_counts(counters)
        # eval-mode clips: the train images at step 0; at steps 2 and 4 a
        # validation batch and its images
        calls = 1 + 2 * 2
        want = {n: 0 for n in counters}
        want["fused_multispade"] = calls * clip_sites
        moved = [sorted(n for n, m in r.items() if m) for r in rec["moved"]]
        nets = sorted(state.nets)
        want_moved = [[], nets, [], nets]
        final = os.path.join(exp, "cli_sams", "checkpoints", "named", "FINAL_step=4")
        ok = (launches == want and moved == want_moved and state.step == 4
              and os.path.isdir(final)
              and all(net.optimizer.inner.count == 2 for net in state.nets.values()))
        acc2_ms = statistics.median(rec["ms"][1:])
        flags = " ".join(CLI_SAMS_FLAGS + CLI_FIT_FLAGS)
        log(f"10b train: python -m shineon_tpu_torch.train {flags}: {fit_s:.1f} s wall; "
            f"networks moved a step {moved} (expected {want_moved}); launches {launches} "
            f"(expected {want}: {calls} eval-mode swish clips of {clip_sites}); step "
            f"{[round(v, 1) for v in rec['ms']]} ms [{card}] "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("10b: the training entry failed its checks")
        del state
        out["train"] = dict(wall_s=fit_s, launches=launches["fused_multispade"], calls=calls,
                            step_ms=rec["ms"])

        # the same fit at accumulation 1, no validation: the trainer's step
        gc.collect()
        torch.cuda.empty_cache()
        rec1, restore = step_watch(torch, SamsModel)
        t0 = time.perf_counter()
        try:
            cli.main(True, CLI_SAMS_FLAGS + CLI_EPOCH_FLAGS + where + [
                "--name", "cli_sams_acc1", "--val_check_interval", "1000000",
                "--display_count", "1000000", "--save_count", "1000000"])
        finally:
            restore()
        acc1_s = time.perf_counter() - t0
        acc1_ms = statistics.median(rec1["ms"][1:])
        log(f"10b trainer step, median of steps 2-4 (synchronized): accumulation 2 "
            f"{acc2_ms:.1f} ms (mini-steps {[round(v, 1) for v in rec['ms']]}), accumulation 1 "
            f"{acc1_ms:.1f} ms ({[round(v, 1) for v in rec1['ms']]}), ratio "
            f"{acc2_ms / acc1_ms:.3f}; the accumulation-1 entry {acc1_s:.1f} s wall [{card}]")
        out["step_ms"] = {"accumulation_2": acc2_ms, "accumulation_1": acc1_ms}

        # test from the checkpoint, int8 serving with swish
        gc.collect()
        torch.cuda.empty_cache()
        test_argv = CLI_SAMS_FLAGS + where + ["--name", "cli_sams", "--checkpoint", final,
                                              "--int8_spade", "--result_dir", res]
        zero_counts(counters)
        t0 = time.perf_counter()
        tested = cli.main(False, test_argv)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        launches = launch_counts(counters)
        batches = -(-RUNTIME_TEST_FRAMES // 4)
        n_convs = sum(shape[4] for shape in CONVS) * 5
        want = {n: 0 for n in counters}
        want.update({"fused_multispade_int8": batches * clip_sites,
                     "multispade_hidden_absmax": batches * clip_sites,
                     "int8_conv3x3": batches * n_convs, "int8_quantize": batches * n_convs})
        pngs = glob.glob(os.path.join(res, "cli_sams", "FINAL_step=4", "test", "**", "*.png"),
                         recursive=True)
        ok = (launches == want and len(pngs) == RUNTIME_TEST_FRAMES
              and sorted(tested.nets) == ["generator"])
        log(f"10b test: python -m shineon_tpu_torch.test --checkpoint FINAL_step=4 --int8_spade "
            f"(swish): {test_s:.1f} s wall, {len(pngs)} PNGs (expected {RUNTIME_TEST_FRAMES}); "
            f"launches {launches} (expected {want}: {batches} batches) [{card}] "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("10b: the test entry failed its checks")
        out["test"] = dict(wall_s=test_s, launches=launches["fused_multispade_int8"],
                           prepass_launches=launches["multispade_hidden_absmax"])
        del tested

        # test without a checkpoint: the refusal
        zero_counts(counters)
        try:
            cli.main(False, CLI_SAMS_FLAGS + where + ["--name", "cli_refused"])
            refused = None
        except SystemExit as exc:
            refused = str(exc)
        ok = (refused is not None and "needs --checkpoint" in refused
              and not any(launch_counts(counters).values())
              and not os.path.exists(os.path.join(exp, "cli_refused")))
        log(f"10b test without --checkpoint: refused ({refused!r}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("10b: the test entry ran without a checkpoint")

        # the documented GMM and TOM commands (docs/3_train.md), one batch
        # each; VITON has no densepose (TOM's person input raises there in
        # both packages), so TOM runs over the VVT tree at one frame
        stages = (
            ("gmm", ["--name", "gmm_train", "--model", "gmm", "--dataset", "viton",
                     "--viton_dataroot", viton, "--batch_size", "8", "--workers", "4"], 0),
            ("tom", ["--name", "tom_train", "--model", "tom", "--dataset", "vvt",
                     "--vvt_dataroot", vvt, "--self_attn", "--num_attn", "3",
                     "--activation", "swish", "--allow_random_vgg"],
             CLI_ATTENTION_PER_FORWARD * 4),  # train step, its images, val step, its images
        )
        for name, args, attention in stages:
            gc.collect()
            torch.cuda.empty_cache()
            zero_counts(counters)
            t0 = time.perf_counter()
            state = cli.main(True, args + ["--experiments_dir", exp, "--fast_dev_run"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts(counters)
            want = {n: 0 for n in counters}
            want["sagan_attention"] = attention
            ok = launches == want and state.step == 1
            log(f"10b {name}: python -m shineon_tpu_torch.train {' '.join(args[2:6])} ... "
                f"--fast_dev_run: {wall:.1f} s wall, step {state.step}, launches {launches} "
                f"(expected {want}) [{card}] {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"10b: the documented {name} command failed its checks")
            out[name] = dict(wall_s=wall, launches=launches["sagan_attention"])
            del state
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 11: the QA loop at full width (tools/e2e_quality.run_e2e at the
# production options: 256x192, 5-frame clips, flow warp, remat, bf16, the
# exact GAN step, lr 2e-4 as the JAX package's production quality curve),
# on a synthetic VVT tree of 2 videos x QA_FRAMES frames: vid0 trains and is
# exported (QA_FRAMES / 4 batches), vid1 is the validation split
QA_FRAMES = 12
QA_ENVELOPE = (0.02, 1.0)  # |dSSIM|, |dPSNR| of int8 against fp: tests/test_e2e_quality.py:61-62
# 11b: the reference layout's widths at full width and at phase 4's small ones
LIGHTNING_SMALL = dict(fine_height=128, fine_width=96, n_frames_total=3, n_frames_now=3,
                       ngf_pow_outer=6, ngf_pow_inner=8, num_middle=1, precision=32)


def constant_share(folder):
    """The share of an export's frames that hold one value (an untrained
    clip that blew up and was clamped): PSNR reads -inf there."""
    import os

    import numpy as np
    from PIL import Image

    frames = [os.path.join(d, f) for d, _, files in os.walk(folder) for f in files]
    flat = [np.asarray(Image.open(f)) for f in frames]
    return sum(int(a.max() == a.min()) for a in flat) / max(len(flat), 1), len(flat)


def run_qa(torch, counters, n_frames, card):
    """Phase 11a: run_e2e at the production options with an int8 export of
    the trained state; every launch count at 0 before each stage and read
    after it. Returns the readings."""
    import contextlib
    import shutil
    import tempfile

    from shineon_tpu_torch.models.sams_model import SamsModel
    from shineon_tpu_torch.tools.e2e_quality import run_e2e

    batches = QA_FRAMES // BATCH
    clip_sites = sum(site[4] for site in SITES) * n_frames
    n_convs = sum(shape[4] for shape in CONVS) * n_frames
    fp = {n: 0 for n in counters}
    fp["fused_multispade"] = batches * clip_sites
    int8 = {n: 0 for n in counters}
    int8.update({"fused_multispade_int8": batches * clip_sites,
                 "multispade_hidden_absmax": batches * clip_sites,
                 "int8_conv3x3": batches * n_convs, "int8_quantize": batches * n_convs})
    # the fit's one eval-mode clip: the board's images at step 0
    fit = {**{n: 0 for n in counters}, "fused_multispade": clip_sites}
    want = {"export_init": fp, "fit": fit, "export_trained": fp, "export_int8": int8}
    launches = {}

    @contextlib.contextmanager
    def observe(stage):
        zero_counts(counters)
        yield
        launches[stage] = launch_counts(counters)

    gc.collect()
    torch.cuda.empty_cache()
    rec, restore = step_watch(torch, SamsModel)
    tmp = tempfile.mkdtemp(prefix="shineon_qa_")
    t0 = time.perf_counter()
    try:
        r = run_e2e(model_name="sams", fine_height=FRAME[0], fine_width=FRAME[1],
                    n_frames=n_frames, frames_per_video=QA_FRAMES, batch_size=BATCH,
                    epochs=1, lr=2e-4, precision=16, workdir=tmp, device=DEVICE,
                    arch_overrides={"remat": True, "decay_epochs": 0},
                    extra_exports={"int8": {"int8_spade": True}}, observe=observe)
        wall = time.perf_counter() - t0
        constant = {name: constant_share(folder) for name, folder in r["exports"].items()}
    finally:
        restore()
        shutil.rmtree(tmp, ignore_errors=True)
    d_ssim = abs(r["ssim_int8"] - r["ssim_trained"])
    # two exports of one constant value each read -inf: they agree
    d_psnr = 0.0 if r["psnr_int8"] == r["psnr_trained"] else abs(r["psnr_int8"]
                                                                 - r["psnr_trained"])
    ok = (launches == want and r["frames_scored"] == QA_FRAMES and r["train_steps"] == batches
          and all(n == QA_FRAMES for _, n in constant.values())
          and d_ssim < QA_ENVELOPE[0] and d_psnr < QA_ENVELOPE[1])
    seconds = r["seconds"]
    log(f"11a QA loop (tools.e2e_quality.run_e2e, production options, {QA_FRAMES} test "
        f"frames, {batches} fit steps): {wall:.1f} s wall; stages "
        + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
        + f"; fit steps {[round(v, 1) for v in rec['ms']]} ms (synchronized) [{card}]")
    log(f"11a SSIM init {r['ssim_init']} trained {r['ssim_trained']} int8 {r['ssim_int8']}; "
        f"PSNR init {r['psnr_init']} trained {r['psnr_trained']} int8 {r['psnr_int8']}; "
        f"int8 against fp |dSSIM| {d_ssim:.4f} |dPSNR| {d_psnr:.2f} (limits {QA_ENVELOPE}); "
        f"constant frames " + ", ".join(f"{k} {c:.3f} of {n}" for k, (c, n) in constant.items())
        + f"; {r['frames_scored']} frames scored {'ok' if ok else 'FAIL'}")
    log(f"11a launches by stage {launches} (expected {want}) "
        f"{'ok' if launches == want else 'FAIL'}")
    if not ok:
        raise SystemExit("11a: the QA loop failed its checks")
    return dict(result=r, launches=launches, wall_s=wall, step_ms=rec["ms"],
                constant=constant)


def reference_generator_state_dict(torch, gen, seed):
    """The reference's SamsGenerator ``state_dict`` (its Lightning
    checkpoint's names, sams_generator.py:133-212 of the reference: encode
    conv and [resblock, Upsample] pairs, middle resblocks, [Upsample,
    resblock] pairs and the out conv; each SPADE's param_free_norm,
    mlp_shared.0, mlp_gamma, mlp_beta and MultiSpade's spade_layers.<label>;
    spectral convs as weight_orig, weight_u, weight_v) with the shapes of
    the port generator ``gen``, drawn from ``seed``: kernels N(0, 0.5 /
    fan_in), biases N(0, 0.01), running means N(0, 0.1), variances in [0.5,
    1.5), u and v unit vectors with v along W^T u."""
    g = torch.Generator().manual_seed(seed)
    blocks = {"encode_conv_in": "encode_layers.0",
              "decode_conv_out": f"decode_layers.{2 * len(gen.decoder)}"}
    blocks.update({n: f"encode_layers.{2 * i + 1}" for i, n in enumerate(gen.encoder)})
    blocks.update({n: f"middle_layers.{i}" for i, n in enumerate(gen.middle)})
    blocks.update({n: f"decode_layers.{2 * i + 1}" for i, n in enumerate(gen.decoder)})
    out = {}
    state = gen.state_dict()
    for key, value in state.items():
        block, rest = key.split(".", 1)
        parts = []
        for part in rest.split("."):
            if part.startswith("spade_") and part[6:] not in ("0", "1"):
                parts += ["spade_layers", part[6:]]
            elif part == "norm":
                parts.append("param_free_norm")
            elif part in ("mlp_shared", "mlp_final"):
                parts += [part, "0"]
            else:
                parts.append(part)
        name = f"generator.{blocks[block]}.{'.'.join(parts)}"
        leaf = parts[-1]
        shape = value.shape
        if leaf == "sigma":
            continue
        if leaf == "u":
            w = out[name[:-1] + "weight_orig"]
            u = torch.randn(shape[1], generator=g)
            u /= u.norm()
            v = w.reshape(w.shape[0], -1).t() @ u
            out[name[:-1] + "weight_u"], out[name[:-1] + "weight_v"] = u, v / v.norm()
        elif leaf == "weight" and value.dim() == 4:
            w = torch.randn(shape, generator=g) * (0.5 / shape[1:].numel() ** 0.5)
            spectral = key[:-len("weight")] + "u" in state
            out[name + ("_orig" if spectral else "")] = w
        elif leaf == "running_mean":
            out[name] = torch.randn(shape, generator=g) * 0.1
        elif leaf == "running_var":
            out[name] = torch.rand(shape, generator=g) + 0.5
        elif leaf == "gamma":
            out[name] = torch.full(shape, 0.5)
        else:
            out[name] = torch.randn(shape, generator=g) * 0.01
    return out


def run_lightning(torch, counters, clip_sites, card):
    """Phase 11b: a reference-layout SAMS generator checkpoint at full width
    (seeded) through tools.convert_lightning_checkpoint, then
    ``python -m shineon_tpu_torch.test --checkpoint`` in process on a
    synthetic VVT test video (one batch: the chain kernel 150 times); at
    phase 4's small widths the converted generator's f32 clip on the card
    against the CPU plain path. Returns the readings."""
    import glob
    import os
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from shineon_tpu_torch import train as cli
    from shineon_tpu_torch.models.sams_model import SamsModel
    from shineon_tpu_torch.networks.sams.sams_generator import SamsGenerator
    from shineon_tpu_torch.options import sams_options
    from shineon_tpu_torch.serving import build_inference, make_one_clip
    from shineon_tpu_torch.tools import convert_lightning_checkpoint as lightning
    from shineon_tpu_torch.tools import synthetic_data

    def generator_of(opt):
        return SamsGenerator(norm_G=opt.norm_G, ngf_pow_outer=opt.ngf_pow_outer,
                             ngf_pow_inner=opt.ngf_pow_inner, num_middle=opt.num_middle,
                             n_frames_total=opt.n_frames_total, flow_warp=opt.flow_warp,
                             encoder_input=opt.encoder_input,
                             inputs=tuple(list(opt.person_inputs) + list(opt.cloth_inputs)))

    tmp = tempfile.mkdtemp(prefix="shineon_lightning_")
    out = {}
    try:
        opt = sams_options(is_train=False)
        reference = reference_generator_state_dict(torch, generator_of(opt), 1100)
        ckpt = os.path.join(tmp, "sams.ckpt")
        torch.save({"state_dict": reference, "hyper_parameters": {
            "ngf_base": 2, "ngf_pow_outer": 6, "ngf_pow_inner": 10, "ngf_pow_step": 1}}, ckpt)
        target = os.path.join(tmp, "converted")
        t0 = time.perf_counter()
        lightning.main(["--model", "sams", "--ckpt", ckpt, "--out", target, "--flow_warp",
                        "--n_frames_total", "5"])
        convert_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(target, "state.pt"))
        vvt, res = os.path.join(tmp, "vvt"), os.path.join(tmp, "res")
        synthetic_data.make_vvt_tree(vvt, n_videos=1, frames=BATCH, datamode="test", seed=11)
        gc.collect()
        torch.cuda.empty_cache()
        zero_counts(counters)
        t0 = time.perf_counter()
        state = cli.main(False, [
            "--model", "sams", "--dataset", "vvt", "--flow_warp", "--n_frames_total", "5",
            "--batch_size", str(BATCH), "--vvt_dataroot", vvt, "--checkpoint", target,
            "--result_dir", res, "--name", "lightning"])
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        launches = launch_counts(counters)
        want = {**{n: 0 for n in counters}, "fused_multispade": clip_sites}
        pngs = glob.glob(os.path.join(res, "**", "*.png"), recursive=True)
        frames = [np.asarray(Image.open(p)) for p in pngs]
        moved = sum(int(f.max() != f.min()) for f in frames)
        ok = launches == want and len(pngs) == BATCH and sorted(state.nets) == ["generator"]
        log(f"11b Lightning checkpoint at full width: converted in {convert_s:.2f} s, state.pt "
            f"{size / 2 ** 30:.3f} GiB; python -m shineon_tpu_torch.test --checkpoint: "
            f"{test_s:.1f} s wall (load and export), {len(pngs)} PNGs ({moved} not constant), "
            f"launches {launches} (expected {want}) [{card}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("11b: the converted Lightning checkpoint failed the test entry")
        del state
        out.update(convert_s=convert_s, size_gib=size / 2 ** 30, test_s=test_s,
                   launches=launches["fused_multispade"])

        # small widths: the converted generator's clip, card against CPU
        small_opt = sams_options(is_train=False, **LIGHTNING_SMALL)
        reference = reference_generator_state_dict(torch, generator_of(small_opt), 1101)
        _, converted = lightning.to_state_dict("sams", reference, dict(
            ngf_base=2, ngf_pow_outer=6, ngf_pow_inner=8, ngf_pow_step=1))
        _, warp, sams, raw, _ = build_inference(2, device=DEVICE, seed=7, **LIGHTNING_SMALL)
        sams.generator.load_state_dict(converted, strict=True)
        zero_counts(counters)
        clip = make_one_clip(warp, sams)(raw).cpu()
        small_launches = launch_counts(counters)["fused_multispade"]
        cpu_sams = SamsModel(sams.opt, "cpu")
        cpu_sams.generator.load_state_dict(converted, strict=True)
        from shineon_tpu_torch.models.warp_model import WarpModel

        cpu_warp = WarpModel(warp.opt, "cpu")
        cpu_warp.gmm.load_state_dict(warp.gmm.state_dict())
        ref = make_one_clip(cpu_warp, cpu_sams)({k: v.cpu() for k, v in raw.items()})
        err = (clip - ref).abs().max().item() / ref.abs().max().item()
        ok = small_launches > 0 and bool(torch.isfinite(clip).all()) and err <= 1e-3
        log(f"11b converted small generator (2, 3, 128, 96) f32 clip: card vs CPU plain max rel "
            f"err {err:.3g} (limit 1e-3), {small_launches} chain launches "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("11b: the converted generator's clip disagrees with the CPU")
        out.update(small_err=err)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_ddp(torch, counters, card):
    """Phase 11c: the production SAMS exact step (bench.build_train, batch
    4, remat, bf16) through parallel/ddp.py in an NCCL group of one rank
    against the bare step from the same state: the same losses and state
    bit for bit where two bare steps agree bit for bit (deterministic
    algorithms on), else within twice their spread; every launch count 0
    in both. Then each step's time, 3 chained steps with and without the
    group. Returns the readings."""
    import socket

    from shineon_tpu_torch.bench import build_train
    from shineon_tpu_torch.parallel import ddp

    gc.collect()
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        model, state, step, raw, _ = build_train(BATCH)
        start = {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in state_tensors(state).items()}

        def restart():
            with torch.no_grad():
                for k, v in state_tensors(state).items():
                    if isinstance(v, torch.Tensor):
                        v.copy_(start[k])
            state.step = start["step"]
            for name, net in state.nets.items():
                net.optimizer.count = start[f"{name}.count"]

        def one():
            restart()
            zero_counts(counters)
            metrics = {k: float(v) for k, v in step(state, raw).items()}
            torch.cuda.synchronize()
            return metrics, {k: v.clone() if isinstance(v, torch.Tensor) else v
                             for k, v in state_tensors(state).items()}, launch_counts(counters)

        def spread(a, b):
            return max((x - b[k]).abs().max().item() / max(b[k].abs().max().item(), 1e-30)
                       for k, x in a.items() if isinstance(x, torch.Tensor)
                       and x.is_floating_point())

        bare1, bare2 = one(), one()
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        ddp.setup(torch.device(DEVICE), f"tcp://localhost:{port}", 0, 1)
        backend = torch.distributed.get_backend()
        wrapped = one()
        exact = bare1[0] == bare2[0] and not differing(torch, bare1[1], bare2[1])
        same = wrapped[0] == bare1[0] and not differing(torch, wrapped[1], bare1[1])
        base = spread(bare2[1], bare1[1])
        gap = spread(wrapped[1], bare1[1])
        zero = {n: 0 for n in counters}
        ok = (same if exact else gap <= 2 * base + 1e-6) and all(
            r[2] == zero for r in (bare1, bare2, wrapped)) and backend == (
            "nccl" if DEVICE == "cuda" else "gloo")

        def timed(n=3):
            restart()
            ms = []
            for _ in range(n):
                t0 = time.perf_counter()
                float(step(state, raw)["loss"])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            return ms

        ddp_ms = timed()
        ddp.teardown()
        bare_ms = timed()
        log(f"11c DDP in a {backend} group of one rank: the exact step against the bare step "
            f"{'bit for bit' if same else f'max rel diff {gap:.3g}'} (two bare steps "
            f"{'bit for bit' if exact else f'apart by {base:.3g}'}); launches "
            f"{wrapped[2]}; step with the group {[round(v, 1) for v in ddp_ms]} ms, bare "
            f"{[round(v, 1) for v in bare_ms]} ms, median ratio "
            f"{statistics.median(ddp_ms) / statistics.median(bare_ms):.3f} [{card}] "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("11c: the DDP step differs from the bare step")
        return dict(exact=exact, same=same, ddp_ms=ddp_ms, bare_ms=bare_ms)
    finally:
        ddp.teardown()
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = deterministic


# phase 12: the JAX system's measurement tools at full width, repeats cut:
# stage timing (batch 16 int8, the JAX bench's configuration, and batch 4
# bf16, this file's clip), the train-step ablation, the FLOP census, the
# conv roof census and the host input pipeline
TOOL_STAGE_CELLS = ((16, True), (BATCH, False))  # (serving batch, int8)
TOOL_ITERS = 2  # serving_stages' --iters: windows of 2 and 8 calls (gen_scan, one_clip: 5, 20)
TOOL_MIN_TFLOP = 0.01  # the roof census's --min_tflop (the JAX tool's default)
TOOL_LOADER_THREADS = (1, 4)


def run_tools(torch, counters, card):
    """Phase 12: each measurement tool's function at full width with its
    repeats cut, every launch count at 0 before each tool. (a)
    tools.serving_stages at TOOL_STAGE_CELLS: each stage's launches a call
    exact (gen_frame one frame's chain sites and, int8, its int8 convs;
    gen_scan and one_clip the clip's), the stage functions composed within
    the bf16 chain tolerance of one_clip on the same batch; (b) every
    tools.train_ablate config, one window of 1 step: finite losses,
    no_vgg's VGG term 0, num_D_1 one discriminator scale, no kernel
    launched; (c) tools.flop_census of the fp graph within 10% of the
    analytic count, and of the int8 graph; (d) tools.serving_roof_census at
    both graphs' shapes above TOOL_MIN_TFLOP, each beside a traced clip of
    its graph ((a)'s clips: fp at batch 4, int8 at 16); (e)
    tools.input_pipeline at TOOL_LOADER_THREADS beside (a)'s int8 clip
    rate. Returns the readings and (a)'s clips, {int8: build_inference's
    result}, for phase 13."""
    from shineon_tpu_torch.ops import fused_spade as fs
    from shineon_tpu_torch.serving import build_inference
    from shineon_tpu_torch.tools import (
        flop_census,
        input_pipeline,
        serving_roof_census,
        serving_stages,
        train_ablate,
    )

    n_sites = sum(site[4] for site in SITES)
    n_convs = sum(shape[4] for shape in CONVS)
    out = {"stages": {}, "ablation": {}, "census": {}, "roof": {}}
    clips = {}
    t0 = time.perf_counter()
    for batch, int8 in TOOL_STAGE_CELLS:
        mode = "int8" if int8 else "bf16"
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        clips[int8] = build_inference(batch, int8_spade=int8)
        one_clip, warp, sams, raw, n_frames = clips[int8]
        built_s = time.perf_counter() - t1
        frame = {n: 0 for n in counters}
        if int8:
            frame.update(fused_multispade_int8=n_sites, multispade_hidden_absmax=n_sites,
                         int8_conv3x3=n_convs, int8_quantize=n_convs)
        else:
            frame["fused_multispade"] = n_sites
        clip = {n: v * n_frames for n, v in frame.items()}
        none = {n: 0 for n in counters}
        want = {"features": none, "gmm_warp": none, "gen_frame": frame, "gen_scan": clip,
                "one_clip": clip}
        zero_counts(counters)
        t1 = time.perf_counter()
        stages = serving_stages.build_stages(warp, sams, raw)
        t = serving_stages.measure_stages(stages, n_frames, batch, DEVICE, TOOL_ITERS, repeats=1)
        measured_s = time.perf_counter() - t1
        total = launch_counts(counters)
        got = {s: t[f"{s}_launches"] for s in serving_stages.STAGES}
        with torch.no_grad():
            ref = one_clip(raw).float()
            comp = serving_stages.compose_stages(stages).float()
        err = fs.error_ratio(comp, ref)
        ok = (got == want and all(total[n] >= clip[n] for n in counters)
              and comp.shape == (batch, n_frames) + FRAME + (3,)
              and bool(torch.isfinite(comp).all()) and err <= fs.KERNEL_TOLERANCE[torch.bfloat16])
        log(f"12a stages {mode} batch {batch}: " + ", ".join(
            f"{s} {t[s + '_ms']:.3f} ms (busy {t[s + '_busy_ms']:.3f}, idle "
            f"{t[s + '_idle']:.3f}; traced {t[s + '_traced_ms']:.3f}, idle there "
            f"{t[s + '_traced_idle']:.3f})"
            for s in serving_stages.STAGES)
            + f"; scan_minus_5xframe {t['scan_minus_5xframe_ms']:.3f} ms, clip_minus_stages "
            f"{t['clip_minus_stages_ms']:.3f} ms, clip_fps {t['clip_fps']:.2f} "
            f"(--iters {TOOL_ITERS}, 1 repeat; built and warmed in {built_s:.1f} s, measured in "
            f"{measured_s:.1f} s) [{card}]")
        log(f"12a launches a call {got} (expected {want}); composed stages against one_clip "
            f"{err:.3g} (limit {fs.KERNEL_TOLERANCE[torch.bfloat16]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"12a: the {mode} stage timing failed its checks")
        out["stages"][f"{mode} batch {batch}"] = t
        del one_clip, warp, sams, raw, stages, ref, comp
    log(f"12a (stage timing): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for name in train_ablate.CONFIGS:
        gc.collect()
        torch.cuda.empty_cache()
        zero_counts(counters)
        r = train_ablate.measure_config(name, device=DEVICE, steps=1, repeats=1)
        launched = launch_counts(counters)
        ok = (not any(launched.values()) and r["num_D"] == (1 if name == "num_D_1" else 2)
              and (r["losses"]["loss/G/vgg"] == 0) == (name == "no_vgg"))
        log(f"12b ablation {name}: step {r['step_s'] * 1e3:.1f} ms, {r['fps']:.2f} frames/s, "
            f"peak {r['peak_mem_gib']:.2f} GiB, num_D {r['num_D']}, loss "
            f"{r['losses']['loss']:.4f}, VGG term {r['losses']['loss/G/vgg']:.4f}, launches "
            f"{launched} {'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            raise SystemExit(f"12b: the {name} ablation failed its checks")
        out["ablation"][name] = r
    log(f"12b (train-step ablation): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    zero_counts(counters)
    censuses = {int8: flop_census.generator_census(16 if int8 else BATCH, int8)
                for int8 in (False, True)}
    fp = censuses[False]
    ratio = fp["total_flops"] / flop_census.analytic_generator_flops(BATCH)
    ok = abs(ratio - 1) < flop_census.TOLERANCE and not any(launch_counts(counters).values())
    log(f"12c FLOP census (CPU plain path, 64x48 x16): fp {fp['total_flops'] / 1e12:.4f} TFLOP "
        f"a forward at batch {BATCH}, {ratio:.4f} of the analytic count, {len(fp['convs'])} "
        f"shape-routes; int8 {censuses[True]['total_flops'] / 1e12:.4f} TFLOP at batch 16 "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("12c: the FLOP census disagrees with the analytic count by over 10%")
    out["census"] = {"ratio": ratio, "fp_tflop": fp["total_flops"] / 1e12,
                     "int8_tflop": censuses[True]["total_flops"] / 1e12}
    log(f"12c (FLOP census): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for int8, census in censuses.items():
        mode = "int8" if int8 else "bf16"
        zero_counts(counters)
        one_clip, _, _, raw, _ = clips[int8]
        rows, summary = serving_roof_census.run(census, DEVICE, TOOL_MIN_TFLOP, iters=1,
                                                repeats=1, clip=(one_clip, raw))
        del one_clip, raw
        launched = launch_counts(counters)
        i8_rows = [r for r in rows if r["i8_ms"] is not None]
        ok = (bool(rows) and all(r["bf16_ms"] > 0 for r in rows)
              and all(r["i8_ms"] > 0 and r["i8_conv_ms"] > 0 for r in i8_rows)
              and launched["int8_conv3x3"] >= len(i8_rows) and summary["clip_busy_ms"] > 0
              and all(v.get("traced_clip_ms", 0) > 0 for v in summary["routes"].values())
              and summary["clip_other_ms"] >= 0)
        log(f"12d roof census {mode} batch {census['batch']}: {len(rows)} shapes above "
            f"{TOOL_MIN_TFLOP} TFLOP ({len(i8_rows)} with an int8 route); conv roof "
            f"{summary['conv_roof_ms_per_forward']:.3f} ms a forward (best dispatch "
            f"{summary['conv_roof_ms_best_dispatch']:.3f}), clip "
            f"{summary['clip_conv_roof_ms']:.3f} ms against the traced clip's busy "
            f"{summary['clip_busy_ms']:.3f} ms of "
            f"{summary['clip_traced_ms']:.3f}; misgated {summary['misgated']} "
            f"{'ok' if ok else 'FAIL'} [{card}]")
        for route, v in summary["routes"].items():
            log(f"12d   {route}: isolated {v['isolated_clip_ms']:.3f} ms a clip, traced "
                f"{v.get('traced_clip_ms', 0.0):.3f} ms")
        log(f"12d   other kernels of the traced clip: {summary['clip_other_ms']:.3f} ms")
        for r in rows:
            log(f"12d   {json.dumps(r)}")
        if not ok:
            raise SystemExit(f"12d: the {mode} roof census failed its checks")
        out["roof"][mode] = summary
    log(f"12d (roof census): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    serving_fps = out["stages"]["int8 batch 16"]["clip_fps"]
    loader = input_pipeline.run(TOOL_LOADER_THREADS, repeats=1, serving_fps=serving_fps,
                                device=DEVICE)
    ok = [r["workers"] for r in loader["rows"]] == list(TOOL_LOADER_THREADS) and all(
        r["frames_per_sec"] > 0 for r in loader["rows"])
    log("12e input pipeline (VVT, 256x192, batch 16 x 5 frames, to the card): " + ", ".join(
        f"{r['workers']} threads {r['ms_per_batch']:.1f} ms a batch, {r['frames_per_sec']:.1f} "
        f"frames/s, {r['vs_serving']:.3f} of the int8 clip's {serving_fps:.1f}"
        for r in loader["rows"]) + f" {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise SystemExit("12e: the input pipeline failed its checks")
    out["loader"] = loader
    log(f"12e (input pipeline): {time.perf_counter() - t0:.1f} s")
    return out, clips


# phase 13: the JAX bench's inference half (shineon_tpu_torch/bench.py) at
# full width with its repeats cut, on phase 12a's clips: batch 16 int8 (the
# JAX bench's configuration) and batch 4 bf16 (this file's clip), then
# --flops and the --profile tables
BENCH_CELLS = ((16, True), (BATCH, False))  # (serving batch, int8)
BENCH_REPEATS = 2


def profile_rows(path):
    """The op rows of a --profile table."""
    return [line for line in path.read_text().splitlines() if line.startswith("| `")]


def run_bench(torch, counters, card, clips, profile_dir):
    """Phase 13: bench.measure_inference at BENCH_CELLS on ``clips``
    (phase 12a's, {int8: build_inference's result}), BENCH_REPEATS repeats
    of bench.ITERS chained clips, every launch count at 0 before each cell:
    a finite positive median frames/s within its min and max; the launches
    of one clip exact (kernel 1, or kernel 2 with its pre-pass and kernel 4
    with its quantize pass) and each at least that many times a timed clip
    in the run; the 1-clip warm-up window's frame mean against
    one_clip(raw)'s (its launches after the run are not counted; the
    window's 1e-12 bump of flow_raw is below f32's resolution), within the
    bf16 chain tolerance. Then bench.clip_flops_b1 (--flops) within 10% of
    the analytic count, and both --profile tables in ``profile_dir``, each
    with rows: the bf16 cell's clip table, and the step table that phase 6
    wrote from its traced attention step. Returns the readings."""
    from shineon_tpu_torch import bench
    from shineon_tpu_torch.ops import fused_spade as fs

    n_sites = sum(site[4] for site in SITES)
    n_convs = sum(shape[4] for shape in CONVS)
    timed_clips = 1 + BENCH_REPEATS * (bench.ITERS + 1)
    out = {"cells": {}}
    t0 = time.perf_counter()
    for batch, int8 in BENCH_CELLS:
        mode = "int8" if int8 else "bf16"
        frame = {n: 0 for n in counters}
        if int8:
            frame.update(fused_multispade_int8=n_sites, multispade_hidden_absmax=n_sites,
                         int8_conv3x3=n_convs, int8_quantize=n_convs)
        else:
            frame["fused_multispade"] = n_sites
        one_clip, _, _, raw, n_frames = clips[int8]
        clip = {n: v * n_frames for n, v in frame.items()}
        zero_counts(counters)
        t1 = time.perf_counter()
        r = bench.measure_inference(batch, int8=int8, repeats=BENCH_REPEATS, built=clips[int8],
                                    profile_dir=None if int8 else profile_dir)
        measured_s = time.perf_counter() - t1
        total = launch_counts(counters)
        with torch.no_grad():
            ref = float(one_clip(raw).float().mean())
        del one_clip, raw
        err = fs.error_ratio(torch.tensor([r["infer_warmup_mean"]]), torch.tensor([ref]))
        ok = (0 < r["infer_fps_min"] <= r["infer_fps"] <= r["infer_fps_max"] < float("inf")
              and r["infer_clip_launches"] == clip and r["mode"] == mode
              and all(total[n] >= v * timed_clips for n, v in clip.items())
              and err <= fs.KERNEL_TOLERANCE[torch.bfloat16])
        log(f"13 bench {mode} batch {batch}: {r['infer_fps']:.2f} frames/s (min "
            f"{r['infer_fps_min']:.2f}, max {r['infer_fps_max']:.2f}), clip "
            f"{r['infer_clip_s'] * 1e3:.3f} ms of {[round(v * 1e3, 3) for v in r['infer_clip_s_all']]}"
            f", MFU {r['infer_mfu']}, busy {r['infer_busy_ms']:.3f} ms, idle "
            f"{r['infer_idle']:.3f} (traced {r['infer_traced_ms']:.3f} ms a clip); "
            f"{BENCH_REPEATS} repeats of {bench.ITERS} chained clips, measured in "
            f"{measured_s:.1f} s [{card}]")
        log(f"13 launches a clip {r['infer_clip_launches']} (expected {clip}), in the run "
            f"{total}; 1-clip window mean {r['infer_warmup_mean']!r} against one_clip "
            f"{ref!r}: {err:.3g} (limit {fs.KERNEL_TOLERANCE[torch.bfloat16]}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"13: the bench's {mode} batch {batch} cell failed its checks")
        out["cells"][f"{mode} batch {batch}"] = r
    clips.clear()
    log(f"13a (the bench's clips): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    zero_counts(counters)
    flops = bench.clip_flops_b1()
    ok = abs(flops["ratio"] - 1) < 0.10 and not any(launch_counts(counters).values())
    log(f"13b --flops (CPU plain path): gen_clip_flops_b1 {flops['gen_clip_flops_b1'] / 1e12:.4f}"
        f" TFLOP ({flops['n_frames']} generator forwards of "
        f"{flops['generator_flops_b1'] / 1e12:.4f}, GMM convs "
        f"{flops['gmm_conv_flops_b1'] / 1e9:.3f} GFLOP) against the analytic "
        f"{flops['analytic_clip_flops_b1'] / 1e12:.4f}: {flops['ratio']:.4f} "
        f"{'ok' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
    if not ok:
        raise SystemExit("13b: --flops disagrees with the analytic count by over 10%")
    out["flops"] = flops

    tables = {name: profile_rows(Path(profile_dir) / name)
              for name in ("PROFILE_INFER.md", "PROFILE.md")}
    ok = all(0 < len(rows) <= bench.PROFILE_TOP for rows in tables.values())
    for name, rows in tables.items():
        log(f"13c --profile {name} ({len(rows)} rows) [{card}]")
        for row in rows:
            log(f"13c   {row}")
    if not ok:
        raise SystemExit("13c: a --profile table is missing or empty")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "shineon_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    from shineon_tpu_torch.ops import cuda_build
    from shineon_tpu_torch.ops import fused_attention as fa
    from shineon_tpu_torch.ops import fused_spade as fs
    from shineon_tpu_torch.ops import int8_conv as ic
    from shineon_tpu_torch.models.flownet import FlowNet
    from shineon_tpu_torch.ops import probes as pr
    from shineon_tpu_torch.serving import build_inference
    from shineon_tpu_torch.tools import conv_probe, serving_counters

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    log(card)

    t0 = time.perf_counter()
    sources = (fs.KERNEL_SOURCE, ic.KERNEL_SOURCE, fa.KERNEL_SOURCE, pr.KERNEL_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        reports = list(pool.map(cuda_build.build, sources))
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(sources)} in parallel)")
    for source, report in zip(sources, reports):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {source}: {line.strip()}")
    for source, report in zip(sources, reports):
        if source in SERVING_BODIES:
            check_build(cuda_build, source, report)

    errors, timings = check_chain_kernel(torch, fs)
    q_errors, q_timings = check_int8_chain(torch, fs)
    c_errors, c_timings = check_int8_conv(torch, ic, fs)
    a_errors, a_timings = check_attention(torch, fa, fs)
    t_errors, t_timings = check_attention(torch, fa, fs, TOM_ATTENTION_SHAPES, TOM_BATCH,
                                          time_all=True)
    t5_errors, t5_timings = check_attention(torch, fa, fs, TOM5_ATTENTION_SHAPES, TOM_BATCH,
                                            time_all=True)
    check_attention(torch, fa, fs, SMALL_TOM_ATTENTION_SHAPES, 2)
    check_small_clip(torch)

    n_sites = sum(site[4] for site in SITES)
    n_att_sites = sum(site[5] for site in SITES)
    n_convs = sum(shape[4] for shape in CONVS)
    n_att = sum(shape[3] for shape in ATTENTION_SHAPES)
    q_counters = serving_counters()
    fp_counters = {n: q_counters[n] for n in ("fused_multispade", "sagan_attention")}
    q_expected = {"fused_multispade": 0, "fused_multispade_int8": n_sites,
                  "multispade_hidden_absmax": n_sites, "int8_conv3x3": n_convs,
                  "int8_quantize": n_convs}
    clip, launches, n_frames, _ = run_clip(
        torch, "bf16", lambda: build_inference(BATCH), fp_counters,
        {"fused_multispade": n_sites, "sagan_attention": 0})
    q_clip, q_launches, _, built = run_clip(
        torch, "int8", lambda: build_inference(BATCH, int8_spade=True), q_counters,
        {**q_expected, "sagan_attention": 0})
    a_clip, a_launches, _, _ = run_clip(
        torch, "bf16 attention", lambda: build_attention_clip(torch, BATCH, DEVICE, 420),
        fp_counters, {"fused_multispade": n_att_sites, "sagan_attention": n_att})
    qa_clip, qa_launches, _, a_built = run_clip(
        torch, "int8 attention",
        lambda: build_attention_clip(torch, BATCH, DEVICE, 420, int8_spade=True), q_counters,
        {**q_expected, "fused_multispade_int8": n_att_sites,
         "multispade_hidden_absmax": n_att_sites, "sagan_attention": n_att})
    times = time_clips(torch, {"bf16": clip, "int8": q_clip, "bf16 attention": a_clip,
                               "int8 attention": qa_clip})
    for name, (ms, samples) in times.items():
        log(f"clip {name} time: median {ms:.1f} ms of {[round(v, 1) for v in samples]} ms, "
            f"{BATCH * n_frames / ms * 1e3:.2f} frames/s, batch {BATCH} x {n_frames} frames, "
            f"timed in turns [{card}]")
    med = {name: ms for name, (ms, _) in times.items()}
    del clip, q_clip, a_clip, qa_clip

    # phase 6, the training step, after the clips are timed
    t0 = time.perf_counter()
    check_small_step(torch)
    # the --profile tables of phase 13: the step's from phase 6's attention trace
    profile_dir = tempfile.TemporaryDirectory(prefix="smoke_profile_")
    training = {label: run_training(torch, label, q_counters, card, attention, profile_dir.name)
                for label, attention in (("production", False), ("attention", True))}
    # kernel 3 in the traced attention step against its serving time at the
    # same shapes (phase 3d), for as many calls
    at_step = training["attention"]
    serving_equiv = sum(t["device_ms"] * t["per_frame"] * n_frames for t in a_timings.values()
                        ) * TRAIN_PASSES["exact"]
    log(f"attention kernel in the traced exact training step: {at_step['trace']['kernel_ms']:.3f}"
        f" ms in {at_step['trace']['kernel_calls']:g} calls, against {serving_equiv:.3f} ms for "
        f"as many calls at the serving timings of phase 3d [{card}]")
    log(f"phase 6 (training): {time.perf_counter() - t0:.1f} s")

    # phase 7, GMM and TOM training and SAMS's val and visual steps
    t0 = time.perf_counter()
    check_small_stage_steps(torch)
    stages = {kind: run_stage_training(torch, kind, q_counters, card)
              for kind in ("warp", "unet_mask")}
    tom = stages["unet_mask"]
    tom_equiv = sum(t["device_ms"] * t["per_frame"] for t in t_timings.values())
    log(f"attention kernel in the traced TOM training step: {tom['trace']['kernel_ms']:.4f} ms in "
        f"{tom['trace']['kernel_calls']:g} calls, against {tom_equiv:.4f} ms for as many calls at "
        f"the timings of phase 3d [{card}]")
    sams_val = {
        "production": run_sams_val(torch, "production", q_counters, card,
                                   {"fused_multispade": n_sites}, attention=False),
        "attention": run_sams_val(torch, "attention", q_counters, card,
                                  {"fused_multispade": n_att_sites, "sagan_attention": n_att},
                                  attention=True)}
    log(f"phase 7 (GMM and TOM training, SAMS val and visual steps): "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 3e after the clips are timed: its profiler sessions stay out of them
    t0 = time.perf_counter()
    p_errors, p_timings = check_probes(torch, pr, ic, fs, card)
    p_launches = run_probe_tools(pr, ic)
    log(f"phase 3e (probes and their tools): {time.perf_counter() - t0:.1f} s")

    # phase 8, FlowNet2 flow annotation, after every kernel phase
    t0 = time.perf_counter()
    flow_card = check_flownet_card(torch)
    flownet = FlowNet(seed=FLOW_SEED)
    flow_runs = {batch: run_flownet(torch, flownet, batch, q_counters, card)
                 for batch in FLOW_BATCHES}
    run_flow_chain(torch, flownet, q_counters, {"fused_multispade": n_sites}, card)
    del flownet
    log(f"phase 8 (FlowNet2 flow annotation): {time.perf_counter() - t0:.1f} s")

    # phase 9, the training runtime and the host data, after every kernel phase
    t0 = time.perf_counter()
    runtime = run_runtime(torch, q_counters, n_sites * n_frames, card)
    log(f"phase 9 (training runtime and host data): {time.perf_counter() - t0:.1f} s")

    # phase 10: kernels 1 and 2 with the other hidden activations, then the
    # command line at full width
    t0 = time.perf_counter()
    act_errors, act_times, act_top = check_activations(torch, fs, card)
    log(f"phase 10a (hidden activations): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli = run_cli(torch, q_counters, n_sites * n_frames, card)
    log(f"phase 10b (the command line): {time.perf_counter() - t0:.1f} s")

    # phase 11: the QA loop, a converted Lightning checkpoint, DDP
    t0 = time.perf_counter()
    qa = run_qa(torch, q_counters, n_frames, card)
    log(f"phase 11a (the QA loop): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lightning = run_lightning(torch, q_counters, n_sites * n_frames, card)
    log(f"phase 11b (a converted Lightning checkpoint): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_ddp(torch, q_counters, card)
    log(f"phase 11c (DDP at world size 1): {time.perf_counter() - t0:.1f} s")

    # phase 12: the measurement tools at full width
    t0 = time.perf_counter()
    measured, tool_clips = run_tools(torch, q_counters, card)
    stage_clips = {mode: measured["stages"][cell]["one_clip_launches"]
                   for mode, cell in (("bf16", f"bf16 batch {BATCH}"), ("int8", "int8 batch 16"))}
    log(f"phase 12 (the measurement tools): {time.perf_counter() - t0:.1f} s")

    # phase 13: the bench's inference half at full width
    t0 = time.perf_counter()
    benched = run_bench(torch, q_counters, card, tool_clips, profile_dir.name)
    profile_dir.cleanup()
    bench_clips = {mode: benched["cells"][cell]["infer_clip_launches"]
                   for mode, cell in (("bf16", f"bf16 batch {BATCH}"), ("int8", "int8 batch 16"))}
    log(f"phase 13 (the bench's inference half): {time.perf_counter() - t0:.1f} s")

    # the int8 models' own count of int8 convs, against the list above
    log(f"int8 convs in the built generators: {built}, with attention {a_built} "
        f"(expected {n_convs} a frame)")
    if built != n_convs or a_built != n_convs:
        raise SystemExit("an int8 generator's conv count disagrees with the conv list")

    act_key = act_top[:4]
    activations = {act: {"device_ms": t["device_ms"][0], "int8_device_ms": t["int8_device_ms"][0],
                         "prepass_ms": t["prepass_ms"][0]} for act, t in act_times.items()}
    for act in OTHER_ACTIVATIONS:
        activations[act]["max_abs_err"], activations[act]["int8_max_abs_err"] = act_errors[
            act_key + ("bfloat16", act)]
    activations["relu"]["device_ms_again"] = act_times["relu"]["device_ms"][1]
    activations["relu"]["int8_device_ms_again"] = act_times["relu"]["int8_device_ms"][1]

    def per_clip(tim, key="per_frame"):  # device time of the kernels, a clip
        return (sum(t["device_ms"] * t[key] * n_frames for t in tim.values()),
                sum(t["bound_ms"] * t[key] * n_frames for t in tim.values()))

    for name, tim in (("fused_multispade", timings), ("fused_multispade_int8", q_timings),
                      ("int8_conv3x3", c_timings)):
        k, b = per_clip(tim)
        log(f"{name} per clip from the shape timings (device time): {k:.1f} ms, "
            f"bound {b:.2f} ms")
    for name, tim in (("fused_multispade", timings), ("fused_multispade_int8", q_timings),
                      ("sagan_attention", a_timings)):
        k, b = per_clip(tim, "per_frame_att")
        log(f"{name} per attention clip from the shape timings (device time): {k:.1f} ms, "
            f"bound {b:.2f} ms")
    call_bound_clip = sum(t["call_bound_ms"] * t["per_frame"] * n_frames
                          for t in c_timings.values())
    log(f"int8_conv3x3's whole calls (abs-max, quantize pass, conv) per clip: bound "
        f"{call_bound_clip:.2f} ms (x read once in bf16)")
    cudnn_clip = sum(t["cudnn_bf16_ms"] * t["per_frame"] * n_frames for t in c_timings.values())
    log(f"cuDNN bf16 conv at the same shapes per clip: {cudnn_clip:.1f} ms")
    absmax_clip = sum(t["absmax_ms"] * t["per_frame"] * n_frames for t in c_timings.values())
    log(f"the int8 conv's abs-max reduction per clip (device time): {absmax_clip:.2f} ms")
    qz_timings = {k: {**t["quantize"], "per_frame": t["per_frame"]} for k, t in c_timings.items()}
    qz_clip, qz_bound = per_clip(qz_timings)
    log(f"its quantize pass per clip (device time): {qz_clip:.2f} ms, bound {qz_bound:.2f} ms")
    sdpa_clip = sum(t["sdpa_ms"] * t["per_frame"] * n_frames for t in a_timings.values())
    log(f"SDPA (scale 1) at the same shapes per attention clip: {sdpa_clip:.1f} ms")
    log("clip latency " + ", ".join(f"{name} {ms:.1f} ms" for name, ms in med.items())
        + f" [{card}]")
    log("flownet2 (256x192, TF32 on) " + ", ".join(
        f"batch {b}: {r['ms']:.2f} ms, {r['ms'] / b:.3f} ms a pair, "
        f"{r['ops'] / r['ms'] / 1e9:.1f} TFLOP/s" for b, r in flow_runs.items())
        + f"; card against CPU {flow_card['max_rel_err']:.3g} (TF32 off) [{card}]")

    top = max(timings, key=lambda k: timings[k]["flops"])
    q_top = max(q_timings, key=lambda k: q_timings[k]["ops"])
    c_top = max(c_timings, key=lambda k: c_timings[k]["ops"])
    a_top = max(a_timings, key=lambda k: a_timings[k]["flops"])
    t, qt, ct, at = timings[top], q_timings[q_top], c_timings[c_top], a_timings[a_top]
    site = lambda k: {"B": BATCH, "H": k[0], "W": k[1], "C": k[2],  # noqa: E731
                      "seg_channels": list(k[3]), "dtype": "bfloat16"}
    kernels = [{
        "name": "fused_multispade",
        "route": "cuda",
        "source": "shineon_tpu_torch/csrc/fused_multispade.cu",
        "replaces": "shineon_tpu/ops/fused_spade.py:212",
        "launches": launches["fused_multispade"],
        "attention_clip_launches": a_launches["fused_multispade"],
        "max_abs_err": errors[top + ("bfloat16",)],
        "max_abs_err_f32": errors[top + ("float32",)],
        "ms": t["ms"],
        "device_ms": t["device_ms"],
        "peak_share": t["peak_share"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "site": site(top),
        "clip_ms": med["bf16"],
        "clip_kernel_ms": per_clip(timings)[0],
        # phase 7: the production SAMS val step (and its visual step), and
        # with attention
        "sams_val_step_launches": sams_val["production"]["launches"]["fused_multispade"],
        "sams_attention_val_step_launches": sams_val["attention"]["launches"][
            "fused_multispade"],
        "sams_val_step_ms": sams_val["production"]["val_ms"],
        # phase 9a: the trainer's SAMS fit (its validation and image calls)
        "trainer_sams_launches": runtime["fit"]["launches"],
        # phase 10: each hidden activation at the top site (device time, in
        # turns with relu's), and the SAMS fit of the command line (swish)
        "activations": activations,
        "activation_site": site(act_key),
        "cli_train_launches": cli["train"]["launches"],
        # phase 11: the QA loop's init and trained exports and its fit's
        # images, and the converted Lightning checkpoint's test entry
        "qa_loop_launches": {stage: qa["launches"][stage]["fused_multispade"]
                             for stage in ("export_init", "fit", "export_trained")},
        "lightning_test_launches": lightning["launches"],
        # phase 12a: one_clip of the stage timing tool, bf16 at batch 4
        "stages_tool_clip_launches": stage_clips["bf16"]["fused_multispade"],
        # phase 13: a clip of the bench's inference half, bf16 at batch 4
        "bench_clip_launches": bench_clips["bf16"]["fused_multispade"],
    }, {
        "name": "fused_multispade_int8",
        "route": "cuda",
        "source": "shineon_tpu_torch/csrc/fused_multispade.cu",
        "replaces": "shineon_tpu/ops/fused_spade.py:212 (quant=True)",
        "launches": q_launches["fused_multispade_int8"],
        "prepass_launches": q_launches["multispade_hidden_absmax"],
        "attention_clip_launches": qa_launches["fused_multispade_int8"],
        "max_abs_err": q_errors[q_top + ("bfloat16",)][0],
        "max_abs_err_f32": q_errors[q_top + ("float32",)][0],
        "ms": qt["ms"],
        "device_ms": qt["device_ms"],
        "peak_share": qt["peak_share"],
        "prepass_ms": qt["prepass_ms"],
        "plain_ms": qt["plain_ms"],
        "bound_ms": qt["bound_ms"],
        "bound_by": qt["bound_by"],
        "library_ms": None,
        "bf16_chain_device_ms": qt["bf16_chain_device_ms"],
        "site": site(q_top),
        "clip_ms": med["int8"],
        "clip_kernel_ms": per_clip(q_timings)[0],
        # phase 10b: the test entry with --int8_spade (swish)
        "cli_test_launches": cli["test"]["launches"],
        "cli_test_prepass_launches": cli["test"]["prepass_launches"],
        # phase 11a: the QA loop's int8 export
        "qa_int8_export_launches": qa["launches"]["export_int8"]["fused_multispade_int8"],
        "qa_int8_export_prepass_launches": qa["launches"]["export_int8"][
            "multispade_hidden_absmax"],
        # phase 12a: one_clip of the stage timing tool, int8 at batch 16
        "stages_tool_clip_launches": stage_clips["int8"]["fused_multispade_int8"],
        # phase 13: a clip of the bench's inference half, int8 at batch 16
        "bench_clip_launches": bench_clips["int8"]["fused_multispade_int8"],
        "bench_clip_prepass_launches": bench_clips["int8"]["multispade_hidden_absmax"],
    }, {
        "name": "int8_conv3x3",
        "route": "cuda",
        "source": "shineon_tpu_torch/csrc/int8_conv3x3.cu",
        "replaces": "tools/pallas_conv_probe.py:282",
        "launches": q_launches["int8_conv3x3"],
        "attention_clip_launches": qa_launches["int8_conv3x3"],
        "max_abs_err": c_errors[c_top + ("bfloat16",)],
        "max_abs_err_f32": c_errors[c_top + ("float32",)],
        "ms": ct["ms"],
        "device_ms": ct["device_ms"],
        "call_ms": ct["call_ms"],
        "call_bound_ms": ct["call_bound_ms"],
        "plain_ms": ct["plain_ms"],
        "bound_ms": ct["bound_ms"],
        "bound_by": ct["bound_by"],
        "library_ms": None,
        "cudnn_bf16_ms": ct["cudnn_bf16_ms"],
        "absmax_ms": ct["absmax_ms"],
        "ksplit": ct["ksplit"],
        "site": {"B": BATCH, "H": c_top[0], "W": c_top[1], "Cin": c_top[2], "Cout": c_top[3],
                 "dtype": "bfloat16"},
        "clip_ms": med["int8"],
        "clip_kernel_ms": per_clip(c_timings)[0],
        "qa_int8_export_launches": qa["launches"]["export_int8"]["int8_conv3x3"],
        "stages_tool_clip_launches": stage_clips["int8"]["int8_conv3x3"],
        "bench_clip_launches": bench_clips["int8"]["int8_conv3x3"],
    }, {
        "name": "int8_quantize",
        "route": "cuda",
        "source": "shineon_tpu_torch/csrc/int8_conv3x3.cu",
        "replaces": "tools/pallas_conv_probe.py:233 (the quantize before the call at :282)",
        "launches": q_launches["int8_quantize"],
        "attention_clip_launches": qa_launches["int8_quantize"],
        "max_abs_err": max(v for k, v in c_errors.items() if k[-1] == "quantize"),
        "ms": qz_timings[c_top]["ms"],
        "device_ms": qz_timings[c_top]["device_ms"],
        "plain_ms": qz_timings[c_top]["plain_ms"],
        "bound_ms": qz_timings[c_top]["bound_ms"],
        "bound_by": qz_timings[c_top]["bound_by"],
        "library_ms": None,
        "site": {"B": BATCH, "H": c_top[0], "W": c_top[1], "Cin": c_top[2], "dtype": "bfloat16"},
        "clip_kernel_ms": qz_clip,
        "qa_int8_export_launches": qa["launches"]["export_int8"]["int8_quantize"],
        "stages_tool_clip_launches": stage_clips["int8"]["int8_quantize"],
        "bench_clip_launches": bench_clips["int8"]["int8_quantize"],
    }, {
        "name": "sagan_attention",
        "route": "cuda",
        "source": "shineon_tpu_torch/csrc/sagan_attention.cu",
        "replaces": "shineon_tpu/ops/fused_attention.py:58",
        "launches": a_launches["sagan_attention"],
        "int8_clip_launches": qa_launches["sagan_attention"],
        "max_abs_err": max(a_errors[a_top + ("bfloat16", rows)][0] for rows in SCORE_STDS),
        "max_abs_err_f32": max(a_errors[a_top + ("float32", rows)][0] for rows in SCORE_STDS),
        "ms": at["ms"],
        "device_ms": at["device_ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": at["sdpa_ms"],
        "qk_ratio": at["qk_ratio"],
        "work_ratio": at["work"],
        "shape": {"B": BATCH, "N": a_top[0], "d": a_top[1], "dv": a_top[2],
                  "dtype": "bfloat16"},
        "clip_ms": med["bf16 attention"],
        "clip_kernel_ms": per_clip(a_timings)[0],
        # the training path (phase 6): the attention configuration's run of
        # TRAIN_STEPS exact and fast steps, the launches of one exact step
        # (remat on), and the kernel's device time in a traced exact step
        "training_launches": at_step["launches"]["sagan_attention"],
        "training_exact_step_launches": at_step["step_launches"]["exact"],
        "training_step_device_ms": at_step["trace"]["kernel_ms"],
        "training_step_serving_equivalent_ms": serving_equiv,
        # phase 7: TOM's training (one frame, batch 8): launches a train,
        # val or visual step, all of phase 7b's, the kernel's device time in
        # a traced step; its time at TOM's shapes (phase 3d) at one frame
        # and at five; and the SAMS attention val step's launches
        "tom_step_launches": tom["step_launches"],
        "tom_launches": tom["launches"]["sagan_attention"],
        "tom_step_device_ms": tom["trace"]["kernel_ms"],
        "tom_shapes": {f"{k[0]}x{k[1]}x{k[2]}": shape_times(t) for k, t in t_timings.items()},
        "tom5_shapes": {f"{k[0]}x{k[1]}x{k[2]}": shape_times(t) for k, t in t5_timings.items()},
        "tom_max_abs_err": max(e[0] for e in t_errors.values()),
        "tom5_max_abs_err": max(e[0] for e in t5_errors.values()),
        "sams_val_step_launches": sams_val["attention"]["launches"]["sagan_attention"],
        # phase 9e: TOM's steps, images and test export in the two-stage chain
        "chain_tom_launches": runtime["chain"]["launches"],
        # phase 10b: the documented TOM command with --fast_dev_run
        "cli_tom_launches": cli["tom"]["launches"],
    }]
    for name in (*pr.SPECS, *pr.CONV_VARIANTS):
        key = name if name in pr.SPECS else (name, conv_probe.SHAPES[0])
        t = p_timings[key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "shineon_tpu_torch/csrc/probes.cu",
            "replaces": (f"tools/proto_mosaic_caps.py:{pr.SPECS[name].line}" if name in pr.SPECS
                         else f"tools/pallas_conv_probe.py:282 (variant={name[5:]})"),
            "launches": p_launches[name],
            "max_abs_err": p_errors[key],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "family": pr.SPECS[name].family if name in pr.SPECS else "tap products",
            "shape": t["shape"],
            **{k: v for k, v in t.items()
               if k not in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
