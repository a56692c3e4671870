"""The layout probes on the card: which in-kernel layout operations the
port's probe kernels compute right (counterpart of tools/proto_mosaic_caps.py).

    python -m shineon_tpu_torch.tools.layout_caps

Runs all 15 probes, A to M, through their wrappers in ``ops/probes.py`` on
the probes' own constant inputs (ones, aranges), and checks each output
against the probe's own expected values. Prints ``OK   <probe>`` or
``FAIL <probe>: <error>`` a line, and exits 1 if any probe failed.
(The JAX tool never reaches A2, K, L and M, which follow its ``sys.exit``,
and exits 0 whatever fails.) Probe L is held to the function its reference
states; probe M, which the JAX tool checks for finite values only, is held
to the value its constant inputs give.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from shineon_tpu_torch.ops import probes

F32, BF16 = torch.float32, torch.bfloat16


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def cases(device) -> list:
    """(label, wrapper name, inputs, expected) for every probe: the JAX
    probe's inputs and the targets of its checks."""
    def full(shape, dtype, value=1.0):
        return torch.full(shape, value, dtype=dtype, device=device)

    def arange(n, dtype=F32):
        return torch.arange(n, dtype=F32, device=device).to(dtype)

    c_in, c2_in = arange(12 * 4000, BF16).reshape(12, 4000), arange(128 * 4000, BF16).reshape(128, 4000)
    b2_in, f_in = arange(1600 * 128).reshape(1600, 128), arange(4800).reshape(1, 4800)
    g_in, k_in = arange(64 * 128).reshape(64, 128), arange(12 * 20 * 56).reshape(12, 20, 56)
    l_in = arange(4 * 64 * 56).reshape(4, 64, 56)
    wsh, wgb = full((9, 3, 128), BF16, 0.01), full((3, 128, 128), BF16, 0.01)
    # M on ones: each hidden value is 9 taps x 3 channels x wsh, rounded to
    # bf16; each output 3 row taps x 128 channels x h x wgb (exact in f32)
    h = (27 * wsh[0, 0, 0].float()).to(BF16).float()
    m_value = (384 * h * wgb[0, 0, 0].float()).item()
    return [
        ("A: einsum('hwc,cd->hwd') 3D contraction in-kernel", "probe_a",
         (full((16, 64, 32), BF16), full((32, 128), BF16)), 32.0),
        ("A2: contraction over MAJOR dim 'chw,cn->hwn'", "probe_a2",
         (full((12, 20, 56), BF16), full((12, 128), BF16)), 12.0),
        ("B: reshape (A*B, C) -> (A, B, C) -> (A*B, C), B%8==0", "probe_b",
         (full((1600, 128), F32, 0.0),), 1.0),
        ("B2: reshape then column-slice (A,B,C)[:, 4:196, :]", "probe_b2",
         (b2_in,), _np(b2_in).reshape(8, 200, 128)[:, 4:196]),
        ("C: 2D transpose (12, N) -> (N, 12) bf16", "probe_c", (c_in,), _np(c_in).T),
        ("C2: 2D transpose (128, 4000) -> (4000, 128) bf16", "probe_c2", (c2_in,), _np(c2_in).T),
        ("D: matmul K=12 (P, 12) @ (12, 128)", "probe_d",
         (full((4000, 12), BF16), full((12, 128), BF16)), 12.0),
        ("E: broadcast (C,) over (TH, W, C) elementwise", "probe_e",
         (full((16, 192, 64), F32), full((1, 1, 64), F32, 2.0)), 3.0),
        ("F: reshape lane-split (N*Cs,) -> (N, Cs), Cs=12", "probe_f",
         (f_in,), _np(f_in).reshape(400, 12)),
        ("G: dynamic non-aligned sublane slice (P+4, C)[ds(k), :]", "probe_g",
         (g_in,), np.concatenate([_np(g_in)[3:19], _np(g_in)[19:35]])),
        ("H: 4D block, minor dims (W=192, C=64) bf16", "probe_h",
         (full((2, 32, 192, 64), BF16),), 2.0),
        ("I: dot_general (2C,NH)@(NH,P) lane-major N, K sublanes", "probe_i",
         (full((128, 12), BF16), full((12, 4000), BF16)), 12.0),
        ("K: static unaligned lane slice (C, H, W)[:, :, 3:51]", "probe_k",
         (k_in,), _np(k_in)[:, :, 3:51]),
        ("L: dynamic unaligned SUBLANE slice on 3D (C, Hp, W2)", "probe_l",
         (l_in,), np.stack([_np(l_in)[:, 3:19], _np(l_in)[:, 11:27]])),
        ("M: 3D einsum chain like the spade kernel (small)", "probe_m",
         (full((3, 70, 56), BF16), wsh, wgb), m_value),
    ]


def main(device="cuda") -> int:
    """Run every probe on ``device``; 0 if all pass, else 1."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("layout_caps: no CUDA device", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (plain versions)"
    print(f"device: {name}", flush=True)
    failed, todo = 0, cases(device)
    for label, probe, inputs, expected in todo:
        try:
            out = probes.WRAPPERS[probe](*inputs)
            np.testing.assert_allclose(_np(out), expected)
            print(f"OK   {label}", flush=True)
        except Exception as e:  # noqa: BLE001 -- report every probe, then fail the run
            failed += 1
            msg = str(e).strip().split("\n")[0][:160]
            print(f"FAIL {label}: {type(e).__name__}: {msg}", flush=True)
    print(f"{len(todo) - failed} of {len(todo)} probes OK", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
