"""Plain PyTorch reference of the SAMS serving clip, written from the
published model (ShineOn-Virtual-Tryon's SAMS generator, CP-VTON's GMM) and
independent of the program under test: it imports nothing of it and takes
none of its state.

Everything is computed in float32; :func:`plain_precision` turns TF32 off
for the duration of a call. Weights are a dict keyed by the parameter
names of :func:`param_specs`, made by the benchmark from the seed and
handed to both sides. The running statistics and spectral ``u`` that the
served model derives in its set-up (three train-mode rollouts) are worked
out here again by :func:`warm_up` from the same weights and batch.

With ``bits`` (an int) the eval generator computes the int8 serving
mode's arithmetic (or the same at another width, the control's int4):
every SPADE modulation conv of [gamma | beta] takes its hidden map quantized with one
symmetric scale over the whole batch tensor and its weights quantized per
output channel; every 3x3 conv whose channel counts pass the gate (both at
least ``int8_min_channels``) takes its input quantized per tensor and its
(spectrally normalized) weight per output channel. Integer sums are taken
in float32 (exact while a partial sum stays under 2**24; past it a
rounding of 2**-24 of the sum), dequantized as ``acc * (s * s_w) + bias``.
With ``bits="fp8"`` (the float configuration's control) every conv of
the eval generator, the SPADE ones included, takes both operands rounded to
float8 e4m3, the input with one scale over the tensor and the weight with
one an output channel, each scale mapping the abs-max to e4m3's largest
value (448); the products are summed in float32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

LABEL_CHANNELS = {"agnostic": 4, "cloth": 3, "densepose": 3, "flow": 2}
NHID = 128  # SPADE's hidden width (upstream spade.py)
EPS_NORM = 1e-5
EPS_SPECTRAL = 1e-12
MOMENTUM = 0.9  # running = momentum * running + (1 - momentum) * batch
LEAKY = 0.2  # the resblock activation, LeakyReLU(0.2)
# LIP parse labels of the "head" crop (upstream tryon_dataset.py: hat, hair,
# sunglasses, face, socks, pants, scarf, skirt, legs, shoes)
HEAD_LABELS = (1, 2, 4, 13, 8, 9, 11, 12, 16, 17, 18, 19)


@contextlib.contextmanager
def plain_precision():
    """float32 products without TF32, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ------------------------------------------------------------------ shapes

def _blocks(opt) -> List[tuple]:
    """(name, fin, fout, kind) of the generator's resblocks in call order;
    kind "enc" (one SPADE on the previous frames' encoder maps) or "cur"
    (one SPADE a current labelmap, keys sorted)."""
    base, lo, hi, step = opt["ngf_base"], opt["ngf_pow_outer"], opt["ngf_pow_inner"], opt["ngf_pow_step"]
    if (hi - lo) % step:
        raise ValueError("the widths must step from ngf_pow_outer to ngf_pow_inner exactly")
    out = []
    for i, p in enumerate(range(lo, hi, step)):
        out.append((f"encode_{i}", base ** p, base ** (p + step), "enc"))
    for i in range(opt["num_middle"]):
        out.append((f"middle_{i}", base ** hi, base ** hi, "cur"))
    for i, p in enumerate(range(hi, lo, -step)):
        out.append((f"decode_{i}", base ** p, base ** (p - step), "cur"))
    return out


def label_keys(opt) -> List[str]:
    return sorted(list(opt["person_inputs"]) + list(opt["cloth_inputs"]))


def enc_label_nc(opt) -> int:
    return LABEL_CHANNELS[opt["encoder_input"]] * max(opt["n_frames_total"] - 1, 1)


def _spade_specs(prefix, c, label_nc):
    return [(f"{prefix}.norm.running_mean", (c,), "running_mean"),
            (f"{prefix}.norm.running_var", (c,), "running_var"),
            (f"{prefix}.mlp_shared.weight", (NHID, label_nc, 3, 3), "kernel"),
            (f"{prefix}.mlp_shared.bias", (NHID,), "zero"),
            (f"{prefix}.mlp_gamma.weight", (c, NHID, 3, 3), "kernel"),
            (f"{prefix}.mlp_gamma.bias", (c,), "zero"),
            (f"{prefix}.mlp_beta.weight", (c, NHID, 3, 3), "kernel"),
            (f"{prefix}.mlp_beta.bias", (c,), "zero")]


def _norm_specs(prefix, c, kind, opt):
    if kind == "enc":
        return _spade_specs(prefix, c, enc_label_nc(opt))
    out = []
    for key in label_keys(opt):
        out += _spade_specs(f"{prefix}.spade_{key}", c, LABEL_CHANNELS[key])
    return out


def _spectral_specs(prefix, cout, cin, k, bias):
    out = [(f"{prefix}.weight", (cout, cin, k, k), "spectral")]
    if bias:
        out.append((f"{prefix}.bias", (cout,), "zero"))
    return out + [(f"{prefix}.u", (1, cout), "u"), (f"{prefix}.sigma", (), "one")]


def generator_specs(opt) -> list:
    """(name, shape, kind) of every generator tensor; kind: "kernel" (a
    conv weight), "spectral" (a spectrally normalized conv weight), "zero"
    (a bias), "u" (a spectral norm's power-iteration vector), "one",
    "running_mean", "running_var"."""
    ngf_out = opt["ngf_base"] ** opt["ngf_pow_outer"]
    num_prev = max(opt["n_frames_total"] - 1, 1)
    out_ch = 4 if opt["flow_warp"] else 3
    specs = [("encode_conv_in.weight", (ngf_out, 3 * num_prev, 3, 3), "kernel"),
             ("encode_conv_in.bias", (ngf_out,), "zero")]
    for name, fin, fout, kind in _blocks(opt):
        fmid = min(fin, fout)
        if fin != fout:
            specs += _norm_specs(f"{name}.norm_s", fin, kind, opt)
            specs += _spectral_specs(f"{name}.conv_s", fout, fin, 1, False)
        specs += _norm_specs(f"{name}.spade_0", fin, kind, opt)
        specs += _spectral_specs(f"{name}.conv_0", fmid, fin, 3, True)
        specs += _norm_specs(f"{name}.spade_1", fmid, kind, opt)
        specs += _spectral_specs(f"{name}.conv_1", fout, fmid, 3, True)
    specs += [("decode_conv_out.weight", (out_ch, ngf_out, 3, 3), "kernel"),
              ("decode_conv_out.bias", (out_ch,), "zero")]
    return specs


def _extraction_layers(input_nc, ngf):
    specs = [(input_nc, ngf, 4, 2)]
    cin = ngf
    for i in range(3):
        cout = 2 ** (i + 1) * ngf if 2 ** i * ngf < 512 else 512
        specs.append((cin, cout, 4, 2))
        cin = cout
    return specs + [(cin, 512, 3, 1), (512, 512, 3, 1)]


def _regression_layers(input_nc):
    return [(input_nc, 512, 4, 2), (512, 256, 4, 2), (256, 128, 3, 1), (128, 64, 3, 1)]


def _s2(n):
    return (n + 2 - 4) // 2 + 1


def gmm_specs(opt) -> list:
    """(name, shape, kind) of every GMM tensor; kinds as
    :func:`generator_specs`, plus "norm_weight" (a batch norm's scale) and
    "dense" (the regression's linear layer)."""
    fh, fw = opt["fine_height"] // 16, opt["fine_width"] // 16
    person_nc = LABEL_CHANNELS["agnostic"] + LABEL_CHANNELS["densepose"]
    specs = []

    def net(prefix, layers, n_bns):
        for i, (ci, co, k, _) in enumerate(layers):
            specs.extend([(f"{prefix}.convs.{i}.weight", (co, ci, k, k), "kernel"),
                          (f"{prefix}.convs.{i}.bias", (co,), "zero")])
        for i, (_, co, _, _) in enumerate(layers[:n_bns]):
            specs.extend([(f"{prefix}.bns.{i}.weight", (co,), "norm_weight"),
                          (f"{prefix}.bns.{i}.bias", (co,), "zero"),
                          (f"{prefix}.bns.{i}.running_mean", (co,), "running_mean"),
                          (f"{prefix}.bns.{i}.running_var", (co,), "running_var")])

    net("extractionA", _extraction_layers(person_nc, opt["ngf"]), 5)
    net("extractionB", _extraction_layers(3, opt["ngf"]), 5)
    net("regression", _regression_layers(fh * fw), 4)
    oh, ow = _s2(_s2(fh)), _s2(_s2(fw))
    n = 2 * opt["grid_size"] ** 2
    specs += [("regression.linear.weight", (n, 64 * oh * ow), "dense"),
              ("regression.linear.bias", (n,), "zero")]
    return specs


# ------------------------------------------------------------------ primitives

def conv(x, w, b=None, stride=1, padding=0):
    """NHWC input, OIHW weight, float32."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def quantize(v, bits, dims=None):
    """Symmetric quantization to 2**(bits-1) - 1 levels a side: (levels as
    float32, scale); one scale over ``v`` (``dims`` None) or one over each
    index of dim 0 (``dims`` the other dims)."""
    top = float(2 ** (bits - 1) - 1)
    amax = v.abs().amax() if dims is None else v.abs().amax(dim=dims)
    scale = amax / top + 1e-30
    s = scale if dims is None else scale.reshape(-1, *([1] * (v.dim() - 1)))
    return torch.clamp(torch.round(v / s), -top, top), scale


FP8_MAX = 448.0  # float8 e4m3's largest finite value


def fp8(v, dims=None):
    """``v`` rounded to float8 e4m3 and back to float32, with one scale over
    ``v`` (``dims`` None) or one over each index of dim 0 (``dims`` the
    other dims) that maps the abs-max to FP8_MAX."""
    amax = v.abs().amax() if dims is None else v.abs().amax(dim=dims)
    scale = amax / FP8_MAX + 1e-30
    s = scale if dims is None else scale.reshape(-1, *([1] * (v.dim() - 1)))
    return torch.clamp(v / s, -FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float() * s


def fp8conv(x, w, b, padding):
    """A conv with both operands rounded to float8 e4m3 (x per tensor, w
    per output channel), summed in float32."""
    return conv(fp8(x), fp8(w, dims=(1, 2, 3)), b, padding=padding)


def qconv3x3(x, w, b, bits):
    """The quantized 3x3 SAME conv: x per tensor, w per output channel,
    integer sums, ``acc * (s_x * s_w) + b``."""
    xq, sx = quantize(x, bits)
    wq, sw = quantize(w, bits, dims=(1, 2, 3))
    acc = conv(xq, wq, None, padding=1)
    out = acc * (sx * sw)
    return out if b is None else out + b


def spectral_weight(P, S, prefix, update: bool):
    """W / sigma with sigma from one power step from the stored ``u`` over
    the kernel viewed as a (k*k*cin, cout) matrix (flax SpectralNorm, as
    upstream's torch spectral_norm with one power iteration); with
    ``update`` the step's ``u`` is stored."""
    w = P[f"{prefix}.weight"]
    value = w.reshape(w.shape[0], -1).t()

    def l2n(v):
        return v * torch.rsqrt((v * v).sum() + EPS_SPECTRAL)

    u = S[f"{prefix}.u"]
    v0 = l2n(u @ value.t())
    u0 = l2n(v0 @ value)
    sigma = (v0 @ value @ u0.t())[0, 0]
    if update:
        S[f"{prefix}.u"] = u0
        S[f"{prefix}.sigma"] = sigma
    return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


def resize_nearest(seg, h, w):
    """Nearest resize of NHWC (src = floor(dst * in / out))."""
    if seg.shape[1:3] == (h, w):
        return seg
    return F.interpolate(seg.permute(0, 3, 1, 2), size=(h, w), mode="nearest").permute(0, 2, 3, 1)


def batch_norm(x, S, prefix, train: bool):
    """Parameter-free batch norm over (B, H, W); in training from the
    batch's statistics (biased variance) and updating the running ones."""
    if train:
        mean = x.mean(dim=(0, 1, 2))
        var = (x * x).mean(dim=(0, 1, 2)) - mean * mean
        rm, rv = f"{prefix}.running_mean", f"{prefix}.running_var"
        S[rm] = MOMENTUM * S[rm] + (1 - MOMENTUM) * mean
        S[rv] = MOMENTUM * S[rv] + (1 - MOMENTUM) * var
    else:
        mean, var = S[f"{prefix}.running_mean"], S[f"{prefix}.running_var"]
    return (x - mean) * torch.rsqrt(var + EPS_NORM)


def spade(x, seg, P, S, prefix, train, bits):
    """SPADE: norm(x) * (1 + gamma) + beta, gamma and beta from the segmap
    through a shared 3x3 conv + ReLU and two 3x3 convs."""
    seg = resize_nearest(seg, x.shape[1], x.shape[2])
    normalized = batch_norm(x, S, f"{prefix}.norm", train)
    wg, bg = P[f"{prefix}.mlp_gamma.weight"], P[f"{prefix}.mlp_gamma.bias"]
    wb, bb = P[f"{prefix}.mlp_beta.weight"], P[f"{prefix}.mlp_beta.bias"]
    if bits == "fp8" and not train:
        h = F.relu(fp8conv(seg, P[f"{prefix}.mlp_shared.weight"], P[f"{prefix}.mlp_shared.bias"], 1))
        gb = fp8conv(h, torch.cat([wg, wb]), torch.cat([bg, bb]), 1)
        return normalized * (1.0 + gb[..., :wg.shape[0]]) + gb[..., wg.shape[0]:]
    h = F.relu(conv(seg, P[f"{prefix}.mlp_shared.weight"], P[f"{prefix}.mlp_shared.bias"], padding=1))
    if bits and not train:
        gb = qconv3x3(h, torch.cat([wg, wb]), torch.cat([bg, bb]), bits)
        gamma, beta = gb[..., :wg.shape[0]], gb[..., wg.shape[0]:]
    else:
        gamma, beta = conv(h, wg, bg, padding=1), conv(h, wb, bb, padding=1)
    return normalized * (1.0 + gamma) + beta


def norm_layer(x, labels, P, S, prefix, kind, train, opt, bits):
    if kind == "enc":
        return spade(x, labels, P, S, prefix, train, bits)
    for key in label_keys(opt):
        x = spade(x, labels[key], P, S, f"{prefix}.spade_{key}", train, bits)
    return x


def gated(cin, cout, k, opt) -> bool:
    return k >= 3 and min(cin, cout) >= opt["int8_min_channels"]


def sconv(x, P, S, prefix, train, opt, bits):
    """A spectrally normalized conv (3x3 SAME or 1x1), quantized at eval
    where the gate admits it."""
    w = spectral_weight(P, S, prefix, update=train)
    b = P.get(f"{prefix}.bias")
    k = w.shape[-1]
    if bits == "fp8" and not train:
        return fp8conv(x, w, b, k // 2)
    if bits and not train and gated(w.shape[1], w.shape[0], k, opt):
        return qconv3x3(x, w, b, bits)
    return conv(x, w, b, padding=k // 2)


def pconv(x, P, prefix, train, opt, bits):
    """A plain 3x3 SAME conv, quantized at eval where the gate admits it."""
    w, b = P[f"{prefix}.weight"], P[f"{prefix}.bias"]
    if bits == "fp8" and not train:
        return fp8conv(x, w, b, 1)
    if bits and not train and gated(w.shape[1], w.shape[0], 3, opt):
        return qconv3x3(x, w, b, bits)
    return conv(x, w, b, padding=1)


def resblock(x, labels, P, S, name, fin, fout, kind, train, opt, bits):
    if fin != fout:
        xs = norm_layer(x, labels, P, S, f"{name}.norm_s", kind, train, opt, bits)
        xs = sconv(xs, P, S, f"{name}.conv_s", train, opt, bits)
    else:
        xs = x
    dx = norm_layer(x, labels, P, S, f"{name}.spade_0", kind, train, opt, bits)
    dx = sconv(F.leaky_relu(dx, LEAKY), P, S, f"{name}.conv_0", train, opt, bits)
    dx = norm_layer(dx, labels, P, S, f"{name}.spade_1", kind, train, opt, bits)
    dx = sconv(F.leaky_relu(dx, LEAKY), P, S, f"{name}.conv_1", train, opt, bits)
    return xs + dx


def generator(P, S, window, prev_maps, current, opt, train=False, bits=None):
    """One generator call: window (B, N-1, H, W, 3) of previous frames,
    prev_maps (B, N-1, H, W, enc) of their encoder maps, current
    {label: (B, H, W, c)}. Returns (B, H, W, 3 or 4)."""
    B, n, H, W, _ = window.shape
    x = window.movedim(1, -2).reshape(B, H, W, 3 * n)
    enc = prev_maps.movedim(1, -2).reshape(B, H, W, -1)
    x = pconv(x, P, "encode_conv_in", train, opt, bits)
    for name, fin, fout, kind in _blocks(opt):
        if name.startswith("decode"):
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        x = resblock(x, enc if kind == "enc" else current, P, S, name, fin, fout, kind,
                     train, opt, bits)
        if name.startswith("encode"):
            x = x[:, ::2, ::2]
    return pconv(x, P, "decode_conv_out", train, opt, bits)


# ------------------------------------------------------------------ resampling

def grid_sample(img, grid, padding_mode, align_corners):
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode=padding_mode, align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def resample2d(img, flow):
    """out[b, y, x] = img[b, y + flow_y, x + flow_x], bilinear, border
    (flownet2's Resample2d)."""
    B, H, W, _ = img.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=img.device),
                            torch.arange(W, dtype=torch.float32, device=img.device), indexing="ij")
    gx = 2.0 * (xs + flow[..., 0]) / (W - 1) - 1.0
    gy = 2.0 * (ys + flow[..., 1]) / (H - 1) - 1.0
    return grid_sample(img, torch.stack([gx, gy], dim=-1), "border", True)


# ------------------------------------------------------------------ preprocessing

def _triangle_weights(n_in, n_out):
    """(n_in, n_out) weights of an antialiased linear resize on half-pixel
    centres (a triangle kernel widened by the downscale factor, columns
    normalised), in float32 as the upstream's resize computes them."""
    f32 = np.float32
    inv = f32(n_in / n_out)
    scale = max(inv, f32(1.0))
    centre = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(centre[None, :] - np.arange(n_in, dtype=f32)[:, None]) / scale)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize(img, h, w):
    wy = torch.from_numpy(_triangle_weights(img.shape[-2], h)).to(img.device)
    wx = torch.from_numpy(_triangle_weights(img.shape[-1], w)).to(img.device)
    return torch.einsum("...yw,wx->...yx", torch.einsum("...hw,hy->...yw", img, wy), wx)


def features(raw, opt) -> Dict[str, torch.Tensor]:
    """The labelmaps the clip reads, (B, N, H, W, c) float32 in [-1, 1]:
    agnostic (blurred body silhouette, head crop), densepose, flow, cloth."""
    H, W = opt["fine_height"], opt["fine_width"]

    def rgb(u8):
        return u8.float() / 127.5 - 1.0

    def valid(v):
        return v[..., None, None, None]

    parse = raw["parse_u8"]
    sil = (parse > 0).float() * 255.0
    sil = torch.clamp(torch.round(_resize(sil, H // 16, W // 16)), 0.0, 255.0)
    sil = torch.clamp(torch.round(_resize(sil, H, W)), 0.0, 255.0) / 127.5 - 1.0
    head = torch.zeros(parse.shape, dtype=torch.float32, device=parse.device)
    for label in HEAD_LABELS:
        head = head + (parse == label).float()
    head = head[..., None]
    image = rgb(raw["image_u8"])
    return {
        "agnostic": torch.cat([sil[..., None], image * head - (1.0 - head)], dim=-1),
        "densepose": rgb(raw["densepose_u8"]) * valid(raw["densepose_valid"]),
        "flow": (raw["flow_raw"].float() * 2.0 - 1.0) * valid(raw["flow_valid"]),
        "cloth": rgb(raw["cloth_u8"]),
    }


# ------------------------------------------------------------------ GMM

def _bn_eval(x, P, prefix):
    a = torch.rsqrt(P[f"{prefix}.running_var"] + EPS_NORM) * P[f"{prefix}.weight"]
    return (x - P[f"{prefix}.running_mean"]) * a + P[f"{prefix}.bias"]


def _l2n(f):
    return f / torch.sqrt((f * f).sum(dim=-1, keepdim=True) + 1e-6)


def _extract(x, P, prefix, n_in):
    for i, (_, _, k, s) in enumerate(_extraction_layers(n_in, 1)):
        x = F.relu(conv(x, P[f"{prefix}.convs.{i}.weight"], P[f"{prefix}.convs.{i}.bias"], s, 1))
        if i < 5:
            x = _bn_eval(x, P, f"{prefix}.bns.{i}")
    return x


def tps_grid(theta, opt):
    """Thin-plate-spline sampling grid (B, H, W, 2) from theta (B, 2N):
    control points on a regular lattice of [-1, 1]^2 offset by theta (X
    first), U(d^2) = d^2 log d^2 with 0 taken as 1 (upstream TpsGridGen)."""
    g, H, W = opt["grid_size"], opt["fine_height"], opt["fine_width"]
    axis = np.linspace(-1, 1, g)
    PY, PX = np.meshgrid(axis, axis)
    PX, PY = PX.reshape(-1), PY.reshape(-1)
    N = PX.shape[0]

    def u(d2):
        d2 = np.where(d2 == 0, 1.0, d2)
        return d2 * np.log(d2)

    L = np.zeros((N + 3, N + 3))
    L[:N, :N] = u((PX[:, None] - PX[None]) ** 2 + (PY[:, None] - PY[None]) ** 2)
    P3 = np.stack([np.ones(N), PX, PY], axis=1)
    L[:N, N:], L[N:, :N] = P3, P3.T
    Li = np.linalg.inv(L)[:, :N]
    gx, gy = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, H))
    px, py = gx.reshape(-1, 1), gy.reshape(-1, 1)
    basis = np.concatenate([u((px - PX[None]) ** 2 + (py - PY[None]) ** 2), np.ones_like(px), px, py], axis=1)
    dev = theta.device
    Li = torch.from_numpy(Li.astype(np.float32)).to(dev)
    basis = torch.from_numpy(basis.astype(np.float32)).to(dev)
    base = torch.from_numpy(np.stack([PX, PY], axis=1).astype(np.float32)).to(dev)
    B = theta.shape[0]
    q = theta.reshape(B, 2, N).transpose(1, 2) + base[None]
    return torch.einsum("pk,bkd->bpd", basis, torch.einsum("kn,bnd->bkd", Li, q)).reshape(B, H, W, 2)


def gmm_warp(P, feats, opt):
    """The last frame's cloth warped by the GMM's TPS grid (border)."""
    person = torch.cat([feats["agnostic"][:, -1], feats["densepose"][:, -1]], dim=-1)
    cloth = feats["cloth"][:, -1]
    fa = _l2n(_extract(person, P, "extractionA", person.shape[-1]))
    fb = _l2n(_extract(cloth, P, "extractionB", 3))
    B, h, w, c = fa.shape
    a = fa.permute(0, 2, 1, 3).reshape(B, w * h, c)
    corr = torch.bmm(fb.reshape(B, h * w, c), a.transpose(1, 2)).reshape(B, h, w, w * h)
    x = corr
    for i, (_, _, k, s) in enumerate(_regression_layers(1)):
        x = conv(x, P[f"regression.convs.{i}.weight"], P[f"regression.convs.{i}.bias"], s, 1)
        x = F.relu(_bn_eval(x, P, f"regression.bns.{i}"))
    x = x.permute(0, 3, 1, 2).reshape(B, -1)
    theta = torch.tanh(F.linear(x, P["regression.linear.weight"], P["regression.linear.bias"]))
    return grid_sample(cloth, tps_grid(theta, opt), "border", False)


# ------------------------------------------------------------------ the clip

def _current(feats, opt, t):
    return {k: feats[k][:, t] for k in label_keys(opt)}


def _prev_maps(enc, t, n):
    """The encoder maps that frame t's call reads: zeros for the N-1-t
    oldest slots, then the maps of frames N-1-t .. N-2."""
    k = (n - 1) - t
    return torch.cat([torch.zeros_like(enc[:, :k]), enc[:, k:n - 1]], dim=1)


def warm_up(P, feats, opt, rollouts: int = 3) -> Dict[str, torch.Tensor]:
    """The served model's set-up: ``rollouts`` train-mode clips (batch
    statistics, running statistics and spectral ``u`` updated at every
    call), each frame fed back into the window. Returns the state (running
    statistics, ``u``, ``sigma``)."""
    S = {k: v.clone() for k, v in P.items()
         if k.endswith((".running_mean", ".running_var", ".u", ".sigma"))}
    n = opt["n_frames_total"]
    enc = feats[opt["encoder_input"]]
    for _ in range(rollouts):
        window = torch.zeros_like(feats["cloth"][:, :n - 1])
        for t in range(n):
            out = generator(P, S, window, _prev_maps(enc, t, n), _current(feats, opt, t), opt, train=True)
            fake = _composite(out, window, feats, t, opt)
            window = torch.cat([window[:, 1:], fake[:, None]], dim=1)
    return S


def _composite(out, window, feats, t, opt):
    fake = out[..., :3]
    if not opt["flow_warp"]:
        return fake
    wmask = out[..., 3:]
    return (1 - wmask) * resample2d(window[:, -1], feats["flow"][:, t]) + wmask * fake


def clip_frames(P, S, raw, opt, served: Optional[torch.Tensor] = None, bits=None):
    """The eval clip's frames (B, N, H, W, 3) and, for each frame, the part
    that the flow warp shares with the previous frame (the warped previous
    frame times 1 - mask; zeros without flow warp).

    With ``served`` (the program's frames) each frame is computed from the
    served frames before it, as the served loop fed them back (teacher
    forcing), so a frame is judged on the same inputs as the program's;
    without it the clip runs on its own frames."""
    feats = features(raw, opt)
    warped = gmm_warp(P, feats, opt)
    cloth = feats["cloth"].clone()
    cloth[:, -1] = warped
    feats["cloth"] = cloth
    n = opt["n_frames_total"]
    enc = feats[opt["encoder_input"]]
    window = torch.zeros_like(feats["cloth"][:, :n - 1])
    frames, shared = [], []
    for t in range(n):
        out = generator(P, S, window, _prev_maps(enc, t, n), _current(feats, opt, t), opt, bits=bits)
        fake = _composite(out, window, feats, t, opt)
        if opt["flow_warp"]:
            shared.append((1 - out[..., 3:]) * resample2d(window[:, -1], feats["flow"][:, t]))
        else:
            shared.append(torch.zeros_like(fake))
        frames.append(fake)
        nxt = served[:, t].float() if served is not None else fake
        window = torch.cat([window[:, 1:], nxt[:, None]], dim=1)
    return torch.stack(frames, dim=1), torch.stack(shared, dim=1)
