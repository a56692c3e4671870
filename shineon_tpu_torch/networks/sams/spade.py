"""SPADE normalization + AnySpadeResBlock, NHWC (counterpart of
shineon_tpu/networks/sams/spade.py).

At eval every 3x3 SPADE site runs through the fused chain kernel
(:func:`shineon_tpu_torch.ops.fused_spade.fused_multispade_modulate`); in
training the reference formulation runs conv by conv. Modules built with
``int8=True`` serve int8 at eval (the JAX package's ``SHINEON_INT8_SPADE``
mode): every fused chain is quantized, and every resblock conv that
:func:`int8_conv_profitable` admits runs the int8 conv.
"""

from __future__ import annotations

import re
import weakref
from typing import Optional

import torch
from torch import nn

from shineon_tpu_torch import tracing
from shineon_tpu_torch.networks.activation import (
    get_activation_fn,
    get_resblock_activation_fn,
)
from shineon_tpu_torch.networks.layers import Conv2d, EvalCache
from shineon_tpu_torch.networks.normalization import (
    SpectralConv2d,
    SyncBatchNorm,
    instance_norm,
)
from shineon_tpu_torch.ops.fused_spade import (
    fused_multispade_modulate,
    kernel_segmap,
    pack_weights,
    plan_chain,
)


def int8_conv_profitable(ks: int, cin: int, cout: int, min_channels: int = 64) -> bool:
    """The JAX package's int8 serving gate: a kernel of at least 3x3 and both
    channel counts >= ``min_channels`` (its ``SHINEON_INT8_MIN_CH``, default
    64; its spatial gate is off by default and not kept)."""
    return ks >= 3 and min(cin, cout) >= min_channels


def parse_spade_config(config_text: str) -> tuple[str, int]:
    """'spadesyncbatch3x3' -> ('syncbatch', 3)."""
    if not config_text.startswith("spade"):
        raise ValueError(f"not a SPADE config: {config_text!r}")
    parsed = re.search(r"spade(\D+)(\d)x\d", config_text)
    norm_type = str(parsed.group(1))
    if norm_type not in ("instance", "syncbatch", "batch"):
        raise ValueError(f"SPADE config names an unknown param-free norm: {norm_type}")
    return norm_type, int(parsed.group(2))


def resize_nearest(segmap: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """torch ``F.interpolate(mode="nearest")`` on NHWC: src = floor(dst * in/out)."""
    in_h, in_w = segmap.shape[-3], segmap.shape[-2]
    if (in_h, in_w) == (h, w):
        return segmap
    if in_h % h == 0 and in_w % w == 0:
        # integer factors: floor(dst * k) = dst * k, a strided view
        return segmap[..., :: in_h // h, :: in_w // w, :]
    dev = segmap.device
    rows = torch.floor(torch.arange(h, dtype=torch.float32, device=dev) * (in_h / h)).long()
    cols = torch.floor(torch.arange(w, dtype=torch.float32, device=dev) * (in_w / w)).long()
    return segmap.index_select(-3, rows).index_select(-2, cols)


class SPADE(nn.Module):
    """Param-free norm + segmap-conditioned (1 + gamma, beta) modulation.

    ``forward`` is the reference formulation, conv by conv (``hidden`` skips
    the mlp_shared conv when a parent computed it). ``fused_args`` returns
    the chain arguments ``(ab, seg, wsh, bsh, wgb, bgb)`` of this label for
    the kernel; ``forward_fused`` runs the kernel on this label alone (see
    :func:`fused_chain`), quantized when built with ``int8``. A chain's
    first SPADE keeps its packed weights and its launch plan.
    """

    def __init__(self, norm_nc: int, label_nc: int, config_text: str = "spadeinstance3x3",
                 activation: str = "relu", nhidden: int = 128,
                 dtype: Optional[torch.dtype] = None, int8: bool = False):
        super().__init__()
        self.norm_type, ks = parse_spade_config(config_text)
        self.ks, self.activation, self.dtype, self.int8 = ks, activation, dtype, int8
        if self.norm_type != "instance":
            self.norm = SyncBatchNorm(norm_nc, affine=False, dtype=dtype)
        pad = ks // 2
        self.mlp_shared = Conv2d(label_nc, nhidden, ks, padding=pad, dtype=dtype)
        self.mlp_gamma = Conv2d(nhidden, norm_nc, ks, padding=pad, dtype=dtype)
        self.mlp_beta = Conv2d(nhidden, norm_nc, ks, padding=pad, dtype=dtype)
        self._packed = EvalCache()
        self._plan = None  # (key, the tensors it was made from, ChainPlan): chain_plan

    def _normalize(self, x, train, return_affine=False):
        if self.norm_type == "instance":
            return instance_norm(x, return_affine=return_affine, dtype=self.dtype)
        return self.norm(x, use_running_average=not train, return_affine=return_affine)

    def forward(self, x, segmap, train: bool = True, hidden: Optional[torch.Tensor] = None):
        segmap = resize_nearest(segmap, x.shape[-3], x.shape[-2]).to(x.dtype)
        normalized = self._normalize(x, train)
        h = hidden
        if h is None:
            h = get_activation_fn(self.activation)(self.mlp_shared(segmap))
        gamma = self.mlp_gamma(h)
        beta = self.mlp_beta(h)
        return normalized * (1.0 + gamma) + beta

    def gb_params(self):
        """[gamma | beta] conv weight (2C, nhidden, k, k) and bias (2C,)."""
        w = torch.cat([self.mlp_gamma.weight, self.mlp_beta.weight], dim=0)
        b = torch.cat([self.mlp_gamma.bias, self.mlp_beta.bias], dim=0)
        return w, b

    def state_tensors(self):
        """Every parameter and buffer the eval chain reads: the three convs'
        and the norm's running statistics (read from the modules' own
        tables, several times faster than ``parameters()``)."""
        mods = (self.mlp_shared, self.mlp_gamma, self.mlp_beta)
        if self.norm_type != "instance":
            mods += (self.norm,)
        return [t for m in mods for t in (*m._parameters.values(), *m._buffers.values())
                if t is not None]

    def folded_norm(self, x):
        """Eval: the norm folded with running (or instance) statistics, as
        (B, 2C) f32 [a | b] with norm(x) = x * a + b."""
        B, C = x.shape[0], x.shape[-1]
        a, b = self._normalize(x, train=False, return_affine=True)
        return torch.cat([a.expand(B, C), b.expand(B, C)], dim=-1).float()

    def fused_args(self, x, segmap):
        """Eval: the norm folded with running (or instance) statistics."""
        ab = self.folded_norm(x)
        seg = resize_nearest(segmap, x.shape[-3], x.shape[-2]).to(x.dtype)
        wgb, bgb = self.gb_params()
        return ab, seg, self.mlp_shared.weight, self.mlp_shared.bias, wgb, bgb

    def forward_fused(self, x, segmap):
        """Eval: this label alone, as a one-label chain."""
        return fused_chain([self], x, [segmap])


def chain_plan(spades, x):
    """The launch plan of the chain of ``spades`` for x's shape, dtype and
    device (:func:`~shineon_tpu_torch.ops.fused_spade.plan_chain`): packed
    weights, the norms folded with their running statistics, the checked
    operands. Kept on the first SPADE and made anew when a parameter or
    buffer of the chain is replaced or modified in place (data pointer or
    version counter, as ``EvalCache``), or x's shape, dtype or device
    changes. None for a chain with an instance norm, whose fold depends on
    x. Counts ``fused_chain.plan_builds`` or ``plan_hits``."""
    if any(s.norm_type == "instance" for s in spades):
        return None
    first = spades[0]
    state = [t for s in spades for t in s.state_tensors()]
    key = (tuple((t.data_ptr(), t._version) for t in state), tuple(x.shape), x.dtype,
           x.device, first.int8, first.activation)
    kept = first._plan
    if kept is not None and kept[0] == key:
        fused_chain.plan_hits += 1
        return kept[2]

    def pack():
        wgbs, bgbs = zip(*(s.gb_params() for s in spades))
        return pack_weights([s.mlp_shared.weight for s in spades],
                            [s.mlp_shared.bias for s in spades], wgbs, bgbs, x.dtype,
                            first.int8)

    packed = first._packed.get([p for s in spades for p in s.parameters()],
                               (x.dtype, first.int8), pack)
    ab = torch.stack([s.folded_norm(x) for s in spades], dim=1)
    plan = plan_chain(x, ab, packed, first.activation)
    # the plan holds its tensors: no new tensor can take a freed one's address
    first._plan = (key, state, plan)
    fused_chain.plan_builds += 1
    return plan


class SegmapMemo:
    """The chains' segmap operands (``kernel_segmap`` of the labelmaps
    resized to a site's resolution) by their labelmaps, resolution and
    dtype: the sites of a frame at one resolution share one. An entry holds
    a weak reference to each labelmap and its version counter, so it
    matches only the same live tensors unmodified; an entry whose labelmap
    is gone is dropped at the next build. Counts ``fused_chain.segmap_builds``
    or ``segmap_hits``."""

    def __init__(self, size: int = 64):
        self.size = size  # entries kept at most, the oldest dropped first
        self._entries = {}  # key -> (weak references, versions, operand)

    def get(self, segmaps, h: int, w: int, dtype) -> torch.Tensor:
        key = (tuple(map(id, segmaps)), h, w, dtype)
        versions = tuple(m._version for m in segmaps)
        entry = self._entries.get(key)
        if (entry is not None and entry[1] == versions
                and all(r() is m for r, m in zip(entry[0], segmaps))):
            fused_chain.segmap_hits += 1
            return entry[2]
        seg = kernel_segmap([resize_nearest(m, h, w).to(dtype) for m in segmaps], dtype)
        for k in [k for k, e in self._entries.items() if any(r() is None for r in e[0])]:
            del self._entries[k]
        self._entries[key] = (tuple(weakref.ref(m) for m in segmaps), versions, seg)
        while len(self._entries) > self.size:
            del self._entries[next(iter(self._entries))]
        fused_chain.segmap_builds += 1
        return seg


_segmaps = SegmapMemo()


def fused_chain(spades, x, segmaps):
    """Eval: the SPADEs applied to x in turn as ONE kernel call, each norm
    folded with its running statistics (instance statistics only in a chain
    of one: they depend on the chain's running value), quantized if the
    SPADEs were built with ``int8``. On the card outside autograd a chain
    of running-statistics norms launches from its cached plan
    (:func:`chain_plan`) on a shared segmap operand (:class:`SegmapMemo`);
    otherwise the chain's weights are packed once and kept on its first
    SPADE until a weight changes (on the card: on the CPU the chain takes
    its plain version, which reads the OIHW weights), and the call goes
    through the autograd Function. A span, ``spade.chain``."""
    with tracing.span("spade.chain"):
        cached = x.is_cuda and not torch.is_grad_enabled()
        plan = chain_plan(spades, x) if cached else None
        if plan is not None:
            seg = _segmaps.get(segmaps, x.shape[-3], x.shape[-2], x.dtype)
            # through the wrapper, whose (x, ab, segs) a patched stand-in
            # such as benchmark/faults.py's no_modulation still reads
            return fused_multispade_modulate(x, plan.ab, segmaps, plan=plan, seg=seg)
        per_label = [s.fused_args(x, m) for s, m in zip(spades, segmaps)]
        abs_, segs, wshs, bshs, wgbs, bgbs = zip(*per_label)
        quantized = spades[0].int8
        packed = None
        if cached:
            packed = spades[0]._packed.get(
                [p for s in spades for p in s.parameters()], (x.dtype, quantized),
                lambda: pack_weights(wshs, bshs, wgbs, bgbs, x.dtype, quantized),
            )
        return fused_multispade_modulate(
            x, torch.stack(abs_, dim=1), segs, wshs, bshs, wgbs, bgbs,
            act_name=spades[0].activation, packed=packed, quantized=quantized,
        )


fused_chain.plan_builds = 0
fused_chain.plan_hits = 0
fused_chain.segmap_builds = 0
fused_chain.segmap_hits = 0


class AnySpadeResBlock(nn.Module):
    """SPADE ResNet block (reference spade.py:106-192). ``make_spade(channels)``
    builds each normalization sub-module (SPADE or MultiSpade);
    spectral norm wraps the convs when "spectral" is in ``norm_G``. At eval a
    plain SPADE runs fused; a MultiSpade fuses its own chain. With ``int8``
    the convs that :func:`int8_conv_profitable` admits run int8 at eval."""

    def __init__(self, fin: int, fout: int, norm_G: str, make_spade,
                 activation: str = "relu", dtype: Optional[torch.dtype] = None,
                 int8: bool = False, int8_min_channels: int = 64):
        super().__init__()
        self.learned_shortcut = fin != fout
        fmiddle = min(fin, fout)
        spectral = "spectral" in norm_G
        self.actvn = get_resblock_activation_fn(activation)

        def conv(cin, cout, ksize, bias):
            cls = SpectralConv2d if spectral else Conv2d
            q = int8 and int8_conv_profitable(ksize, cin, cout, int8_min_channels)
            return cls(cin, cout, ksize, padding=ksize // 2, bias=bias, dtype=dtype, int8=q)

        if self.learned_shortcut:
            self.norm_s = make_spade(fin)
            self.conv_s = conv(fin, fout, 1, False)
        self.spade_0 = make_spade(fin)
        self.conv_0 = conv(fin, fmiddle, 3, True)
        self.spade_1 = make_spade(fmiddle)
        self.conv_1 = conv(fmiddle, fout, 3, True)

    @staticmethod
    def _conv(layer, h, train, update_stats):
        if isinstance(layer, SpectralConv2d):
            return layer(h, update_stats=update_stats, quantize=not train)
        return layer(h, quantize=not train)

    @staticmethod
    def _spade(module, h, seg, train):
        if not train and isinstance(module, SPADE) and module.ks == 3:
            return module.forward_fused(h, seg)
        return module(h, seg, train=train)

    def forward(self, x, seg, train: bool = True, update_stats: bool = False):
        with tracing.span("sams.resblock"):
            if self.learned_shortcut:
                x_s = self._conv(self.conv_s, self._spade(self.norm_s, x, seg, train), train,
                                 update_stats)
            else:
                x_s = x
            dx = self._spade(self.spade_0, x, seg, train)
            dx = self._conv(self.conv_0, self.actvn(dx), train, update_stats)
            dx = self._spade(self.spade_1, dx, seg, train)
            dx = self._conv(self.conv_1, self.actvn(dx), train, update_stats)
            return x_s + dx

