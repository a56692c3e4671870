"""GMM (Geometric Matching Module), NHWC (counterpart of
shineon_tpu/networks/cpvton/warp.py)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from shineon_tpu_torch.networks.layers import Conv2d, Dense
from shineon_tpu_torch.networks.normalization import SyncBatchNorm
from shineon_tpu_torch.ops import TpsGridGen, feature_l2_norm, global_correlation


class FeatureExtraction(nn.Module):
    """Stride-2 4x4 convs (ngf doubling, capped at 512) then two 3x3 512
    convs; conv -> relu -> batch norm, the last conv without norm."""

    def __init__(self, input_nc: int, ngf: int = 64, n_layers: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        specs = [(input_nc, ngf, 4, 2)]
        cin = ngf
        for i in range(n_layers):
            cout = 2 ** (i + 1) * ngf if 2 ** i * ngf < 512 else 512
            specs.append((cin, cout, 4, 2))
            cin = cout
        specs += [(cin, 512, 3, 1), (512, 512, 3, 1)]
        self.convs = nn.ModuleList(
            Conv2d(ci, co, k, stride=s, padding=1, dtype=dtype) for ci, co, k, s in specs
        )
        self.bns = nn.ModuleList(
            SyncBatchNorm(co, dtype=dtype) for _, co, _, _ in specs[:-1]
        )

    def forward(self, x, train: bool = False):
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            if i < len(self.bns):
                x = self.bns[i](x, use_running_average=not train)
        return x


def _stride2_out(n: int) -> int:
    return (n + 2 - 4) // 2 + 1


class FeatureRegression(nn.Module):
    """Correlation map -> theta: two stride-2 convs and two 3x3 convs
    (conv -> batch norm -> relu), NCHW-order flatten, dense, tanh (f32)."""

    def __init__(self, input_nc: int, feat_hw, output_dim: int = 6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        fh, fw = feat_hw
        if fh < 8 or fw < 6:
            raise ValueError(
                "FeatureRegression needs a correlation map of at least 8x6 "
                f"(fine size >= 128x96); got spatial {fh}x{fw}."
            )
        specs = [(input_nc, 512, 4, 2), (512, 256, 4, 2), (256, 128, 3, 1), (128, 64, 3, 1)]
        self.convs = nn.ModuleList(
            Conv2d(ci, co, k, stride=s, padding=1, dtype=dtype) for ci, co, k, s in specs
        )
        self.bns = nn.ModuleList(SyncBatchNorm(co, dtype=dtype) for _, co, _, _ in specs)
        oh, ow = _stride2_out(_stride2_out(fh)), _stride2_out(_stride2_out(fw))
        self.linear = Dense(64 * oh * ow, output_dim, dtype=dtype)

    def forward(self, x, train: bool = False):
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(conv(x), use_running_average=not train))
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)  # torch (C, H, W) order
        # theta feeds TPS sampling coordinates: keep full precision
        return torch.tanh(self.linear(x)).float()


class GMM(nn.Module):
    """Person/cloth features -> correlation -> theta -> TPS sampling grid."""

    def __init__(self, person_nc: int, cloth_nc: int, fine_height: int = 256,
                 fine_width: int = 192, grid_size: int = 5, ngf: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        feat_h, feat_w = fine_height // 16, fine_width // 16
        self.extractionA = FeatureExtraction(person_nc, ngf=ngf, dtype=dtype)
        self.extractionB = FeatureExtraction(cloth_nc, ngf=ngf, dtype=dtype)
        self.regression = FeatureRegression(
            feat_h * feat_w, (feat_h, feat_w), output_dim=2 * grid_size ** 2, dtype=dtype,
        )
        self.tps = TpsGridGen(fine_height, fine_width, grid_size)

    def forward(self, person, cloth, train: bool = False):
        feat_a = feature_l2_norm(self.extractionA(person, train=train))
        feat_b = feature_l2_norm(self.extractionB(cloth, train=train))
        theta = self.regression(global_correlation(feat_a, feat_b), train=train)
        return self.tps(theta), theta
