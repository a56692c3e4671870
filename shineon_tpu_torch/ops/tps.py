"""Thin-plate-spline grid generation (counterpart of shineon_tpu/ops/tps.py).

The per-pixel radial basis [U_1..U_N, 1, X, Y] over the output grid and the
inverse TPS system matrix are computed once in numpy; a grid is then
``basis @ (L^-1[:, :N] @ Q)``, two small f32 products per sample.

Numerics follow the reference (models/networks/cpvton/warp.py:116-318):
squared distances of exactly 0 become 1 before ``d^2 log d^2``, and the
control points come from an 'xy' meshgrid with P_Y assigned first.
"""

from __future__ import annotations

import numpy as np
import torch


def tps_control_points(grid_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(P_X, P_Y), each (grid_size**2,), on a regular lattice in [-1, 1]^2."""
    axis_coords = np.linspace(-1, 1, grid_size)
    P_Y, P_X = np.meshgrid(axis_coords, axis_coords)
    return P_X.reshape(-1).astype(np.float32), P_Y.reshape(-1).astype(np.float32)


def _u(dist_squared: np.ndarray) -> np.ndarray:
    """U(d^2) = d^2 log d^2, with d^2 == 0 replaced by 1."""
    d2 = np.where(dist_squared == 0, 1.0, dist_squared)
    return d2 * np.log(d2)


def tps_l_inverse(P_X: np.ndarray, P_Y: np.ndarray) -> np.ndarray:
    """Inverse of the (N+3, N+3) TPS system matrix L."""
    N = P_X.shape[0]
    d2 = (P_X[:, None] - P_X[None, :]) ** 2 + (P_Y[:, None] - P_Y[None, :]) ** 2
    P = np.stack([np.ones(N, np.float32), P_X, P_Y], axis=1)
    L = np.zeros((N + 3, N + 3), np.float32)
    L[:N, :N] = _u(d2)
    L[:N, N:] = P
    L[N:, :N] = P.T
    return np.linalg.inv(L).astype(np.float32)


def tps_basis(out_h: int, out_w: int, P_X: np.ndarray, P_Y: np.ndarray) -> np.ndarray:
    """(H*W, N+3) basis [U_1..U_N, 1, X, Y] over meshgrid(linspace(-1, 1, W),
    linspace(-1, 1, H))."""
    grid_X, grid_Y = np.meshgrid(np.linspace(-1, 1, out_w), np.linspace(-1, 1, out_h))
    px = grid_X.reshape(-1, 1).astype(np.float32)
    py = grid_Y.reshape(-1, 1).astype(np.float32)
    d2 = (px - P_X[None, :]) ** 2 + (py - P_Y[None, :]) ** 2
    return np.concatenate([_u(d2), np.ones_like(px), px, py], axis=1).astype(np.float32)


class TpsGridGen(torch.nn.Module):
    """theta (B, 2N) -> sampling grid (B, H, W, 2). theta's first N entries
    offset the control points' X, the last N their Y."""

    def __init__(self, out_h: int = 256, out_w: int = 192, grid_size: int = 3):
        super().__init__()
        self.out_h, self.out_w = out_h, out_w
        P_X, P_Y = tps_control_points(grid_size)
        self.N = P_X.shape[0]
        # only the first N columns of L^-1 meet the non-zero part of [Q; 0]
        solve = tps_l_inverse(P_X, P_Y)[:, : self.N]
        self.register_buffer("solve", torch.from_numpy(solve), persistent=False)
        self.register_buffer(
            "basis", torch.from_numpy(tps_basis(out_h, out_w, P_X, P_Y)),
            persistent=False,
        )
        self.register_buffer(
            "p_base", torch.from_numpy(np.stack([P_X, P_Y], axis=1)),
            persistent=False,
        )

    def forward(self, theta: torch.Tensor) -> torch.Tensor:
        B = theta.shape[0]
        q = theta.float().reshape(B, 2, self.N).transpose(1, 2) + self.p_base[None]
        weights = torch.einsum("kn,bnd->bkd", self.solve, q)
        flat = torch.einsum("pk,bkd->bpd", self.basis, weights)
        return flat.reshape(B, self.out_h, self.out_w, 2)
