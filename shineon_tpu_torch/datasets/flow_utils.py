"""Optical-flow file I/O and visualisation, numpy only (counterpart of
shineon_tpu/datasets/flow_utils.py; the bytes of a ``.flo`` file are the
same).

The ``.flo`` format is the Middlebury standard: the 4-byte tag "PIEH"
(float32 202021.25), int32 width, int32 height, then H*W*2 float32 (u, v)
pairs, row-major.
"""

from __future__ import annotations

import numpy as np

_TAG_FLOAT = 202021.25


def read_flow(path: str) -> np.ndarray:
    """Read a .flo file -> (H, W, 2) float32 array."""
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        if tag != _TAG_FLOAT:
            raise ValueError(f"{path}: invalid .flo magic {tag!r}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flow(path: str, flow: np.ndarray) -> None:
    """Write an (H, W, 2) array as .flo."""
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([_TAG_FLOAT], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def _make_color_wheel() -> np.ndarray:
    """The Middlebury colour wheel of 55 colours."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 Middlebury colour coding."""
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    bad = (np.abs(u) > 1e7) | (np.abs(v) > 1e7) | np.isnan(u) | np.isnan(v)
    u[bad] = 0
    v[bad] = 0
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max(rad.max(), 1e-9)
    u, v = u / maxrad, v / maxrad

    wheel = _make_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    small = rad <= 1
    for c in range(3):
        col0 = wheel[k0, c] / 255
        col1 = wheel[k1, c] / 255
        col = (1 - f) * col0 + f * col1
        col[small] = 1 - rad[small] * (1 - col[small])
        col[~small] = col[~small] * 0.75
        col[bad] = 0
        img[..., c] = np.floor(255 * col)
    return img
