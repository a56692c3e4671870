"""Weights drawn from the seed on the device, in a few large calls, by the
law a configuration names (its ``init`` entry); handed alike to the program
and to the plain reference.

Laws (a configuration's ``init["generator"]`` and ``init["gmm"]``, each
``{"law": ..., "gain": ...}``, optionally with ``"by_suffix": {suffix:
law}``, a law of its own for every kernel whose name ends in the suffix):

* ``xavier``: every kernel N(0, gain * sqrt(2 / (fan_in + fan_out))), fan_in
  = cin * kh * kw and fan_out = cout * kh * kw, the upstream's
  ``init_weights("xavier", init_variance)``; batch-norm scales N(1, gain).
* ``normal``: every kernel N(0, gain), CP-VTON's ``init_weights("normal")``
  of the GMM; batch-norm scales N(1, gain).

In each, biases are 0, a spectrally normalized kernel is divided by its
largest singular value (its (cout, cin * kh * kw) matrix), its ``u`` is
N(0, 1) and ``sigma`` 1, running means 0 and running variances 1.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _fans(shape):
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def _law(name: str, law: dict) -> dict:
    for suffix, own in law.get("by_suffix", {}).items():
        if name.endswith(suffix):
            return own
    return law


def _std(name: str, shape, law: dict) -> float:
    law = _law(name, law)
    fan_in, fan_out = _fans(shape)
    if law["law"] == "xavier":
        return law["gain"] * math.sqrt(2.0 / (fan_in + fan_out))
    if law["law"] == "normal":
        return law["gain"]
    raise ValueError(f"unknown init law {law['law']!r}")


def draw(specs, law: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for ``specs`` ((name, shape, kind) as
    ``reference.sams_clip.generator_specs`` gives them)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 64)
    out: Dict[str, torch.Tensor] = {}
    kernels = [(n, s) for n, s, k in specs if k in ("kernel", "spectral", "dense")]
    flat = torch.randn(sum(math.prod(s) for _, s in kernels), generator=g, device=device)
    off = 0
    for name, shape in kernels:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape) * _std(name, shape, law)
        off += n
    spectral = {}
    for name, shape, kind in specs:
        if kind == "spectral":
            spectral.setdefault(tuple(shape), []).append(name)
    for shape, names in spectral.items():  # one batched call a shape
        mats = torch.stack([out[n].reshape(shape[0], -1) for n in names])
        sigma = torch.linalg.matrix_norm(mats, ord=2)
        for n, s in zip(names, sigma):
            out[n] = out[n] / s
    us = [(n, s) for n, s, k in specs if k == "u"]
    flat = torch.randn(max(sum(math.prod(s) for _, s in us), 1), generator=g, device=device)
    off = 0
    for name, shape in us:
        out[name] = flat[off:off + math.prod(shape)].view(shape)
        off += math.prod(shape)
    norms = [(n, s) for n, s, k in specs if k == "norm_weight"]
    flat = torch.randn(max(sum(math.prod(s) for _, s in norms), 1), generator=g, device=device)
    off = 0
    gain = law["gain"]
    for name, shape in norms:
        out[name] = 1.0 + gain * flat[off:off + math.prod(shape)].view(shape)
        off += math.prod(shape)
    for name, shape, kind in specs:
        if kind in ("zero", "running_mean"):
            out[name] = torch.zeros(shape, device=device)
        elif kind in ("one", "running_var"):
            out[name] = torch.ones(shape, device=device)
    return {n: out[n].contiguous() for n, _, _ in specs}
