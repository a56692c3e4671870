"""PyTorch/CUDA port of ShineOn-TPU.

The JAX package ``shineon_tpu`` is the reference; this package mirrors its
layout (``ops``, ``networks``, ``datasets``, ``models``) so each counterpart
is easy to find, keeps the same NHWC layout at its public functions, and
imports nothing of JAX. Hand-written Hopper kernels live in ``csrc/`` and are
built at first use into ``_build/`` (see :mod:`shineon_tpu_torch.ops.cuda_build`).

Entry point: :func:`shineon_tpu_torch.serving.build_inference`.
"""
