"""Data parallelism across processes (counterpart of shineon_tpu/parallel)."""
