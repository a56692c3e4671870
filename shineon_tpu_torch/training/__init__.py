"""Training state and optimizers of the port (counterpart of
shineon_tpu/training/)."""
