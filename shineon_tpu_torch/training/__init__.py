"""Training state, optimizers, checkpoints and the train loop of the port
(counterpart of shineon_tpu/training/)."""
