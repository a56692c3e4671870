"""The port's exact SAMS training step of a generator with attention
blocks against the JAX step on the CPU (moved out of
test_torch_training.py so that its JAX compile runs on a worker of its
own); the helpers are test_torch_training's."""

from test_torch_training import JaxSide, assert_step_matches
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)


def test_train_step_with_attention_matches_jax():
    """The exact step of a generator with attention blocks, every gamma
    nonzero, against the JAX step (assert_step_matches): the attention's
    forward and its recompute backward inside the generator's gradient."""
    side = JaxSide(attention=True)
    new_state, jmetrics = side.step()
    model, state, raw = side.port()
    metrics = model.make_train_step()(state, raw)
    assert_step_matches(side, new_state, jmetrics, model, metrics, exact=True)
