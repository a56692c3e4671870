"""The test entry: ``python -m shineon_tpu_torch.test`` runs
:func:`shineon_tpu_torch.train.main` with ``train=False`` (reference
test.py:7-10): the test options, ``--checkpoint`` restored (required
unless ``--allow_random_init``), and ``Trainer.test``'s export."""

from shineon_tpu_torch.train import main

if __name__ == "__main__":
    main(train=False)
