"""Training: optimizers, the train step and the ``Trainer`` loop."""
