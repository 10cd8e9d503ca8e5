"""Training: AdamW, the train loop, checkpoints and synthetic data.

The port's counterpart of the JAX package's ``training`` package, with the
same exports.
"""
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_update,
    init_adamw,
)
from repro_torch.training.train_loop import make_train_step, train  # noqa: F401
