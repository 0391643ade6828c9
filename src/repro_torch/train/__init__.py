"""The train step: the counterpart of ``repro.train``."""
from repro_torch.train.steps import (TrainState, init_train_state,  # noqa: F401
                                     make_train_step)
