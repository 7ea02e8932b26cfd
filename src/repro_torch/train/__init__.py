"""Training substrate: optimizer, steps, data pipeline, checkpointing (the
port of :mod:`repro.train`)."""

from repro_torch.train.optimizer import (adamw_init, adamw_update,  # noqa: F401
                                         cosine_lr)
from repro_torch.train.steps import make_train_step, make_eval_step  # noqa: F401
from repro_torch.train.data import (synthetic_batch,  # noqa: F401
                                    SyntheticTokenPipeline)
