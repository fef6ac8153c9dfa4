"""The port's step factories: train, eval, prefill and decode (``steps``)."""

from . import steps  # noqa: F401
from .steps import (checkpoint_state, init_state, make_grad_fn,  # noqa: F401
                    make_decode_step, make_eval_step, make_prefill_step,
                    make_train_step)
