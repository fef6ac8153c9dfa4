"""The port's model zoo: configuration, layers, GQA attention (dense and
ring caches) and MLA, mixture-of-experts (``moe``), the Mamba block
(``ssm``), the language model (``model``, with the training loss
``loss_fn``), and ``convert`` between the port's parameters and the
reference's tree."""

from . import attention, config, convert, layers, model, moe, ssm  # noqa: F401
from .config import ModelConfig, SHAPES, SHAPES_BY_NAME  # noqa: F401
from .model import (LM, decode_step, forward, forward_hidden,  # noqa: F401
                    init_caches, init_params, loss_fn, pad_caches_to)
