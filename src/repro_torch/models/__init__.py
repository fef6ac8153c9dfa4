"""The port's model zoo: configuration, layers, GQA attention (dense and
ring caches, cross-attention) and MLA, mixture-of-experts (``moe``), the
Mamba block (``ssm``), the language model (``model``, with the training
loss ``loss_fn`` and an encoder-decoder's ``encode``), and ``convert``
between the port's parameters and the reference's tree."""

from . import attention, config, convert, layers, model, moe, ssm  # noqa: F401
from .config import ModelConfig, SHAPES, SHAPES_BY_NAME  # noqa: F401
from .model import (LM, decode_step, encode, forward,  # noqa: F401
                    forward_hidden, init_caches, init_params, loss_fn,
                    pad_caches_to)
