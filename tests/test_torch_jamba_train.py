"""jamba-v0.1-52b's training on the port against the reference, on the CPU.

jamba's SMOKE configuration (one period of 8 layers: Mamba at every
position but 4, GQA attention there; 4 experts top-2 at the odd positions;
float32), with the reference's ``init_params`` tree carried across by
``convert.params_from_numpy``: the first tests to differentiate the port's
Mamba block.  The checks are ``tests/test_torch_moe_train.py``'s, with the
top-k choices of all four MoE layers held equal first; the tolerances are
that file's, but for the Mamba leaves' gradients (below).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.models import model as RM  # noqa: E402
from test_torch_moe_train import (GRAD_REL, KEY,  # noqa: E402
                                  check_loss_and_grads, check_train_step)

ARCH = "jamba-v0.1-52b"
#: the Mamba leaves' gradients (``blocks/<Mamba position>/core/*``), max
#: |ref - port| over the leaf's largest |value|: they sum over the tokens
#: through the chunk's scan, which the two packages run in different
#: trees (the reference's associative scan, the port's doubling scan; see
#: tests/test_torch_mamba.py), and through its exponentials (measured:
#: dt_bias 1.1e-5, the rest within GRAD_REL); the same bound holds their
#: AdamW moments after one step (nu, the squares: measured 1.5e-5)
MAMBA_GRAD_REL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    cfg = RC.get_smoke_config(ARCH)
    params = jax.jit(RM.init_params, static_argnums=1)(KEY, cfg)
    return cfg, params, jax.tree.map(np.asarray, params)


def _rel_of(cfg):
    def rel(path):
        parts = path.split("/")
        mamba = (parts[0] == "blocks" and parts[2] == "core"
                 and cfg.period[int(parts[1])].kind == "mamba")
        return MAMBA_GRAD_REL if mamba else GRAD_REL
    return rel


def test_loss_and_grads_within_tolerance_of_reference(smoke):
    """``loss_fn`` and every one of the 114 gradient leaves under the
    ``capacity`` dispatch, which drops choices here."""
    cfg = smoke[0]
    check_loss_and_grads(ARCH, "capacity", *smoke, rel_of=_rel_of(cfg))


def test_train_step_within_tolerance_of_reference(smoke):
    """One ``make_train_step`` step at one microbatch, remat on: the
    parameters, the moments, the grad norm, the loss and aux against the
    reference's jitted step."""
    check_train_step(ARCH, {"num_microbatches": 1}, *smoke,
                     rel_of=_rel_of(smoke[0]))
