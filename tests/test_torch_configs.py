"""The port's configuration copies and model support against the
reference, on the CPU: every architecture's CONFIG and SMOKE equal the
reference's, the GQA ones (dense or with experts, dense or ring caches)
build, the rest raise naming what the port lacks, and stablelm-1.6b's
full-width parameter shapes match the reference's ``init_params`` (both
abstract: nothing is allocated)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCH = "stablelm-1.6b"


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_config_copy_and_model_support(arch):
    """CONFIG and SMOKE equal the reference's field for field; a GQA
    model (mixtral-8x22b's experts included) builds on the meta device
    (nothing allocated) with the reference's parameter count plus its
    norms; any other configuration raises NotImplementedError naming
    everything the port lacks."""
    assert TC.ARCH_IDS == RC.ARCH_IDS
    for get in ("get_config", "get_smoke_config"):
        ref = getattr(RC, get)(arch)
        got = getattr(TC, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.hdim == ref.hdim and got.padded_vocab == ref.padded_vocab
        assert got.param_counts() == ref.param_counts()
    assert [dataclasses.asdict(s) for s in TC.SHAPES] \
        == [dataclasses.asdict(s) for s in RC.SHAPES]
    cfg = TC.get_config(arch)
    missing = TM.unsupported(cfg)
    if not missing:
        model = TM.init_params(cfg, device="meta")
        norms = (2 * cfg.n_layers + 1) * cfg.d_model  # param_counts has none
        assert sum(p.numel() for p in model.parameters()) \
            == cfg.param_counts()["total"] + norms
        return
    with pytest.raises(NotImplementedError) as e:
        TM.init_params(cfg, device="meta")
    for m in missing:
        assert m in str(e.value)
    with pytest.raises(NotImplementedError):
        TM.init_caches(cfg, 1, 8, device="cpu")


def test_unsupported_names_each_missing_kind():
    """Experts and ring caches are ported: mixtral-8x22b runs,
    deepseek-v2-lite-16b lacks MLA alone and jamba-v0.1-52b mamba
    alone."""
    want = {"deepseek-v2-lite-16b": {"mla (latent attention)"},
            "xlstm-125m": {"mlstm", "slstm"},
            "jamba-v0.1-52b": {"mamba"},
            "qwen2-vl-7b": {"embed_inputs", "mrope"},
            "seamless-m4t-large-v2": {"enc-dec"}}
    for arch, kinds in want.items():
        assert set(TM.unsupported(TC.get_config(arch))) >= kinds, arch
    for arch in ("deepseek-v2-lite-16b", "jamba-v0.1-52b"):
        assert set(TM.unsupported(TC.get_config(arch))) == want[arch]
    for arch in (ARCH, "mixtral-8x22b"):
        assert TM.unsupported(TC.get_config(arch)) == []


def test_full_width_shapes_on_meta_match_eval_shape():
    """stablelm-1.6b's CONFIG: every parameter's shape and the count,
    from a model on the meta device, against ``jax.eval_shape`` of the
    reference's init_params.  Nothing is allocated on either side."""
    cfg = RC.get_config(ARCH)
    abstract = jax.eval_shape(lambda key: RM.init_params(key, cfg),
                              jax.random.PRNGKey(0))
    ref = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               abstract)[0]}
    tcfg = TC.get_config(ARCH)
    model = TM.init_params(tcfg, device="meta")
    # the port's parameters in the reference tree's layout: layer l of
    # period position j stacked under "blocks/j" (one position here)
    got = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "blocks":
            got[name] = tuple(p.shape)
        elif parts[1] == "0":
            got["/".join(parts)] = (tcfg.n_periods,) + tuple(p.shape)
    assert got == ref
    assert all(p.device.type == "meta" for p in model.parameters())
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s)) for s in ref.values()) == 1644267520
    assert TM.param_bytes(model) == 2 * n                    # bf16
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
