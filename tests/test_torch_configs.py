"""The port's configuration copies and model support against the
reference, on the CPU: every architecture's CONFIG and SMOKE equal the
reference's, every model builds (the GQA ones, dense or with experts,
dense or ring caches, M-RoPE; the MLA one, the Mamba hybrid, the xLSTM
stack and the encoder-decoder), and stablelm-1.6b's,
deepseek-v2-lite-16b's, jamba-v0.1-52b's, xlstm-125m's and
seamless-m4t-large-v2's full-width parameter shapes match the reference's
``init_params`` (both abstract: nothing is allocated)."""

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
    model (mixtral-8x22b's experts and qwen2-vl-7b's M-RoPE and embedding
    inputs included), an MLA one
    (deepseek-v2-lite-16b), a Mamba hybrid (jamba-v0.1-52b), an xLSTM
    stack (xlstm-125m) or an encoder-decoder (seamless-m4t-large-v2)
    builds on the meta device (nothing allocated) with the reference's
    parameter count plus its norms (a second one only in a block with an
    MLP) and, for each recurrent layer and the encoder-decoder, the
    corrections of what ``param_counts`` miscounts (``_mamba_uncounted``,
    ``_xlstm_uncounted``, ``_encdec_uncounted``); a configuration the
    port lacks (none now) would raise NotImplementedError naming
    everything missing."""
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
        with_mlp = sum(sp.mlp != "none" for sp in cfg.period) \
            * cfg.n_periods                           # param_counts has no
        norms = (cfg.n_layers + with_mlp + 1) * cfg.d_model       # norms
        if cfg.attn_type == "mla":                      # nor MLA's c_norm
            norms += cfg.n_layers * cfg.kv_lora_rank
        assert sum(p.numel() for p in model.parameters()) \
            == cfg.param_counts()["total"] + norms + _mamba_uncounted(cfg) \
            + _xlstm_uncounted(cfg) + _encdec_uncounted(cfg)
        return
    with pytest.raises(NotImplementedError) as e:
        TM.init_params(cfg, device="meta")
    for m in missing:
        assert m in str(e.value)
    with pytest.raises(NotImplementedError):
        TM.init_caches(cfg, 1, 8, device="cpu")


def _mamba_uncounted(cfg) -> int:
    """What ``param_counts`` (a copy of the reference's) leaves out of
    each Mamba layer of the reference's ``mamba_init`` tree.  It counts
    in_proj, conv_w, x_proj's b and c columns, two di vectors and
    out_proj; the tree also holds x_proj's dt_rank columns and dt_proj
    (dt_rank * di each), a_log (d_state * di) and a third di vector
    (conv_b, dt_bias, d_skip): 2 dt_rank di + d_state di + di, 4,333,568
    at jamba-v0.1-52b's width."""
    n = sum(sp.kind == "mamba" for sp in cfg.period) * cfg.n_periods
    if not n:
        return 0
    di = cfg.mamba.expand * cfg.d_model
    dt_rank = -(-cfg.d_model // 16)
    return n * (2 * dt_rank * di + cfg.mamba.d_state * di + di)


def _xlstm_uncounted(cfg) -> int:
    """What ``param_counts`` leaves out of each mLSTM and sLSTM layer of
    the reference's ``mlstm_init`` and ``slstm_init`` trees.  Of an
    mLSTM it counts in_proj, the q, k, v projections as block-diagonal
    (3 di^2 / H), out_proj and three di vectors; the tree holds full
    (di, di) projections, conv_w (kernel x di), w_if (di x 2H), b_i and
    b_f (H each) and conv_b and out_norm (di each): 3 di^2 (1 - 1/H) +
    (kernel - 1) di + 2 H di + 2 H, 5,325,320 at xlstm-125m's width.  Of
    an sLSTM it counts w_x, w_h and the FFN; the tree also holds the 4 d
    bias (3,072)."""
    x = cfg.xlstm
    n_m = sum(sp.kind == "mlstm" for sp in cfg.period) * cfg.n_periods
    n_s = sum(sp.kind == "slstm" for sp in cfg.period) * cfg.n_periods
    if not (n_m or n_s):
        return 0
    di, h = int(x.proj_factor_m * cfg.d_model), x.num_heads
    return n_m * (3 * di * di - 3 * di * di // h + (x.conv_kernel - 1) * di
                  + 2 * h * di + 2 * h) + n_s * 4 * cfg.d_model


def test_unsupported_names_each_missing_kind():
    """Experts, ring caches, MLA, Mamba, xLSTM, M-RoPE, embedding inputs
    and the encoder-decoder are ported: every configuration runs
    (``unsupported`` empty, ``check_supported`` silent), mixtral-8x22b,
    deepseek-v2-lite-16b, jamba-v0.1-52b, xlstm-125m, qwen2-vl-7b and
    seamless-m4t-large-v2 among them."""
    for arch in (ARCH, "mixtral-8x22b", "deepseek-v2-lite-16b",
                 "jamba-v0.1-52b", "xlstm-125m", "qwen2-vl-7b",
                 "seamless-m4t-large-v2"):
        assert TM.unsupported(TC.get_config(arch)) == []
    for arch in RC.ARCH_IDS:
        assert TM.unsupported(TC.get_config(arch)) == [], arch
        TM.check_supported(TC.get_config(arch))
        TM.check_supported(TC.get_smoke_config(arch))


def _encdec_uncounted(cfg) -> int:
    """What ``param_counts`` (a copy of the reference's) miscounts in an
    encoder-decoder's tree: it counts each encoder layer's GELU MLP as 3 d
    d_ff where the tree holds two (d, d_ff) matrices, and no norm of the
    decoder's cross step (``norm_x``) or of the encoder (two a layer and
    its final norm): - enc d d_ff + (n_layers + 2 enc + 1) d, -201,326,592
    + 74,752 at seamless-m4t-large-v2's width."""
    if not cfg.is_encdec:
        return 0
    d, enc = cfg.d_model, cfg.encoder_layers
    return -enc * d * cfg.d_ff + (cfg.n_layers + 2 * enc + 1) * d


def _meta_against_eval_shape(arch):
    """{reference path: shape} of ``arch``'s CONFIG from ``jax.eval_shape``
    of the reference's init_params and from the port's model on the meta
    device, and the model.  Nothing is allocated on either side."""
    cfg = RC.get_config(arch)
    abstract = jax.eval_shape(lambda key: RM.init_params(key, cfg),
                              jax.random.PRNGKey(0))
    ref = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               abstract)[0]}
    tcfg = TC.get_config(arch)
    model = TM.init_params(tcfg, device="meta")
    # the port's parameters in the reference tree's layout: layer j of
    # period 0 stands for period position j, stacked under "blocks/j"
    # (an encoder-decoder's encoder layer 0 for "encoder/blocks", stacked
    # on encoder_layers)
    got = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[:2] == ["encoder", "blocks"]:
            if parts[2] == "0":
                got["/".join(parts[:2] + parts[3:])] = \
                    (tcfg.encoder_layers,) + tuple(p.shape)
        elif parts[0] != "blocks":
            got["/".join(parts)] = tuple(p.shape)
        elif int(parts[1]) < len(tcfg.period):      # period 0's layers
            got["/".join(parts)] = (tcfg.n_periods,) + tuple(p.shape)
    return ref, got, model


def test_full_width_shapes_on_meta_match_eval_shape():
    """stablelm-1.6b's CONFIG: every parameter's shape and the count,
    from a model on the meta device, against ``jax.eval_shape`` of the
    reference's init_params."""
    ref, got, model = _meta_against_eval_shape(ARCH)
    assert got == ref
    assert all(p.device.type == "meta" for p in model.parameters())
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s)) for s in ref.values()) == 1644267520
    assert TM.param_bytes(model) == 2 * n                    # bf16
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}


def test_deepseek_full_width_shapes_on_meta_match_eval_shape():
    """deepseek-v2-lite-16b's CONFIG at all 27 layers (MLA with its
    latent norm, 64 routed experts, 2 shared, an f32 router): every
    parameter's shape against ``jax.eval_shape`` of the reference's
    init_params; 16,210,198,528 parameters by ``param_counts`` (norms
    not counted), the same plus the 55 d_model norms and 27 latent norms
    on both sides."""
    ref, got, model = _meta_against_eval_shape("deepseek-v2-lite-16b")
    assert got == ref
    assert {"blocks/0/core/c_norm", "blocks/0/core/wuk",
            "blocks/0/mlp/router"} <= set(got)
    cfg = TC.get_config("deepseek-v2-lite-16b")
    assert cfg.param_counts()["total"] == 16_210_198_528
    norms = 55 * cfg.d_model + 27 * cfg.kv_lora_rank
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s)) for s in ref.values()) \
        == 16_210_198_528 + norms
    routers = 27 * cfg.d_model * cfg.moe.num_experts          # float32
    assert TM.param_bytes(model) == 2 * (n - routers) + 4 * routers


def test_jamba_full_width_shapes_on_meta_match_eval_shape():
    """jamba-v0.1-52b's CONFIG at all 32 layers (Mamba at 7 of each 8
    period positions, GQA at position 4, 16 experts top-2 with an f32
    router at the odd positions): every parameter's shape against
    ``jax.eval_shape`` of the reference's init_params; 51,570,315,264
    parameters on both sides (``param_counts`` plus the 65 norms and 28
    x 4,333,568 uncounted Mamba leaves); ``param_bytes`` counts the
    float32 leaves (each Mamba layer's dt_bias, a_log, d_skip, each MoE
    router) at 4 bytes, the rest at 2."""
    ref, got, model = _meta_against_eval_shape("jamba-v0.1-52b")
    assert got == ref
    assert {"blocks/0/core/a_log", "blocks/4/core/wq",
            "blocks/1/mlp/router", "blocks/2/mlp/wg"} <= set(got)
    cfg = TC.get_config("jamba-v0.1-52b")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s)) for s in ref.values()) == 51_570_315_264
    assert n == cfg.param_counts()["total"] + 65 * cfg.d_model \
        + 28 * 4_333_568
    di = 2 * cfg.d_model
    f32 = 28 * (di + di * 16 + di) + 16 * cfg.d_model * 16
    assert {p.dtype for p in model.parameters()} \
        == {torch.bfloat16, torch.float32}
    assert sum(p.numel() for p in model.parameters()
               if p.dtype == torch.float32) == f32
    assert TM.param_bytes(model) == 2 * (n - f32) + 4 * f32


def test_xlstm_full_width_shapes_on_meta_match_eval_shape():
    """xlstm-125m's CONFIG at all 12 layers (mLSTM at period positions
    0-2, sLSTM at 3; no MLP; tied embeddings, so no head): every
    parameter's shape against ``jax.eval_shape`` of the reference's
    init_params; 153,370,440 parameters on both sides (``param_counts``'s
    105,423,360 plus the 13 norms, 9 x 5,325,320 uncounted mLSTM leaves
    and 3 x 3,072 sLSTM biases); ``param_bytes`` counts the float32
    leaves (each mLSTM's w_if, b_i, b_f, each sLSTM's bias) at 4 bytes,
    the rest at 2: 306,980,640 bytes."""
    ref, got, model = _meta_against_eval_shape("xlstm-125m")
    assert got == ref
    assert {"blocks/0/core/w_if", "blocks/2/core/out_norm",
            "blocks/3/core/w_h", "blocks/3/core/bias"} <= set(got)
    assert "lm_head" not in got
    cfg = TC.get_config("xlstm-125m")
    assert cfg.param_counts()["total"] == 105_423_360
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s)) for s in ref.values()) == 153_370_440
    assert n == 105_423_360 + 13 * 768 + 9 * 5_325_320 + 3 * 3_072
    f32 = 9 * (1_536 * 8 + 4 + 4) + 3 * 4 * 768
    assert sum(p.numel() for p in model.parameters()
               if p.dtype == torch.float32) == f32
    assert TM.param_bytes(model) == 2 * (n - f32) + 4 * f32 == 306_980_640


def test_seamless_full_width_shapes_on_meta_match_eval_shape():
    """seamless-m4t-large-v2's CONFIG (24 encoder layers, 24 decoder
    layers with cross-attention, d_model 1,024, 16 heads on 16 KV heads,
    d_ff 8,192, vocab 256,206): every parameter's shape against
    ``jax.eval_shape`` of the reference's init_params, the encoder's
    stacked on a leading 24 axis; 1,632,233,472 parameters on both sides
    (3.264 GB in bf16), ``param_counts``'s 1,833,435,136 plus the
    decoder's 49 norms and ``_encdec_uncounted``."""
    ref, got, model = _meta_against_eval_shape("seamless-m4t-large-v2")
    assert got == ref
    assert ref["encoder/blocks/core/wq"] == (24, 1024, 1024)
    assert ref["encoder/blocks/norm1"] == (24, 1024)
    assert ref["encoder/final_norm"] == (1024,)
    assert {"blocks/0/cross/wk", "blocks/0/norm_x"} <= set(got)
    cfg = TC.get_config("seamless-m4t-large-v2")
    assert cfg.param_counts()["total"] == 1_833_435_136
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s)) for s in ref.values()) == 1_632_233_472
    assert n == 1_833_435_136 + 49 * 1024 + _encdec_uncounted(cfg)
    assert _encdec_uncounted(cfg) == -201_326_592 + 74_752
    assert TM.param_bytes(model) == 2 * n                     # bf16
