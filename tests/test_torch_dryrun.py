"""The port's dry-run (``launch/specs.py``, ``launch/dryrun.py``) on the
``meta`` device, on the CPU.

Every (arch x shape) cell's abstract parameters, caches and inputs are
held to ``jax.eval_shape`` of the reference's ``launch.specs``: the same
leaves, shapes, dtypes and bytes, exactly.  The FLOPs a cell's step
records are held to closed-form matmul counts on stablelm's and
mixtral's SMOKE configurations, and the depth-extrapolated count to the
full-depth one where every period is alike.
"""

import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.launch import specs as RS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeCfg  # noqa: E402
from repro_torch.models.moe import MOE_GROUP  # noqa: E402

#: a small cell for the SMOKE configurations: batch 2, 64 tokens
SMOKE_B, SMOKE_S = 2, 64

TFD = importlib.import_module("repro_torch.kernels.flash_decode")


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _ref_leaves(tree):
    """{"/"-joined path: (shape, dtype name)} of a reference tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _port_cache_leaves(caches):
    return {f"{j}/core/{f}": (tuple(t.shape), _dt(t.dtype))
            for j, c in enumerate(caches)
            for f, t in zip(c["core"]._fields, c["core"])}


def _ref_cache_leaves(caches):
    return {f"{j}/core/{f}": (tuple(t.shape), str(t.dtype))
            for j, c in enumerate(caches)
            for f, t in zip(c["core"]._fields, c["core"])}


#: bytes an element of each dtype the specs hold
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int32": 4}


def _bytes(leaves):
    return sum(int(np.prod(s)) * _ITEMSIZE[d] for s, d in leaves.values())


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_specs_equal_reference_eval_shape(arch):
    """Parameters (in the reference's stacked layout), every applicable
    shape's inputs and its decode caches in the model's dtype: the
    reference's leaves, shapes, dtypes and bytes exactly.  The port's
    default caches are float32 (K2 reads float32): the same shapes,
    every floating leaf widened."""
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    want = _ref_leaves(RS.abstract_params(rcfg))
    model = TS.abstract_params(tcfg)
    got = {p: (tuple(t.shape), _dt(t.dtype)) for p, t in
           convert.to_reference(tcfg, dict(model.named_parameters())).items()}
    assert got == want
    assert TS.nbytes(model) == _bytes(want)
    for shape in SHAPES:
        if not RC.shape_applicable(rcfg, shape):
            assert not TC.shape_applicable(tcfg, shape)
            continue
        rin = RS.input_specs(rcfg, shape)
        tin = TS.input_specs(tcfg, shape)
        assert sorted(rin) == sorted(tin), shape.name
        for k in rin:
            if k == "caches":
                rc = _ref_cache_leaves(rin[k])
                narrow = TS.abstract_caches(tcfg, shape.global_batch,
                                            shape.seq_len, dtype=tcfg.dtype)
                assert _port_cache_leaves(narrow) == rc, shape.name
                assert TS.nbytes(narrow) == _bytes(rc)
                assert _port_cache_leaves(tin[k]) == {
                    p: (s, "int32" if d == "int32" else "float32")
                    for p, (s, d) in rc.items()}
                continue
            assert (tuple(tin[k].shape), _dt(tin[k].dtype)) == (
                tuple(rin[k].shape), str(rin[k].dtype)), (shape.name, k)
            assert tin[k].device.type == "meta"
    assert TS.ENC_LEN_DECODE == RS.ENC_LEN_DECODE


def _attn_flops(cfg, b, s):
    """One GQA layer's products over (b, s) tokens: the q, k, v, o
    projections and the two attention products (each query block against
    every key: a window masks, it does not skip)."""
    t, d, hd = b * s, cfg.d_model, cfg.hdim
    proj = 2 * t * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    return proj + 2 * (2 * b * cfg.n_heads * s * s * hd)


def _mlp_flops(cfg, b, s):
    """(the MLP's products, the block's last product): SwiGLU's wi, wg
    and wo; for experts the router, the (E, Cg) buffers' three expert
    products and the combine (k weights a token)."""
    t, d = b * s, cfg.d_model
    if cfg.moe is None:
        last = 2 * t * cfg.d_ff * d
        return 3 * last, last
    m = cfg.moe
    g = min(MOE_GROUP, t)
    ng = -(-t // g)
    cg = max(1, int(m.capacity_factor * g * m.top_k / m.num_experts))
    experts = 3 * 2 * m.num_experts * ng * cg * d * m.d_ff_expert
    last = 2 * t * d * m.top_k
    return 2 * t * d * m.num_experts + experts + last, last


@pytest.mark.parametrize("kind", ("prefill", "train"))
@pytest.mark.parametrize("arch", ("stablelm-1.6b", "mixtral-8x22b"))
def test_cell_flops_equal_closed_form(arch, kind):
    """The FLOPs a cell records (FlopCounterMode over one step) on the
    SMOKE config at batch 2 x 64 tokens.  A forward (the prefill cell):
    each layer's attention and MLP products plus the head over every
    token.  A train step (remat on): the head over the 63 tokens that
    have labels, its chunk checkpointed (forward, recompute, two
    backward products); each block forward, recomputed up to its last
    saved input (the block's last product, whose output the backward
    does not need, is not recomputed) and two backward products."""
    cfg = TC.get_smoke_config(arch)
    b, s, d = SMOKE_B, SMOKE_S, cfg.d_model
    mlp, last = _mlp_flops(cfg, b, s)
    block = _attn_flops(cfg, b, s) + mlp
    if kind == "prefill":
        want = cfg.n_layers * block + 2 * b * s * d * cfg.padded_vocab
    else:
        head = 2 * b * (s - 1) * d * cfg.padded_vocab
        want = (4 * head + cfg.n_layers * (4 * block - last))
    rec = TD.run_cell(arch, ShapeCfg("smoke", s, b, kind), cfg=cfg,
                      with_cost_variants=False)
    assert rec["status"] == "ok"
    assert rec["cost_raw"]["flops"] == want


def test_depth_extrapolation_equals_full_depth():
    """Uniform periods (stablelm's and mixtral's SMOKE configs, deepened
    to 5 layers): c1 + (N - 1)(c2 - c1) from the 1- and 2-period variants
    is the full-depth count exactly, for a train and a prefill cell."""
    for arch in ("stablelm-1.6b", "mixtral-8x22b"):
        cfg = TC.get_smoke_config(arch).scaled(n_layers=5)
        for kind in ("train", "prefill"):
            rec = TD.run_cell(arch, ShapeCfg("smoke", SMOKE_S, SMOKE_B,
                                             kind), cfg=cfg)
            v = rec["cost_variants"]
            assert 0 < v[1]["flops"] < v[2]["flops"]
            assert rec["cost_extrapolated"]["flops"] == \
                rec["cost_raw"]["flops"], (arch, kind)


def test_dryrun_cli_writes_records(tmp_path, monkeypatch):
    """``main`` writes one record a cell with the reference's keys: an
    ``ok`` full-width cell (xlstm-125m's decode at 32k: bytes of its
    parameters, float32 states and inputs, its output the logits and
    nothing that aliases), a skipped one and a failing one (its error
    kept); a second run keeps the cached records."""
    TD.main(["--arch", "xlstm-125m", "--shape", "decode_32k", "--out",
             str(tmp_path), "--no-variants"])
    rec = json.loads((tmp_path / "xlstm-125m__decode_32k.json").read_text())
    assert rec["status"] == "ok" and rec["devices"] == 1
    assert rec["kind"] == "decode" and rec["collectives"] is None
    cfg = TC.get_config("xlstm-125m")
    ins = TS.decode_input_specs(cfg, TC.SHAPES_BY_NAME["decode_32k"])
    want = TS.nbytes(TS.abstract_params(cfg)) + TS.nbytes(ins)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == want
    assert mem["output_size_in_bytes"] == 128 * cfg.padded_vocab * 4
    assert mem["temp_size_in_bytes"] is None and mem["temp_note"]
    assert rec["fits_one_h100"] is (want + mem["output_size_in_bytes"]
                                    <= TD.H100_MEMORY_BYTES)
    assert rec["cost_raw"]["flops"] > 0

    TD.main(["--arch", "stablelm-1.6b", "--shape", "long_500k", "--out",
             str(tmp_path)])
    skip = json.loads((tmp_path / "stablelm-1.6b__long_500k.json")
                      .read_text())
    assert skip["status"] == "skipped"

    def boom(*a, **k):
        raise RuntimeError("no meta kernel")
    monkeypatch.setattr(TD, "measure_step", boom)
    TD.main(["--arch", "stablelm-1.6b", "--shape", "train_4k", "--out",
             str(tmp_path)])
    fail = json.loads((tmp_path / "stablelm-1.6b__train_4k.json")
                      .read_text())
    assert fail["status"] == "fail" and "no meta kernel" in fail["error"]
    TD.main(["--arch", "xlstm-125m", "--shape", "decode_32k", "--out",
             str(tmp_path)])               # cached: not run again
    assert json.loads((tmp_path / "xlstm-125m__decode_32k.json")
                      .read_text()) == rec


def test_meta_paths_are_shape_only():
    """The data-dependent spots run on ``meta`` by shape alone: K2's plain
    version computes every split (its liveness is data), skips the
    elementwise per-request merge and gives the (B, H, d) result, as on
    the CPU where it skips the dead splits; M-RoPE's stream table has
    its length without reading the sections."""
    rng = np.random.default_rng(0)
    b, h, kv, t, d = 2, 4, 2, 3000, 16
    arrs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((b, h, d), (b, t, kv, d), (b, t, kv, d))]
    bias = torch.full((b, t), -1e30)
    bias[:, :700] = 0.0                      # the later splits are dead
    cpu = TFD.flash_decode_torch(*arrs, bias, sm_scale=0.25,
                                 split_rows=1024)
    meta = TFD.flash_decode_torch(*(a.to("meta") for a in arrs),
                                  bias.to("meta"), sm_scale=0.25,
                                  split_rows=1024)
    assert meta.shape == cpu.shape == (b, h, d)
    assert meta.dtype == cpu.dtype and meta.device.type == "meta"
    assert torch.isfinite(cpu).all()
    streams = TL.mrope_streams((16, 24, 24), device="meta")
    assert streams.shape == (64,)
    assert TL.mrope_streams((2, 1, 1)).tolist() == [0, 0, 1, 2]
