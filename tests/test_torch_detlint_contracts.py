"""The port's determinism lint, layer 2 and the CLI: the registry rule
DET005 on the live registries, the contract matrix DET101-DET105 on the
CPU and in two gloo ranks, the carry dtypes against the reference's
traced carries, the waiver ratchet and ``tools/detlint_torch.py``.

A test that registers a broken policy or backend removes it in
``finally``.  The reference is only traced (``jax.make_jaxpr`` of
``policy.prepare`` and its ``blocked`` executor): its ``shard_map``
executor and its own ``run_contracts`` are never touched.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
TESTS = str(REPO / "tests")
sys.path.insert(0, str(REPO / "tools"))

import detlint_torch  # noqa: E402
from repro.analysis import rules as RR  # noqa: E402
from repro_torch.analysis import contracts as TC  # noqa: E402
from repro_torch.analysis import rules as TR  # noqa: E402
from repro_torch.analysis import walker as TW  # noqa: E402
from repro_torch.distributed import spawn  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.reduce import backends as TB  # noqa: E402
from repro_torch.reduce.policy import (POLICIES, ExactPolicy,  # noqa: E402
                                       Policy)

TIERS = ("compensated", "exact", "exact2", "fast", "procrastinate")
OPS = 6


def unwaived(findings):
    return [f for f in findings if not f.waived and not f.not_run]


# ---------------------------------------------------------------------------
# DET005: the live registries
# ---------------------------------------------------------------------------


def test_det005_clean_on_live_registries_only_fast_waived():
    found = TR.check_registries()
    assert not unwaived(found), "\n".join(map(str, found))
    (fast,) = found
    assert fast.waived and "'fast'" in fast.message
    assert fast.reason == TR.TOLERATED_FLOAT_MERGE["fast"]
    assert fast.path == "src/repro_torch/reduce/policy.py"


def test_hook_table_equals_the_references():
    assert TR._POLICY_HOOKS == RR._POLICY_HOOKS
    # the port's executors take no ``interpret``; the rest is the same
    assert set(RR._BACKEND_RUN_KWARGS) - set(TR._BACKEND_RUN_KWARGS) == \
        {"interpret"}


def test_det005_flags_a_broken_hook_and_a_backend_signature():
    class _BadHook(Policy):
        name = "_bad_hook"
        acc_dtype = torch.int32        # an integer carry: only the hook

        def update(self, carry):       # the schedule calls update(carry, c)
            return carry

    def _bad_run(values, ids, num_segments, *, policy):
        return None

    POLICIES["_bad_hook"] = _BadHook()
    TB.register_backend("_bad_run", policies="*", staged=True)(_bad_run)
    try:
        found = unwaived(TR.check_registries())
        msgs = [f.message for f in found]
        assert any("'_bad_hook' hook `update`" in m for m in msgs), msgs
        assert any("'_bad_run' run(): missing keyword(s) ['block_size', "
                   "'program']" in m for m in msgs), msgs
        assert len(found) == 2
    finally:
        del POLICIES["_bad_hook"]
        del TB.BACKENDS["_bad_run"]


# ---------------------------------------------------------------------------
# DET101-DET105: the matrix
# ---------------------------------------------------------------------------


def test_carry_dtypes_equal_the_references_traced_carries():
    import jax
    from repro.reduce.backends import BACKENDS as RB
    from repro.reduce.policy import POLICIES as RP
    ctx = TC._Ctx.build("cpu", None, ("blocked",))
    for name in TIERS:
        rp = RP[name]

        def fn(v, i, rp=rp):
            domain, _ = rp.prepare(v, TC._N)
            return RB["blocked"].run(domain, i, TC._S, policy=rp,
                                     block_size=TC._BLOCK_SIZES[0],
                                     interpret=True)

        traced = [np.dtype(a.dtype).name for a in
                  jax.make_jaxpr(fn)(ctx.vals, ctx.ids).out_avals]
        policy = POLICIES[name]
        carry = ctx.run_carry(policy, ctx.backends["blocked"],
                              block_size=TC._BLOCK_SIZES[0])
        ran = [str(c.dtype).replace("torch.", "") for c in carry]
        declared = [str(d).replace("torch.", "")
                    for d in policy.carry_dtypes]
        assert traced == ran == declared, (name, traced, ran, declared)
        assert len(ran) == policy.carry_len


def test_matrix_counts_as_the_product_and_names_every_row_not_run():
    found = TC.run_contracts()
    assert not unwaived(found), "\n".join(map(str, found))
    assert [(f.rule, f.path) for f in found if f.waived] == \
        [("DET102", "fast")]
    assert TC.matrix_size() == OPS * len(TIERS) * 4 == 120
    assert TC.matrix_size(("ref", "blocked", "cuda")) == 90
    cov = sorted(f.path for f in found
                 if f.rule == "DET105" and f.not_run)
    assert cov == sorted(f"{p}/{b}/{o}" for p in TIERS
                         for b in ("cuda", "shard_map")
                         for o in ("mean", "moments", "poly", "sum",
                                   "sumsq", "weighted_sum"))
    carry = sorted(f.path for f in found if f.rule == "DET101")
    assert carry == sorted(f"{p}/{b}" for p in TIERS
                           for b in ("cuda", "shard_map"))


def test_shard_map_rows_run_in_two_gloo_ranks(tmp_path):
    outs = spawn.run_ranks("torch_dist_workers:contract_matrix", 2,
                           workdir=tmp_path, paths=[TESTS], threads=1,
                           kwargs={"backends": ("blocked", "shard_map")},
                           timeout=240)
    for found in outs:
        bad = [f for f in found if not f["waived"]]
        assert not bad, bad          # none unwaived, none "not run"
        assert [(f["rule"], f["path"]) for f in found] == \
            [("DET102", "fast")]
        assert "shard_map" in found[0]["message"]


def test_det101_and_det102_catch_a_lying_or_float_merging_policy():
    class _BrokenInt(Policy):
        name = "_broken_int"

        @property
        def carry_dtypes(self):
            return (torch.int32,)      # lies: update() folds float32

    class _FloatMerge(Policy):
        name = "_float_merge"          # merge_is_add, float carry, no waiver

    POLICIES["_broken_int"] = _BrokenInt()
    POLICIES["_float_merge"] = _FloatMerge()
    try:
        found = TC.run_contracts(checks=("carry",))
        hits = {(f.rule, f.path) for f in unwaived(found)}
        assert ("DET101", "_broken_int/blocked") in hits
        assert ("DET101", "_broken_int/ref") in hits
        assert ("DET102", "_float_merge") in hits
        assert ("DET101", "_float_merge/blocked") not in hits
    finally:
        del POLICIES["_broken_int"]
        del POLICIES["_float_merge"]


def test_det103_holds_the_nvcc_flags(monkeypatch):
    assert not TC.run_contracts(checks=("flags",))
    monkeypatch.setattr(_build, "NVCC_FLAGS", tuple(
        f for f in _build.NVCC_FLAGS if f != "--fmad=false")
        + ("--use_fast_math",))
    msgs = [f.message for f in TC.run_contracts(checks=("flags",))]
    assert len(msgs) == 2
    assert "lack --fmad=false" in msgs[0] and "--use_fast_math" in msgs[1]
    monkeypatch.setattr(_build, "SOURCES", _build.SOURCES[1:])
    found = TC.run_contracts(checks=("flags",))
    assert any(f.path.endswith("csrc/segsum.cu") for f in found)


def test_det104_flags_a_block_size_dependent_op():
    class _BlockDependent(ExactPolicy):
        name = "_block_dependent"

        def contrib(self, ids, vals, num_segments):
            if vals.shape[1] > 32:       # only at block size 64
                vals = torch.flip(torch.flip(vals, (1,)), (1,))
            return super().contrib(ids, vals, num_segments)

        contrib_lanes = None           # keep the dot form

    clean = TC.run_contracts(checks=("invariance",))
    assert clean == []
    POLICIES["_block_dependent"] = _BlockDependent()
    try:
        (hit,) = TC.run_contracts(checks=("invariance",))
        assert hit.rule == "DET104" and "aten.flip" in hit.message
    finally:
        del POLICIES["_block_dependent"]


def test_det105_flags_a_backend_off_blocked_at_an_integer_tier():
    def _skewed(values, ids, num_segments, *, policy, block_size=512,
                program=None):
        carry = TB.BACKENDS["blocked"].run(values, ids, num_segments,
                                           policy=policy,
                                           block_size=block_size,
                                           program=program)
        return (carry[0] + 1,) + tuple(carry[1:])

    TB.register_backend("_skewed", policies=("exact", "fast"),
                        staged=True)(_skewed)
    try:
        found = TC.run_contracts(checks=("coverage",),
                                 backends=("blocked", "_skewed"))
        hits = sorted(f.path for f in unwaived(found))
        # the integer tier is held bitwise; fast to nothing here
        assert hits == [f"exact/_skewed/{o}" for o in
                        ("mean", "moments", "poly", "sum", "sumsq",
                         "weighted_sum")]
    finally:
        del TB.BACKENDS["_skewed"]


# ---------------------------------------------------------------------------
# The ratchet and the CLI
# ---------------------------------------------------------------------------


def test_ratchet_fails_on_a_rise_and_passes_on_an_equal_count():
    base = {"DET001": 3, "DET002": 2}
    errors, notes = detlint_torch.check_ratchet(dict(base), base)
    assert not errors and not notes
    errors, _ = detlint_torch.check_ratchet({"DET001": 4, "DET002": 2},
                                            base)
    assert len(errors) == 1 and "DET001" in errors[0]
    errors, notes = detlint_torch.check_ratchet({"DET001": 3, "DET002": 1},
                                                base)
    assert not errors and len(notes) == 1 and "DET002" in notes[0]
    errors, _ = detlint_torch.check_ratchet({"DET009": 1}, {})
    assert errors


def test_baseline_equals_the_live_counts():
    _, findings = detlint_torch.lint()
    counts = detlint_torch.waiver_counts(findings)
    baseline = json.loads(detlint_torch.BASELINE.read_text())
    assert counts == baseline, (counts, baseline)
    assert set(baseline) <= set(TR.ALL_RULE_IDS) | {"DET102"}


def test_cli_exits_zero_on_the_repo_and_nonzero_on_a_dirty_fixture(
        tmp_path, capsys):
    assert detlint_torch.main(["--check-waivers", "-q"]) == 0
    assert detlint_torch.main(["--ast-only", "--check-waivers", "-q"]) == 0
    bad = tmp_path / "src" / "repro_torch" / "models" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\ndef f(x):\n    return torch.sum(x)\n")
    assert detlint_torch.main(["--ast-only", "-q", str(bad)]) == 1
    assert "DET001" in capsys.readouterr().out
    assert TW.iter_source_files([bad]) == [bad]
