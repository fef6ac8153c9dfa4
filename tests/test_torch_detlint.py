"""The port's determinism lint, layer 1: the walker and the AST rules held
against the reference's on the CPU.

The two walkers parse the same fixture texts into the same waivers and
dotted names.  DET001, DET004 and DET006 run on twin fixtures: a JAX
snippet and its line-for-line torch translation, flagged on the same
lines by the reference's rule and the port's.  Every port rule has a
fixture that fires and one that clears, the pragma's semantics are the
reference's, and the port itself lints clean with a reason on every
waiver.  Fixtures go through ``walker.parse_source``, the path real
files take, under fake paths inside or outside the rules' directories.
"""

import pytest

pytest.importorskip("torch")

from pathlib import Path  # noqa: E402

from repro.analysis import rules as RR  # noqa: E402
from repro.analysis import walker as RW  # noqa: E402
from repro_torch.analysis import rules as TR  # noqa: E402
from repro_torch.analysis import walker as TW  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"

MODELS = "src/repro_torch/models/fixture.py"
REDUCE = "src/repro_torch/reduce/fixture.py"
SERVE = "src/repro_torch/serve/fixture.py"


def lint(rules_mod, walker_mod, text: str, path: str, rule_id: str):
    """One AST rule of ``rules_mod`` over a fixture snippet."""
    mod = walker_mod.parse_source(text, path)
    (rule,) = [r for r in rules_mod.AST_RULES if r.rule == rule_id]
    return rule.run(mod)


def port(text: str, path: str, rule_id: str):
    return lint(TR, TW, text, path, rule_id)


def lines(findings, *, waived=False):
    return sorted(f.line for f in findings if f.waived == waived)


# ---------------------------------------------------------------------------
# The walker: the reference's API, the reference's waivers
# ---------------------------------------------------------------------------

_PRAGMAS = """\
import torch
x = torch.sum(y)  # detlint: ok[DET001] same line
# detlint: ok[DET002,DET003] above, through comments
# (continuation of the justification)

z = a.index_add_(0, i, v)
w = torch.sum(
    y,  # detlint: ok[DET001] inside a multi-line call
    dim=0,
)
# detlint: ok[*] every rule
q = torch.nn.functional.linear(a, b)
s = "# detlint: ok[DET004] inside a string"
"""


def test_walkers_agree_on_waivers_and_dotted_names():
    import ast
    ref = RW.parse_source(_PRAGMAS, "a.py")
    got = TW.parse_source(_PRAGMAS, "a.py")
    as_tuples = [(w.line, w.rules, w.reason) for w in got.waivers]
    assert as_tuples == [(w.line, w.rules, w.reason) for w in ref.waivers]
    assert as_tuples[1] == (6, ("DET002", "DET003"),
                            "above, through comments")
    names = [TW.dotted_name(n) for n in ast.walk(got.tree)]
    assert names == [RW.dotted_name(n) for n in ast.walk(ref.tree)]
    assert "torch.nn.functional.linear" in names
    # the same spans: a pragma inside a call's span waives the call
    call = next(n for n in ast.walk(got.tree) if isinstance(n, ast.Call)
                and n.lineno == 7)
    assert got.waiver_for("DET001", call).reason == \
        "inside a multi-line call"
    assert got.waiver_for("DET002", call) is None
    assert [p.name for p in TW.iter_source_files([PORT / "analysis"])] == \
        ["__init__.py", "contracts.py", "rules.py", "walker.py"]
    assert TW.repo_root() == RW.repo_root() == REPO
    assert TW.symbol_origin_ok("repro_torch.reduce.ReduceOp")
    assert TW.symbol_origin("repro_torch.analysis.walker.parse_source") == \
        "repro_torch.analysis.walker"


# ---------------------------------------------------------------------------
# Twin fixtures: the same lines flagged by the reference and the port
# ---------------------------------------------------------------------------

_TWINS = {
    "DET001": (MODELS, """\
import jax, math
import jax.numpy as jnp
import numpy as np
def f(x, xs):
    a = jnp.sum(x)
    b = x.mean(axis=0)
    c = jnp.cumsum(x)
    d = jax.lax.psum(a, "dp")
    e = np.sum(x) + math.fsum(xs)
    g = jax.lax.pmean(b, "dp")
    return a + b + c + d + e + g
""", """\
import torch, math
import torch.distributed as dist
import numpy as np
def f(x, xs):
    a = torch.sum(x)
    b = x.mean(dim=0)
    c = torch.cumsum(x, 0)
    d = dist.all_reduce(a)
    e = np.sum(x) + math.fsum(xs)
    g = comm.psum(b, group)
    return a + b + c + d + e + g
""", [5, 6, 7, 8, 10]),
    "DET004": (SERVE, """\
import jax
def sample(key, logits, seed, rid, t):
    key, sub = jax.random.split(key)
    tok = jax.random.categorical(sub, logits)
    k2 = jax.random.fold_in(jax.random.fold_in(seed, rid), t)
    tok2 = jax.random.categorical(k2, logits)
    keys = jax.random.split(key, 4)
    return tok, tok2, keys
""", """\
import torch
def sample(gen, probs, seed, rid, t):
    torch.manual_seed(seed)
    tok = torch.multinomial(probs, 1, generator=gen)
    g2 = torch.Generator().manual_seed(hash((seed, rid, t)))
    tok2 = torch.multinomial(probs, 1, generator=g2)
    noise = torch.rand(4)
    return tok, tok2, noise
""", [3, 7]),
    "DET006": (REDUCE, """\
import jax
import jax.numpy as jnp
def f(ids, n):
    ones = jnp.ones((n,), jnp.float32)
    c = jnp.sum(ones)
    i = jnp.arange(n, dtype=jnp.float32)
    k = jax.lax.psum(jnp.float32(1.0), "dp")
    j = jnp.arange(n)
    m = jnp.sum(jnp.ones((n,), jnp.int32))
    return c, i, k, j, m
""", """\
import torch
import torch.distributed as dist
def f(ids, n):
    ones = torch.ones((n,), dtype=torch.float32)
    c = torch.sum(ones)
    i = torch.arange(n, dtype=torch.float32)
    k = comm.psum(torch.tensor(1.0), group)
    j = torch.arange(n)
    m = torch.sum(torch.ones((n,), dtype=torch.int32))
    return c, i, k, j, m
""", [5, 6, 7]),
}


@pytest.mark.parametrize("rule_id", sorted(_TWINS))
def test_twin_fixtures_flag_the_same_lines(rule_id):
    path, jax_src, torch_src, want = _TWINS[rule_id]
    ref_path = path.replace("repro_torch", "repro")
    assert lines(lint(RR, RW, jax_src, ref_path, rule_id)) == want
    assert lines(port(torch_src, path, rule_id)) == want
    # the same scope: neither rule fires outside its directories
    if rule_id in ("DET001", "DET004"):
        elsewhere = "src/repro_torch/kernels/fixture.py"
        assert not port(torch_src, elsewhere, rule_id)
        assert not lint(RR, RW, jax_src,
                        elsewhere.replace("repro_torch", "repro"), rule_id)


def test_rule_ids_and_tolerance_table_are_the_references():
    assert TR.ALL_RULE_IDS == RR.ALL_RULE_IDS
    assert [r.rule for r in TR.AST_RULES] == [r.rule for r in RR.AST_RULES]
    assert TR.TOLERATED_FLOAT_MERGE == RR.TOLERATED_FLOAT_MERGE
    assert TR._FRONT_DOOR_DIRS == RR._FRONT_DOOR_DIRS


# ---------------------------------------------------------------------------
# Each port rule: a fixture that fires and one that clears
# ---------------------------------------------------------------------------


def test_det001_clears_front_door_reduce_internals_and_host_roots():
    src = "import torch\ndef f(x):\n    return torch.sum(x) + x.sum()\n"
    assert len(port(src, MODELS, "DET001")) == 2
    assert not port(src, REDUCE, "DET001")       # the implementation layer
    front = ("from repro_torch import reduce\n"
             "def f(x):\n    return reduce(x, op='sum', device='cpu')\n")
    assert not port(front, MODELS, "DET001")
    host = ("import numpy as np, math\n"
            "def f(x, xs):\n    return np.sum(x) + math.fsum(xs) "
            "+ np.cumsum(x)\n")
    assert not port(host, MODELS, "DET001")


_ORDERLESS = """\
import torch
def f(a, b, n):
    s = torch.sum(a)
    t = a.sum(0)
    u = torch.matmul(a, b)
    v = a @ b
    w = torch.einsum("ij,jk->ik", a, b)
    x = torch.bmm(a, b)
    y = torch.cumsum(a, 0)
    g = torch.compile(f)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    return s, t, u, v, w, x, y, g

@torch.jit.script
def h(a):
    return a
"""


def test_det002_flags_orderless_folds_in_fold_paths_only():
    found = port(_ORDERLESS, REDUCE, "DET002")
    assert lines(found) == [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 15]
    assert lines(port(_ORDERLESS, "src/repro_torch/core/x.py",
                      "DET002")) == lines(found)
    assert lines(port(_ORDERLESS, "src/repro_torch/kernels/x.py",
                      "DET002")) == lines(found)
    assert not port(_ORDERLESS, MODELS, "DET002")


def test_det002_clears_pinned_adds_highest_precision_and_int32_waiver():
    src = ("import torch\n"
           "def f(x, n):\n"
           "    torch.backends.cuda.matmul.allow_tf32 = False\n"
           "    torch.set_float32_matmul_precision('highest')\n"
           "    while x.shape[0] > 1:\n"
           "        x = x[0::2] + x[1::2]\n"
           "    c = torch.sum(n, dtype=torch.int32)  "
           "# detlint: ok[DET002] int32 domain\n"
           "    return x, c\n")
    found = port(src, REDUCE, "DET002")
    assert lines(found) == [] and lines(found, waived=True) == [7]
    assert found[0].reason == "int32 domain"


def test_det003_flags_accumulating_scatters():
    src = ("import torch\n"
           "def f(out, i, v, g):\n"
           "    out.index_add_(0, i, v)\n"
           "    out.scatter_add_(0, i, v)\n"
           "    out.scatter_reduce_(0, i, v, 'sum')\n"
           "    out.index_reduce_(0, i, v, 'prod')\n"
           "    out.index_put_((i,), v, accumulate=True)\n"
           "    out.put_(i, v, True)\n"
           "    torch.index_put(out, (i,), v, True)\n"
           "    return torch.scatter_add(out, 0, i, v)\n")
    assert lines(port(src, MODELS, "DET003")) == [3, 4, 5, 6, 7, 8, 9, 10]


def test_det003_clears_plain_writes_and_host_scatters():
    src = ("import torch, numpy as np\n"
           "def f(out, i, v, a):\n"
           "    out.index_put_((i,), v)\n"
           "    out.index_put_((i,), v, accumulate=False)\n"
           "    out.put_(i, v)\n"
           "    out.scatter_(0, i, v)\n"
           "    out.index_copy_(0, i, v)\n"
           "    np.add.at(a, i, 1)\n"
           "    return out.gather(0, i)\n")
    assert not port(src, MODELS, "DET003")


def test_det004_flags_global_generator_draws_in_serve_only():
    src = ("import torch\n"
           "def step(x, probs, g):\n"
           "    a = torch.randn(3)\n"
           "    b = torch.randint(0, 9, (3,))\n"
           "    x.uniform_()\n"
           "    torch.cuda.manual_seed_all(0)\n"
           "    c = torch.randn(3, generator=g)\n"
           "    x.normal_(generator=g)\n"
           "    d = torch.multinomial(probs, 1, generator=g)\n"
           "    return a, b, c, d, torch.randperm(4)\n")
    assert lines(port(src, SERVE, "DET004")) == [3, 4, 5, 6, 10]
    assert not port(src, MODELS, "DET004")


def test_det006_port_positives_and_clearing():
    src = ("import torch\n"
           "import torch.distributed as dist\n"
           "def f(x, ids, n):\n"
           "    w = torch.ones(n)\n"
           "    a = x.new_zeros(n).index_add_(0, ids, w)\n"
           "    b = dist.all_reduce(torch.tensor(1.0))\n"
           "    c = torch.bincount(ids, weights=torch.full((n,), 1.0))\n"
           "    d = torch.arange(0.0, n)\n"
           "    e = torch.arange(n, dtype=torch.float64)\n"
           "    g = torch.ones(n, dtype=torch.int64).sum()\n"
           "    h = torch.full((n,), 1, dtype=torch.int32)\n"
           "    return a, b, c, d, e, g, torch.bincount(ids, minlength=h)\n")
    # float64 holds integers exactly to 2^53 in torch: not this hazard
    assert lines(port(src, REDUCE, "DET006")) == [5, 6, 7, 8]


# ---------------------------------------------------------------------------
# Pragmas
# ---------------------------------------------------------------------------


def test_pragma_same_line_and_comment_above_through_comments():
    src = ("import torch\n"
           "def f(x, out, i):\n"
           "    a = torch.sum(x)  # detlint: ok[DET001] scalar summary\n"
           "    # detlint: ok[DET001] a metric\n"
           "    # (continuation of the justification)\n"
           "\n"
           "    b = x.mean()\n"
           "    return a + b + torch.sum(out)\n")
    found = port(src, MODELS, "DET001")
    assert [(f.line, f.waived, f.reason) for f in found] == [
        (3, True, "scalar summary"), (7, True, "a metric"),
        (8, False, "")]


def test_pragma_wrong_id_does_not_waive_and_call_span_does():
    src = ("import torch\n"
           "def f(x, out, i):\n"
           "    a = torch.sum(x)  # detlint: ok[DET003] wrong rule\n"
           "    out.index_add_(\n"
           "        0, i,  # detlint: ok[DET003] one add per cell\n"
           "        x)\n"
           "    return torch.sum(\n"
           "        x,  # detlint: ok[DET001] spans the call\n"
           "        dim=0,\n"
           "    )\n")
    (d1a, d1b) = port(src, MODELS, "DET001")
    assert not d1a.waived and d1b.waived and d1b.line == 7
    (d3,) = port(src, MODELS, "DET003")
    assert d3.waived and d3.reason == "one add per cell"


# ---------------------------------------------------------------------------
# The port itself
# ---------------------------------------------------------------------------


def _port_findings():
    return TR.run_lint(TW.iter_source_files([PORT]))


def test_port_has_zero_unwaived_ast_findings():
    found = [f for f in _port_findings() if not f.waived]
    assert not found, "\n".join(str(f) for f in found)


def test_every_waiver_states_a_reason_and_open_faults_are_queued():
    waived = [f for f in _port_findings() if f.waived]
    assert waived
    bare = [f for f in waived if not f.reason]
    assert not bare, "\n".join(str(f) for f in bare)
    # a waiver that leaves a fault standing names its ROADMAP entry
    faults = [f for f in waived if f.reason.startswith("open fault")]
    roadmap = (REPO / "ROADMAP.md").read_text()
    for f in faults:
        assert "ROADMAP queue 3" in f.reason, str(f)
        tag = f.reason.split("queue 3, ")[1].split(")")[0]
        assert f"**{tag}" in roadmap, (tag, str(f))
    assert [f.path for f in faults] == ["src/repro_torch/core/segmented.py"]
