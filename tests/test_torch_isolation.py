"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` never
load JAX, the reference package, ``msgpack`` or ``ml_dtypes`` (the
checkpoint format has its own codec), and the front door never falls
back to the CPU on its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                    "ml_dtypes"))
print("LOADED", len([n for n in sys.modules if n.startswith("repro_torch")]))
print("BAD", bad)
"""


def test_importing_every_module_loads_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = dict(line.split(" ", 1) for line in r.stdout.strip().splitlines())
    assert out["BAD"] == "[]"
    assert int(out["LOADED"]) >= 56


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import_in_source(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_reduce_without_device_raises_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    import repro_torch
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.reduce(torch.ones(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device("cuda")
    assert repro_torch.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("entry", ["segment_sum", "intac_accum",
                                   "flash_decode", "flash_decode_paged"])
def test_kernel_entry_points_without_device_raise_when_cuda_is_absent(entry):
    """``device=None`` means the card for the kernel wrappers too, even on
    CPU tensors; ``device="cpu"`` runs the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    from repro_torch import kernels
    q, k = torch.ones(1, 2, 4), torch.ones(1, 8, 1, 4)
    args = {"segment_sum": (torch.ones(4, 2), torch.zeros(4, dtype=torch.int32), 1),
            "intac_accum": (torch.ones(4, 2), 4.0),
            "flash_decode": (q, k, k, torch.tensor([3])),
            "flash_decode_paged": (q, k.reshape(2, 4, 1, 4),
                                   k.reshape(2, 4, 1, 4),
                                   torch.tensor([[1, 0]], dtype=torch.int32),
                                   torch.tensor([5]))}[entry]
    kw = {"sm_scale": 0.5} if entry.startswith("flash") else {}
    fn = getattr(kernels, entry)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(*args, **kw)
    assert fn(*args, device="cpu", **kw).device.type == "cpu"


@pytest.mark.parametrize("entry", ["init_params", "init_caches",
                                   "params_from_numpy", "Engine"])
def test_model_and_serve_entry_points_without_device_raise(entry):
    """The model and the engine run on the card by default too; with
    ``device="cpu"`` they run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import convert, init_caches, init_params
    from repro_torch.serve import Engine
    cfg = get_smoke_config("stablelm-1.6b")
    g = torch.Generator().manual_seed(0)
    model = init_params(cfg, generator=g, device="cpu")
    tree = {"embed": np.zeros((cfg.padded_vocab, cfg.d_model), np.float32),
            "blocks": []}
    call = {"init_params": lambda **kw: init_params(cfg, generator=g, **kw),
            "init_caches": lambda **kw: init_caches(cfg, 2, 8, **kw),
            "params_from_numpy": lambda **kw: convert.params_from_numpy(
                cfg, tree, **kw),
            "Engine": lambda **kw: Engine(cfg, model, max_len=16, **kw)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call[entry]()
    if entry == "params_from_numpy":   # on the CPU it reads the tree
        with pytest.raises(RuntimeError, match="Missing key"):
            call[entry](device="cpu")
    else:
        assert call[entry](device="cpu") is not None


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    """Without a GPU the chip smoke exits nonzero before any result line;
    alone in a directory (no ``src/``) it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=REPO, capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
