"""repro_torch.ckpt held against repro.ckpt: the same files both ways.

The port writes MessagePack and zlib itself (no ``msgpack`` package on
the card): its codec is held byte for byte against ``msgpack.packb``,
its chunked zlib streams are read by plain ``zlib.decompress``, and on
stablelm's SMOKE train state (``{"params", "opt": AdamWState}`` with
nonzero moments) each package restores the other's snapshot bitwise.
Then the reference's own checkpoint tests, on the port: retention, a
``.tmp`` directory ignored, the structured errors (each naming the step
and the path), a v1 snapshot without a sidecar, and a restore into the
live model after which one train step trains the restored weights.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as JC  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.ckpt import _msgpack  # noqa: E402
from repro_torch.ckpt import checkpoint as TC  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataCfg, SyntheticLM  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import (checkpoint_state, init_state,  # noqa: E402
                               make_train_step)

ARCH = "stablelm-1.6b"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _small_tree():
    """The reference tests' tree, as tensors: f32, bf16 and an int32
    scalar."""
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)}}


@pytest.fixture(scope="module")
def ref_state():
    """The reference's SMOKE train state with nonzero moments and count,
    and the same state as numpy."""
    cfg = j_smoke(ARCH)
    params = j_init_params(jax.random.PRNGKey(0), cfg)
    mu = jax.tree.map(lambda p: p * 0.5 + 1.0, params)
    nu = jax.tree.map(lambda p: p * p, params)
    state = {"params": params,
             "opt": JA.AdamWState(mu=mu, nu=nu,
                                  count=jnp.asarray(7, jnp.int32))}
    return state, jax.tree.map(np.asarray, state)


def _by_key(tree):
    """{jax.tree_util path string: leaf} of a reference tree."""
    return {"/".join(str(p) for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_state(np_state, device="cpu"):
    """(model, opt_state) of the port holding ``np_state``'s values,
    written through ``checkpoint_state``'s live leaves."""
    model = convert.params_from_numpy(get_smoke_config(ARCH),
                                      np_state["params"], device=device)
    opt = init_state(model)
    want = _by_key(np_state)
    for key, leaf in TC.flatten(checkpoint_state(model, opt)).items():
        leaf.copy_(torch.from_numpy(np.array(want[key])))
    return model, opt


CODEC_CASES = [
    {"k": {"dtype": "float32", "shape": [3, 4], "data": b"\x01" * 40}},
    {f"k{i}": i for i in range(20)},                      # map16, ints
    {"s" * 31: "t" * 32, "u" * 255: "v" * 256},          # fixstr, str8/16
    {"b": b"", "c": b"x" * 255, "d": b"y" * 256,         # bin8/16/32
     "e": b"z" * 65536},
    {"a": list(range(15)), "b": list(range(16)), "c": []},  # fix/array16
    {"n": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
           2 ** 64 - 1]},                                  # uint8-64
    {"shape": [], "nested": {"x": {"y": [1, [2, {"z": b"q"}]]}}},
]


@pytest.mark.parametrize("case", range(len(CODEC_CASES)))
def test_codec_bytes_equal_msgpack(case):
    """The port's MessagePack subset writes ``msgpack.packb``'s bytes and
    reads them back (bins as views); a truncated buffer, trailing bytes
    and a type outside the subset (a float, a negative int) raise
    ValueError."""
    msgpack = pytest.importorskip("msgpack")
    obj = CODEC_CASES[case]
    blob = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.pack(obj) == blob

    def plain(o):
        if isinstance(o, memoryview):
            return bytes(o)
        if isinstance(o, dict):
            return {k: plain(v) for k, v in o.items()}
        if isinstance(o, list):
            return [plain(v) for v in o]
        return o
    assert plain(_msgpack.unpack(blob)) == msgpack.unpackb(blob, raw=False)
    for bad in (blob[:-1], blob + b"\x00", msgpack.packb({"f": 1.5}),
                msgpack.packb([-1])):
        with pytest.raises(ValueError):
            _msgpack.unpack(bad)
    with pytest.raises(ValueError, match="negative"):
        _msgpack.pack({"n": -1})


def test_chunked_zlib_is_one_stream(tmp_path, monkeypatch):
    """A leaf of one chunk is ``zlib.compress(raw, level)`` byte for byte;
    a leaf of many (sync-flushed raw deflate joined behind the zlib
    header, the combined Adler-32 at the end) is read by plain
    ``zlib.decompress``, at levels 0, 1 and 6."""
    rng = np.random.RandomState(0)
    raw = (rng.randn(50_000).astype(np.float32) * 0.02).tobytes() \
        + bytes(30_000)
    for level in (0, 1, 6):
        monkeypatch.setattr(TC, "CHUNK_BYTES", 1 << 30)
        tree = {"x": torch.frombuffer(bytearray(raw), dtype=torch.uint8)}
        TC.save(tmp_path / f"one{level}", 1, tree, level=level)
        blob = (tmp_path / f"one{level}" / "step_00000001"
                / "shard_00000of00001.msgpack").read_bytes()
        data = bytes(_msgpack.unpack(blob)["['x']"]["data"])
        assert data == zlib.compress(raw, level)
        monkeypatch.setattr(TC, "CHUNK_BYTES", 7_001)
        monkeypatch.setattr(TC, "_threads", lambda: 3)
        TC.save(tmp_path / f"many{level}", 1, tree, level=level)
        blob = (tmp_path / f"many{level}" / "step_00000001"
                / "shard_00000of00001.msgpack").read_bytes()
        data = bytes(_msgpack.unpack(blob)["['x']"]["data"])
        assert data != zlib.compress(raw, level) and \
            zlib.decompress(data) == raw
        back, _ = TC.restore(tmp_path / f"many{level}", 1, tree)
        _same(back["x"], tree["x"])
    a, b = raw[:12_345], raw[12_345:]
    assert TC.adler32_combine(zlib.adler32(a), zlib.adler32(b), len(b)) == \
        zlib.adler32(raw)
    assert TC.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == \
        zlib.crc32(raw)


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_reference_snapshot_restores_in_the_port(ref_state, tmp_path,
                                                 monkeypatch, codec):
    """The reference's ``ckpt.save`` of the SMOKE train state (zstd frames
    where ``zstandard`` imports, else zlib) restores into the port's
    ``checkpoint_state`` of a fresh model, in place: every one of the 37
    leaves bitwise, and the model's parameters those values."""
    if codec == "zstd":
        pytest.importorskip("zstandard")
    else:
        monkeypatch.setattr(JC, "zstd", None)
    state, np_state = ref_state
    JC.save(str(tmp_path), 4, state, extra={"next_step": 5})
    cfg = get_smoke_config(ARCH)
    model = convert.params_from_numpy(
        cfg, jax.tree.map(np.zeros_like, np_state["params"]), device="cpu")
    opt = init_state(model)
    live = checkpoint_state(model, opt)
    keys = list(TC.flatten(live))
    assert len(keys) == 37 and keys == sorted(_by_key(state))
    tree, manifest = TC.restore(tmp_path, 4, live, inplace=True)
    assert tree is live and manifest["extra"]["next_step"] == 5
    want = _by_key(np_state)
    for key, leaf in TC.flatten(live).items():
        _same(leaf, want[key])
    ref = convert.params_from_numpy(cfg, np_state["params"], device="cpu")
    for (n, p), (_, q) in zip(model.named_parameters(),
                              ref.named_parameters()):
        _same(p.detach(), q)


def test_port_snapshot_restores_in_the_reference(ref_state, tmp_path,
                                                 monkeypatch):
    """The port's save of the same state restores in the reference's
    ``ckpt.restore`` bitwise; with the reference on zlib, its shard file
    and sidecar are byte for byte the port's."""
    state, np_state = ref_state
    model, opt = _port_state(np_state)
    TC.save(tmp_path / "port", 4, checkpoint_state(model, opt),
            extra={"next_step": 5})
    tree, manifest = JC.restore(str(tmp_path / "port"), 4, state)
    assert manifest["extra"]["next_step"] == 5
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                              jax.tree_util.tree_flatten_with_path(
                                  np_state)[0]):
        _same(a, b)
    monkeypatch.setattr(JC, "zstd", None)
    JC.save(str(tmp_path / "ref"), 4, state, extra={"next_step": 5})
    for name in ("shard_00000of00001.msgpack", "shard_00000of00001.crc.json"):
        assert (tmp_path / "port" / "step_00000004" / name).read_bytes() == \
            (tmp_path / "ref" / "step_00000004" / name).read_bytes(), name


def test_bf16_leaf_both_ways(tmp_path, monkeypatch):
    """A bfloat16 leaf (``dtype: "bfloat16"``, its 16-bit words) and an
    int32 scalar written by each package read back bitwise by the other."""
    monkeypatch.setattr(JC, "zstd", None)
    t = _small_tree()
    j = {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
         "b": {"c": jnp.ones((5,), jnp.bfloat16) * 1.0078125,
               "d": jnp.asarray(3, jnp.int32)}}
    t["b"]["c"] = torch.full((5,), 1.0078125, dtype=torch.bfloat16)
    TC.save(tmp_path / "p", 1, t)
    back, _ = JC.restore(str(tmp_path / "p"), 1, j)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(j)):
        assert a.dtype == b.dtype
        _same(a, b)
    JC.save(str(tmp_path / "r"), 1, j)
    back, _ = TC.restore(tmp_path / "r", 1, t)
    assert back["b"]["c"].dtype == torch.bfloat16
    assert back["b"]["d"].shape == () and back["b"]["d"].dtype == torch.int32
    for key, leaf in TC.flatten(back).items():
        _same(leaf, TC.flatten(t)[key])


def test_roundtrip_retention_and_tmp_ignored(tmp_path):
    t = _small_tree()
    TC.save(tmp_path, 7, t, extra={"next_step": 8})
    assert TC.latest_step(tmp_path) == 7
    back, manifest = TC.restore(tmp_path, 7, t)
    assert manifest["extra"]["next_step"] == 8 and manifest["format"] == 2
    for key, leaf in TC.flatten(back).items():
        _same(leaf, TC.flatten(t)[key])
    for s in (1, 2, 3, 4, 5):
        TC.save(tmp_path / "keep", s, t, keep=2)
    assert sorted(p.name for p in (tmp_path / "keep").iterdir()) == \
        ["step_00000004", "step_00000005"]
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000009.tmp" / "shard_00000of00001.msgpack") \
        .write_bytes(b"garbage")
    assert TC.latest_step(tmp_path) == 7
    assert TC.latest_step(tmp_path / "never") is None
    assert TC.restore_latest_valid(tmp_path / "never", t) is None
    assert TC.restore_latest_valid(tmp_path / "keep", t)[2] == 5
    assert TC.save_every(25, 25) and not TC.save_every(0, 25) \
        and not TC.save_every(5, 0)


def test_structured_errors_name_step_and_path(tmp_path):
    """A missing leaf raises KeyError; a missing step, a truncated shard,
    a corrupt manifest, a corrupt sidecar and no shard file each raise
    ``CheckpointError`` with the step and the path."""
    t = _small_tree()
    TC.save(tmp_path, 1, t)
    with pytest.raises(KeyError, match="extra_leaf"):
        TC.restore(tmp_path, 1, dict(t, extra_leaf=torch.zeros(3)))
    with pytest.raises(TC.CheckpointError, match="manifest.json") as e:
        TC.restore(tmp_path, 42, t)
    assert e.value.step == 42 and str(tmp_path) in e.value.path
    assert "step 42" in str(e.value) and str(tmp_path) in str(e.value)
    d = tmp_path / "step_00000001"
    shard = d / "shard_00000of00001.msgpack"
    blob = shard.read_bytes()
    shard.write_bytes(blob[: len(blob) // 2])           # torn, sidecar kept
    with pytest.raises(TC.CheckpointError, match="CRC32") as e:
        TC.restore(tmp_path, 1, t)
    assert e.value.step == 1 and e.value.path == str(shard)
    (d / "shard_00000of00001.crc.json").unlink()        # torn, no sidecar
    with pytest.raises(TC.CheckpointError,
                       match="truncated or undecodable") as e:
        TC.restore(tmp_path, 1, t)
    assert e.value.step == 1 and e.value.path == str(shard)
    TC.save(tmp_path, 2, t)
    d = tmp_path / "step_00000002"
    (d / "manifest.json").write_text("{not json")
    with pytest.raises(TC.CheckpointError, match="manifest") as e:
        TC.restore(tmp_path, 2, t)
    assert e.value.step == 2 and e.value.path == str(d)
    TC.save(tmp_path / "s", 1, t)
    (tmp_path / "s" / "step_00000001" / "shard_00000of00001.crc.json") \
        .write_text("{")
    with pytest.raises(TC.CheckpointError, match="sidecar is corrupt"):
        TC.restore(tmp_path / "s", 1, t)
    shard2 = tmp_path / "s" / "step_00000001" / "shard_00000of00001.msgpack"
    shard2.unlink()
    with pytest.raises(TC.CheckpointError, match="no shard files"):
        TC.restore(tmp_path / "s", 1, t)


def test_v1_snapshot_without_sidecar_and_a_broken_newest(tmp_path):
    """No ``.crc.json``: restored leniently; a newest step without its
    manifest: ``restore_latest_valid`` falls back to the step before."""
    t = _small_tree()
    TC.save(tmp_path, 1, t)
    for sc in (tmp_path / "step_00000001").glob("*.crc.json"):
        sc.unlink()
    back, _ = TC.restore(tmp_path, 1, t)
    for key, leaf in TC.flatten(back).items():
        _same(leaf, TC.flatten(t)[key])
    TC.save(tmp_path, 2, t)
    (tmp_path / "step_00000002" / "manifest.json").unlink()
    _, _, step = TC.restore_latest_valid(tmp_path, t)
    assert step == 1


def test_keys_placement_and_inplace_checks(tmp_path):
    """Keys are ``jax.tree_util``'s path strings for dicts, lists, tuples
    and NamedTuples (None holds no leaf); ``device=`` places every leaf;
    an in-place restore into a leaf of another shape or dtype raises
    before writing anything."""
    tree = {"z": [torch.zeros(2), (torch.ones(1), None)],
            "o": TA.AdamWState(mu={"w": torch.ones(3)}, nu={"w": torch.ones(3)},
                               count=torch.tensor(2, dtype=torch.int32))}
    keys = list(TC.flatten(tree))
    jt = jax.tree.map(np.asarray, {"z": [np.zeros(2), (np.ones(1), None)],
                                   "o": JA.AdamWState(
                                       mu={"w": np.ones(3)},
                                       nu={"w": np.ones(3)},
                                       count=np.int32(2))})
    assert keys == sorted(_by_key(jt))
    TC.save(tmp_path, 3, tree)
    back, _ = TC.restore(tmp_path, 3, tree, device="meta")
    assert back["o"].count.device.type == "meta"
    assert back["z"][1][1] is None and isinstance(back["o"], TA.AdamWState)
    live = {"z": [torch.full((2,), 5.0), (torch.ones(1), None)],
            "o": TA.AdamWState(mu={"w": torch.ones(3)},
                               nu={"w": torch.ones(4)},
                               count=torch.tensor(0, dtype=torch.int32))}
    with pytest.raises(ValueError, match="nu"):
        TC.restore(tmp_path, 3, live, inplace=True)
    assert live["z"][0].tolist() == [5.0, 5.0]


def test_restore_into_the_live_model_then_train(tmp_path):
    """A snapshot of model A after one step, restored in place into model
    B (other weights, fresh moments): B's parameters are A's, still views
    of B's stacked leaves, and one more step on each gives the same loss
    and the same bits in every leaf."""
    cfg = get_smoke_config(ARCH)
    lr = TA.cosine_schedule(1e-3, 1, 10)
    step = make_train_step(cfg, lr_fn=lr, remat=False, device="cpu")
    data = SyntheticLM(DataCfg(vocab=cfg.vocab, seq_len=16, global_batch=2,
                               seed=0))
    from repro_torch.models import init_params
    a = init_params(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    sa = init_state(a)
    a, sa, _ = step(a, sa, data.batch(0))
    TC.save(tmp_path, 1, checkpoint_state(a, sa), extra={"next_step": 2})
    b = init_params(cfg, generator=torch.Generator().manual_seed(1),
                    device="cpu")
    sb = init_state(b)
    _, manifest, got = TC.restore_latest_valid(
        tmp_path, checkpoint_state(b, sb), inplace=True)
    assert got == 1 and int(sb.count) == 1
    named_a = dict(a.named_parameters())
    for name, p in b.named_parameters():
        _same(p.detach(), named_a[name].detach())
    leaves, named_b = convert.stacked_leaves(b), dict(b.named_parameters())
    for path, names in convert.reference_leaves(cfg):
        rows = list(leaves[path]) if path.startswith("blocks/") \
            else [leaves[path]]
        assert [named_b[n].data_ptr() for n in names] == \
            [r.data_ptr() for r in rows], path
    a, sa, ma = step(a, sa, data.batch(1))
    b, sb, mb = step(b, sb, data.batch(1))
    assert float(ma["loss"]) == float(mb["loss"])
    for (ka, la), (kb, lb) in zip(TC.flatten(checkpoint_state(a, sa)).items(),
                                  TC.flatten(checkpoint_state(b, sb)).items()):
        assert ka == kb
        _same(la, lb)
