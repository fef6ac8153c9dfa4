"""repro_torch.testing.faults held against repro.testing.faults, and the
port's recovery from each fault.

Storage faults in a snapshot (a flipped bit, a truncated shard) are
caught by the CRC sidecar and ``restore_latest_valid`` falls back to the
step before; a process killed between the shard write and the rename
leaves a ``.tmp`` directory that is never restored; and the failover
drill — ``python -m repro_torch.launch.train`` crashed at step 6 and
restarted — ends on the uninterrupted run's loss, also when the newest
snapshot has a flipped bit.  The drill runs stablelm's SMOKE config on
the CPU, a few seconds a run.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.testing import faults as JF  # noqa: E402
from repro_torch.ckpt import checkpoint as TC  # noqa: E402
from repro_torch.testing import faults as TF  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"),
                OMP_NUM_THREADS="1")


def _tree(shift=0.0):
    return {"w": torch.arange(12.0).reshape(3, 4) + shift,
            "b": torch.ones(4) * (1.0 + shift)}


def test_flip_bit_and_truncate_as_the_reference(tmp_path):
    """The same offset and bit as the reference's for a (size, seed),
    and the same file after; truncation to the same size."""
    blob = np.random.RandomState(0).bytes(10_001)
    for seed in (0, 1, 7):
        a, b = tmp_path / f"a{seed}", tmp_path / f"b{seed}"
        a.write_bytes(blob)
        b.write_bytes(blob)
        assert JF.flip_bit(a, seed=seed) == TF.flip_bit(b, seed=seed)
        assert a.read_bytes() == b.read_bytes() != blob
        assert JF.truncate_file(a, frac=0.3) == TF.truncate_file(b, frac=0.3)
        assert a.read_bytes() == b.read_bytes()
    (tmp_path / "empty").write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        TF.flip_bit(tmp_path / "empty")
    assert TF.KILL_EXIT_CODE == JF.KILL_EXIT_CODE == 9


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_corrupt_checkpoint_is_detected_and_falls_back(tmp_path, mode):
    TC.save(tmp_path, 1, _tree(0.0), extra={"next_step": 2})
    TC.save(tmp_path, 2, _tree(1.0), extra={"next_step": 3})
    target = TF.corrupt_checkpoint(tmp_path, 2, mode=mode)
    assert target.name == "shard_00000of00001.msgpack"
    with pytest.raises(TC.CheckpointError, match="CRC32"):
        TC.restore(tmp_path, 2, _tree())
    tree, manifest, step = TC.restore_latest_valid(tmp_path, _tree())
    assert step == 1 and manifest["extra"]["next_step"] == 2
    assert torch.equal(tree["w"], _tree(0.0)["w"])
    with pytest.raises(ValueError, match="bitflip/truncate"):
        TF.corrupt_checkpoint(tmp_path, 1, mode="melt")
    with pytest.raises(FileNotFoundError):
        TF.corrupt_checkpoint(tmp_path, 5)


def test_every_checkpoint_corrupt_raises_structured(tmp_path):
    TC.save(tmp_path, 1, _tree())
    TC.save(tmp_path, 2, _tree())
    TF.corrupt_checkpoint(tmp_path, 1, mode="bitflip")
    TF.corrupt_checkpoint(tmp_path, 2, mode="truncate")
    with pytest.raises(TC.CheckpointError,
                       match="no valid checkpoint among steps") as e:
        TC.restore_latest_valid(tmp_path, _tree())
    assert "step 1" in str(e.value) and "step 2" in str(e.value)


def test_kill_mid_save_orphan_is_never_restored(tmp_path):
    """A real process death between the shard write and the rename: the
    ``.tmp`` directory stays, ``latest_step`` ignores it, and recovery
    resumes from the step before."""
    tree = TF._demo_tree()
    TC.save(tmp_path, 1, tree, extra={"next_step": 2})
    r = subprocess.run([sys.executable, "-m", "repro_torch.testing.faults",
                        "kill-mid-save", str(tmp_path), "2"],
                       capture_output=True, text=True, env=_env(),
                       timeout=300)
    assert r.returncode == TF.KILL_EXIT_CODE, (r.returncode, r.stderr)
    assert "dying before rename" in r.stderr
    assert (tmp_path / "step_00000002.tmp" / "manifest.json").exists()
    assert not (tmp_path / "step_00000002").exists()
    assert TC.latest_step(tmp_path) == 1
    restored, _, step = TC.restore_latest_valid(tmp_path, tree)
    assert step == 1
    for k in tree:
        assert torch.equal(restored[k], tree[k])
    assert TF.main(["nonsense"]) == 2


@pytest.mark.parametrize("kind", ["nan", "inf", "both"])
def test_inject_nonfinite_as_the_reference(kind):
    """numpy in, numpy out: the reference's array; a tensor in: the same
    values as a tensor."""
    rng = np.random.RandomState(3)
    for shape in ((16,), (16, 3)):
        x = rng.randn(*shape).astype(np.float32)
        rows = [1, 4, 5, 11]
        want = JF.inject_nonfinite(x, rows=rows, kind=kind)
        got = TF.inject_nonfinite(x, rows=rows, kind=kind)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert np.array_equal(got, want, equal_nan=True)
        t = TF.inject_nonfinite(torch.from_numpy(x), rows=rows, kind=kind)
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        assert np.array_equal(t.numpy(), want, equal_nan=True)
        assert not np.isnan(x).any()            # the input is untouched
    with pytest.raises(ValueError, match="nan/inf/both"):
        TF.inject_nonfinite(np.ones(3), rows=[0], kind="zero")


def test_failover_drill_resumes_on_the_same_loss(tmp_path):
    """The reference's restart drill on the port, quick enough for every
    run: 10 steps with a snapshot every 3, crashed at step 6 (exit 17)
    and restarted: it resumes ``from step 6 -> next 7`` and its last line
    after ``loss`` equals the uninterrupted run's.  Then the newest
    snapshot (step 9) gets a flipped bit, and a restart resumes from step
    6 and ends on the same loss again."""
    common = [sys.executable, "-m", "repro_torch.launch.train",
              "--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
              "--steps", "10", "--batch", "2", "--seq", "32",
              "--ckpt-every", "3", "--log-every", "1"]

    def run(ckpt_dir, *extra):
        return subprocess.run(common + ["--ckpt-dir", str(ckpt_dir)]
                              + list(extra), capture_output=True, text=True,
                              env=_env(), timeout=300)

    r = run(tmp_path / "a")
    assert r.returncode == 0, r.stderr[-2000:]
    loss_a = r.stdout.strip().splitlines()[-1]
    assert loss_a.startswith("done: 10 steps, final loss")
    assert "[ckpt] saved step 9" in r.stdout

    r1 = run(tmp_path / "b", "--simulate-failure-at", "6")
    assert r1.returncode == 17, r1.stderr[-2000:]
    assert "[ckpt] saved step 6" in r1.stdout
    r2 = run(tmp_path / "b")
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "[restore] resumed from step 6 -> next 7" in r2.stdout
    loss_b = r2.stdout.strip().splitlines()[-1]
    assert loss_b.startswith("done: 3 steps, final loss")
    assert loss_a.split("loss")[-1] == loss_b.split("loss")[-1], \
        (loss_a, loss_b)

    TF.corrupt_checkpoint(tmp_path / "b", 9, mode="bitflip")
    r3 = run(tmp_path / "b")
    assert r3.returncode == 0, r3.stderr[-2000:]
    assert "[restore] resumed from step 6 -> next 7" in r3.stdout
    assert loss_a.split("loss")[-1] == \
        r3.stdout.strip().splitlines()[-1].split("loss")[-1]
