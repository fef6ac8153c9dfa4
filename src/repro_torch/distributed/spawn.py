"""Start a group of ranks as fresh interpreters and collect their results.

    from repro_torch.distributed import spawn
    outs = spawn.run_ranks("mypkg.work:fn", 4, workdir="build/ranks",
                           kwargs={"steps": 2}, timeout=300)

Each rank is ``python -m repro_torch.distributed.spawn <spec>``: it joins
a process group over a ``file://`` store in ``workdir`` (no TCP port, so
groups started side by side never collide), calls ``fn(group, **kwargs)``
and saves what it returns with ``torch.save`` (tensors on the host).
The parent waits for every rank under one timeout.  A rank that exits
nonzero, or a timeout, stops every rank of the group and raises
``RankFailure`` with the tail of the failing rank's output: the parent
never goes on with part of a group.  Fresh interpreters, never ``fork``:
a parent that has started CUDA cannot fork a child that uses it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence

import torch

#: the directory holding the ``repro_torch`` package
_SRC = str(Path(__file__).resolve().parents[2])


class RankFailure(RuntimeError):
    """A rank of a spawned group failed or ran out of time."""


def _tail(path: Path, nbytes: int = 4000) -> str:
    try:
        data = path.read_bytes()
    except OSError:
        return ""
    return data[-nbytes:].decode(errors="replace")


def run_ranks(target: str, world_size: int, *, workdir,
              kwargs: Optional[dict] = None, backend: str = "gloo",
              timeout: float = 600.0, threads: Optional[int] = None,
              paths: Sequence[str] = ()) -> List:
    """Run ``target`` ("module:function") on ``world_size`` fresh ranks ->
    the list of their return values, in rank order.

    ``workdir`` is created and holds the store, each rank's arguments,
    output and result.  ``threads`` sets each rank's torch threads (and
    ``OMP_NUM_THREADS``).  ``paths`` go in front of each rank's
    ``sys.path`` besides the port's own directory."""
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    if store.exists():
        store.unlink()
    torch.save(kwargs or {}, work / "kwargs.pt")
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [*paths, _SRC] + ([child_env["PYTHONPATH"]]
                          if child_env.get("PYTHONPATH") else []))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        child_env.pop(k, None)
    if threads is not None:
        child_env["OMP_NUM_THREADS"] = str(threads)
    procs = []
    for rank in range(world_size):
        spec = {"target": target, "rank": rank, "world_size": world_size,
                "init_method": store.resolve().as_uri(),
                "backend": backend, "kwargs": str(work / "kwargs.pt"),
                "out": str(work / f"rank{rank}.pt"), "threads": threads}
        spec_path = work / f"rank{rank}.json"
        spec_path.write_text(json.dumps(spec))
        out = open(work / f"rank{rank}.log", "wb")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.distributed.spawn",
             str(spec_path)], stdout=out, stderr=subprocess.STDOUT,
            env=child_env), out))
    deadline = time.monotonic() + timeout
    failure = None
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r = bad[0]
                failure = (f"rank {r} of {world_size} ({target}) exited "
                           f"with code {codes[r]}")
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                late = [r for r, c in enumerate(codes) if c is None]
                failure = (f"ranks {late} of {world_size} ({target}) ran "
                           f"past the {timeout:.0f} s timeout")
                r = late[0]
                break
            time.sleep(0.05)
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            out.close()
    if failure is not None:
        raise RankFailure(f"{failure}; its output ends with:\n"
                          + _tail(work / f"rank{r}.log"))
    return [torch.load(work / f"rank{rank}.pt", weights_only=False)
            for rank in range(world_size)]


def _worker(spec_path: str) -> int:
    import importlib

    from . import comm
    spec = json.loads(Path(spec_path).read_text())
    if spec["threads"] is not None:
        torch.set_num_threads(int(spec["threads"]))
    group = comm.init_group(spec["backend"], init_method=spec["init_method"],
                            rank=spec["rank"],
                            world_size=spec["world_size"])
    module, fn_name = spec["target"].split(":")
    fn = getattr(importlib.import_module(module), fn_name)
    kwargs = torch.load(spec["kwargs"], weights_only=False)
    result = fn(group, **kwargs)
    torch.save(result, spec["out"])
    comm.barrier(group)
    comm.destroy_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
