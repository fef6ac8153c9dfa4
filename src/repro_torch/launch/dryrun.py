"""Single-device dry-run: one step of every (arch x shape) cell on the
``meta`` device.

The counterpart of the reference's ``repro.launch.dryrun``, which lowers
and compiles each cell on abstract inputs.  Here each cell's step runs
eagerly at full width on ``meta`` tensors (``launch.specs``), which have
shapes and dtypes and no storage: nothing is allocated and no card is
needed.  Each cell's record holds:

  * ``memory``: the step's argument bytes (parameters; for a train cell
    the AdamW moments too; caches for a decode cell; the inputs) and its
    output bytes (what it returns that does not alias an argument: the
    port updates parameters, moments and decode caches in place, as the
    reference donates them).  ``temp_size_in_bytes`` is null: XLA's
    temporaries have no counterpart on ``meta``, so the step's transient
    activations are not counted;
  * ``fits_one_h100``: argument plus output bytes against one H100's
    memory (``H100_MEMORY_BYTES``).  With the temporaries uncounted,
    ``False`` is final and ``True`` is a lower bound;
  * ``cost_raw.flops``: the step's FLOPs as ``FlopCounterMode`` counts
    them (matrix products, convolutions and attention: elementwise work
    is not counted), the backward included for a train cell.  An eager
    step runs every layer and every chunk, so the count is the whole
    step's, where XLA counts a loop body once;
  * ``cost_variants`` and ``cost_extrapolated``: the same count at 1 and
    2 periods of depth (``_depth_variant``: the reference's variants,
    the inner chunks set to the sequence), extrapolated linearly to the
    full depth, cost(N) = c1 + (N - 1) (c2 - c1).

There are no collectives and no ``--mesh``: the port runs one device
until ``distributed/sharding.py`` is ported, so ``devices`` is 1 and
``collectives`` is null.  A cell that cannot run on ``meta`` gets
``status: "fail"`` with the error, as in the reference.

Usage (on the CPU):
  python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Optional, Union

from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_IDS, get_config, shape_applicable
from ..models.config import SHAPES_BY_NAME, ModelConfig, ShapeCfg
from ..optim import adamw
from ..train.steps import (init_state, make_decode_step, make_prefill_step,
                           make_train_step)
from . import specs as sp

#: one H100's device memory, ``torch.cuda.get_device_properties(0)
#: .total_memory`` on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
#: (``nvidia-smi --query-gpu=name,power.limit``)
H100_MEMORY_BYTES = 85_017_493_504
H100_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"

#: microbatches of a train cell's step (the reference's mesh plan picks
#: them per mesh; one device takes the batch whole)
TRAIN_MICROBATCHES = 1

TEMP_NOTE = ("not counted: XLA's temporaries have no counterpart on the "
             "meta device, so the step's transient activations are missing")
COLLECTIVES_NOTE = ("none: one device; the port has no sharding until "
                    "distributed/sharding.py is ported")


def _depth_variant(cfg: ModelConfig, n_periods: int,
                   seq_len: int) -> ModelConfig:
    changes = dict(n_layers=n_periods * len(cfg.period),
                   scan_chunk=max(seq_len, 1),
                   loss_chunk=max(seq_len, 1),
                   attn_qchunk=max(seq_len, 1))
    if cfg.is_encdec:
        changes["encoder_layers"] = n_periods
    return cfg.scaled(**changes)


def build_step(cfg: ModelConfig, shape: ShapeCfg):
    """-> (step, args): ``step(*args)`` runs one step of the cell on
    ``meta``; ``args`` are its arguments, the model first."""
    model = sp.abstract_params(cfg)
    dev = sp.META
    if shape.kind == "train":
        opt = init_state(model)     # the parameters become leaf views
        step = make_train_step(
            cfg, lr_fn=adamw.cosine_schedule(3e-4, 100, 10000), remat=True,
            num_microbatches=TRAIN_MICROBATCHES, device=dev)
        return step, (model, opt, sp.train_input_specs(cfg, shape))
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, device=dev),
                (model, sp.prefill_input_specs(cfg, shape)))
    ins = sp.decode_input_specs(cfg, shape)
    dstep = make_decode_step(cfg, device=dev)
    enc_out = ins.get("enc_out")

    def step(model, token, caches, position, enc_out=None):
        return dstep(model, token, caches, position, enc_out=enc_out)
    args = (model, ins["token"], ins["caches"], ins["position"])
    return step, args + ((enc_out,) if enc_out is not None else ())


def _roots(tree):
    """The tensors of ``tree`` by the identity of their storage's owner
    (a view's base)."""
    out = {}
    for t in sp.tensors_of(tree):
        base = t if t._base is None else t._base
        out[id(base)] = base
    return out


def measure_step(cfg: ModelConfig, shape: ShapeCfg) -> dict:
    """One step of the cell on ``meta`` -> {argument and output bytes,
    flops}."""
    step, args = build_step(cfg, shape)
    # a train cell's parameters view the stacked leaves: each counts once
    arg_roots = _roots(args)
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
    new = [t for k, t in _roots(out).items() if k not in arg_roots]
    return {"argument_size_in_bytes": sp.nbytes(list(arg_roots.values())),
            "output_size_in_bytes": sp.nbytes(new),
            "flops": float(fc.get_total_flops())}


def run_cell(arch: str, shape: Union[str, ShapeCfg], *,
             cfg: Optional[ModelConfig] = None,
             with_cost_variants: bool = True) -> dict:
    """The record of one cell (``cfg`` overrides the arch's published
    configuration, e.g. with its SMOKE one)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    rec = {"arch": arch, "shape": shape.name, "devices": 1,
           "kind": shape.kind}
    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = "long_500k requires sub-quadratic attention"
        return rec
    t0 = time.time()
    rec["microbatches"] = TRAIN_MICROBATCHES if shape.kind == "train" else 1
    m = measure_step(cfg, shape)
    rec["trace_s"] = round(time.time() - t0, 1)
    rec["cost_raw"] = {"flops": m["flops"]}
    rec["memory"] = {
        "argument_size_in_bytes": m["argument_size_in_bytes"],
        "output_size_in_bytes": m["output_size_in_bytes"],
        "temp_size_in_bytes": None,
        "temp_note": TEMP_NOTE}
    total = m["argument_size_in_bytes"] + m["output_size_in_bytes"]
    rec["fits_one_h100"] = total <= H100_MEMORY_BYTES
    rec["h100_memory_bytes"] = H100_MEMORY_BYTES
    rec["collectives"] = None
    rec["collectives_note"] = COLLECTIVES_NOTE
    if with_cost_variants:
        var = {n: {"flops": measure_step(
                   _depth_variant(cfg, n, shape.seq_len), shape)["flops"]}
               for n in (1, 2)}
        c1, c2 = var[1]["flops"], var[2]["flops"]
        rec["cost_variants"] = var
        rec["cost_extrapolated"] = {
            "flops": c1 + (cfg.n_periods - 1) * (c2 - c1)}
    rec["status"] = "ok"
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--no-variants", action="store_true",
                    help="skip the depth-1/2 cost-extrapolation runs")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = (tuple(SHAPES_BY_NAME) if (args.all or not args.shape)
              else (args.shape,))
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            tag = f"{arch}__{shape_name}"
            path = out / f"{tag}.json"
            if path.exists():
                print(f"[cached ] {tag}")
                continue
            try:
                rec = run_cell(arch, shape_name,
                               with_cost_variants=not args.no_variants)
                if rec["status"] == "ok":
                    n_ok += 1
                    print(f"[ok {rec['trace_s']:6.1f}s] {tag} "
                          f"flops={rec['cost_raw']['flops']:.3g} "
                          f"fits_one_h100={rec['fits_one_h100']}")
                else:
                    n_skip += 1
                    print(f"[skip   ] {tag}: {rec.get('reason')}")
            except Exception as e:
                n_fail += 1
                rec = {"arch": arch, "shape": shape_name, "devices": 1,
                       "status": "fail",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                print(f"[FAIL   ] {tag}: {type(e).__name__}: "
                      f"{str(e)[:200]}")
            path.write_text(json.dumps(rec, indent=1))
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")


if __name__ == "__main__":
    main()
