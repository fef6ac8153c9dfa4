"""detlint for the PyTorch/CUDA port: the determinism-contract analyzer.

Layer 1 lints ``src/repro_torch`` ASTs with the DET001–DET006 rules
(``repro_torch.analysis.rules``); layer 2 runs every registered policy ×
backend × op on canonical inputs and checks the carry, compiler-flag,
invariance and coverage contracts (DET101–DET105,
``repro_torch.analysis.contracts``).  The rule table and the waiver
policy are in the README's section on the port.

    PYTHONPATH=src python tools/detlint_torch.py                 # full run
    PYTHONPATH=src python tools/detlint_torch.py --ast-only      # no runs
    PYTHONPATH=src python tools/detlint_torch.py --check-waivers # + ratchet
    PYTHONPATH=src python tools/detlint_torch.py --write-baseline
    python tools/detlint_torch.py --device cuda                  # on a GPU

Exit status: nonzero on any unwaived finding; ``--check-waivers``
additionally fails when a rule's waiver count rises above
``tools/detlint_torch_baseline.json`` (the ratchet: waivers may only go
down — tighten the baseline when they do).  Rows of the contract matrix
that cannot run on ``--device`` (``cuda`` on the CPU, ``shard_map``
without a process group) are listed as "not run", and fail nothing.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

from repro_torch.analysis import walker, rules  # noqa: E402

BASELINE = REPO / "tools" / "detlint_torch_baseline.json"
DEFAULT_ROOTS = ("src/repro_torch",)


def waiver_counts(findings) -> dict:
    return dict(Counter(f.rule for f in findings if f.waived))


def check_ratchet(counts: dict, baseline: dict):
    """(errors, notes): errors when a rule's waiver count rose above the
    baseline; notes when it fell (tighten the baseline)."""
    errors, notes = [], []
    for rule in sorted(set(counts) | set(baseline)):
        now, base = counts.get(rule, 0), baseline.get(rule, 0)
        if now > base:
            errors.append(
                f"{rule}: {now} waivers > baseline {base} — new waivers "
                f"need a reviewed reason AND a baseline bump in the same "
                f"change (tools/detlint_torch_baseline.json)")
        elif now < base:
            notes.append(
                f"{rule}: {now} waivers < baseline {base} — ratchet down: "
                f"run --write-baseline to lock in the improvement")
    return errors, notes


def lint(paths=None, *, ast_only=False, rule_filter=None, device="cpu"):
    """(files, findings) of one run over ``paths`` (default: the port)."""
    roots = paths or [str(REPO / r) for r in DEFAULT_ROOTS]
    files = walker.iter_source_files(roots)
    findings = rules.run_lint(files, rules=rule_filter)
    if not ast_only and rule_filter is None:
        from repro_torch.analysis import contracts
        findings.extend(contracts.run_contracts(device=device))
    return files, findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="detlint_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--ast-only", action="store_true",
                    help="skip the contract runs (layer 2)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (layer 1)")
    ap.add_argument("--device", default="cpu",
                    help="where the contract matrix runs (cpu or cuda)")
    ap.add_argument("--check-waivers", action="store_true",
                    help="enforce the waiver-count ratchet against "
                         "tools/detlint_torch_baseline.json")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the waiver baseline from this run")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="only print failures")
    args = ap.parse_args(argv)

    rule_filter = (set(r.strip() for r in args.rules.split(","))
                   if args.rules else None)
    files, findings = lint(args.paths, ast_only=args.ast_only,
                           rule_filter=rule_filter, device=args.device)

    unwaived = [f for f in findings if not f.waived and not f.not_run]
    not_run = [f for f in findings if f.not_run]
    counts = waiver_counts(findings)

    for f in unwaived:
        print(f)
    if not args.quiet:
        for why, n in sorted(Counter(f"{f.path.split('/')[1]}: {f.message}"
                                     for f in not_run).items()):
            print(f"not run ({n} rows): {why}")
        waived = [f for f in findings if f.waived]
        per_rule = ", ".join(f"{r}={n}" for r, n in sorted(counts.items()))
        print(f"detlint_torch: {len(files)} files, {len(unwaived)} unwaived "
              f"finding(s), {len(waived)} waived ({per_rule or 'none'}), "
              f"{len(not_run)} not run")

    status = 1 if unwaived else 0

    if args.write_baseline:
        BASELINE.write_text(json.dumps(counts, indent=2, sort_keys=True)
                            + "\n")
        print(f"detlint_torch: baseline written to {BASELINE}")
    elif args.check_waivers:
        baseline = json.loads(BASELINE.read_text()) if BASELINE.exists() \
            else {}
        if args.ast_only:      # the contract rules did not run
            baseline = {k: v for k, v in baseline.items()
                        if not k.startswith("DET1")}
        errors, notes = check_ratchet(counts, baseline)
        for e in errors:
            print(f"detlint_torch ratchet: {e}")
        for n in notes:
            print(f"detlint_torch ratchet (note): {n}")
        if errors:
            status = 1

    return status


if __name__ == "__main__":
    sys.exit(main())
