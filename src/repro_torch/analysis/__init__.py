"""Static analysis of the port's determinism contract.

Layer 1 (``repro_torch.analysis.rules``): AST lint rules DET001–DET006
over ``src/repro_torch`` — raw reductions outside the front door, folds
in an order the toolchain picks inside the fold paths, accumulating
scatters, draws from the global generator in serving code, registry hook
drift, float count arithmetic.

Layer 2 (``repro_torch.analysis.contracts``): DET101–DET105 — run every
registered policy × backend × op on canonical inputs and check carry
dtypes, integer-only ``merge_is_add`` carries, the nvcc flags that stand
for the fold barrier, the aten ops of the integer tiers across block
sizes, and coverage of the whole matrix.

CLI: ``python tools/detlint_torch.py`` (``--check-waivers`` adds the
waiver ratchet).
"""

from .walker import (  # noqa: F401
    SourceModule,
    iter_source_files,
    parse_module,
    parse_source,
    repo_root,
    resolve_symbol,
    symbol_origin,
    symbol_origin_ok,
    symbol_resolves,
)
from .rules import (  # noqa: F401
    ALL_RULE_IDS,
    AST_RULES,
    Finding,
    LintRule,
    TOLERATED_FLOAT_MERGE,
    check_registries,
    run_lint,
)

__all__ = [
    "ALL_RULE_IDS",
    "AST_RULES",
    "Finding",
    "LintRule",
    "SourceModule",
    "TOLERATED_FLOAT_MERGE",
    "check_registries",
    "iter_source_files",
    "parse_module",
    "parse_source",
    "repo_root",
    "resolve_symbol",
    "run_contracts",
    "symbol_origin",
    "symbol_origin_ok",
    "symbol_resolves",
    "run_lint",
]


def run_contracts(*args, **kwargs):
    """Lazy forwarder: ``repro_torch.analysis.contracts`` loads the live
    registries (and torch), which the pure-AST layer must not require."""
    from . import contracts
    return contracts.run_contracts(*args, **kwargs)
