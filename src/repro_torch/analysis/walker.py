"""Shared file/AST discovery for the port's static checks.

The port's copy of the reference's ``analysis/walker.py``, with the same
API and the same pragma, so a waiver reads alike in both packages and the
tests hold the two walkers to identical waivers and names.  Its consumers
are the determinism lint (``tools/detlint_torch.py`` ->
``repro_torch.analysis.rules``) and the contract checker
(``repro_torch.analysis.contracts``).

Provides:

  * ``repo_root()`` / ``iter_source_files(roots)`` — the one file
    discovery path (sorted, ``__pycache__``-free, de-duplicated);
  * ``SourceModule`` / ``parse_module`` — a parsed file with its AST,
    source lines, a child->parent node map, and the waiver pragmas;
  * waiver pragmas: ``# detlint: ok[DET001] reason`` (comma-separated
    rule ids) waives findings whose flagged node overlaps the pragma
    line; a pragma on a comment-only line covers the next code line;
  * ``dotted_name(node)`` — "torch.sum" / "torch.distributed.all_reduce"
    for attribute chains (the vocabulary every AST rule matches against);
  * ``resolve_symbol(ref)`` / ``symbol_origin(ref)`` — import +
    attribute chain resolution of a dotted symbol; ``symbol_origin``
    also reports the resolved object's defining module, so a stale
    re-export (a symbol that moved modules but still resolves through a
    package ``__init__``) is caught instead of silently passing.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: directories never scanned, wherever they appear
EXCLUDE_DIRS = {"__pycache__", ".git", ".claude", "experiments"}

#: the waiver pragma: ``# detlint: ok[DET001]`` or
#: ``# detlint: ok[DET001,DET003] why this is fine``
_PRAGMA = re.compile(r"#\s*detlint:\s*ok\[([A-Z0-9,\s]+)\]\s*(.*)$")


def repo_root() -> Path:
    """The repository root (three levels above this file:
    src/repro_torch/analysis)."""
    return Path(__file__).resolve().parents[3]


def iter_source_files(roots: Sequence, *,
                      suffix: str = ".py") -> List[Path]:
    """Every source file under ``roots`` (files or directories), sorted,
    excluding ``EXCLUDE_DIRS`` — the one discovery path shared by the
    linter and the doc checker."""
    seen: Set[Path] = set()
    out: List[Path] = []
    for root in roots:
        root = Path(root)
        if root.is_file():
            candidates: Iterable[Path] = [root]
        else:
            candidates = sorted(root.rglob(f"*{suffix}"))
        for p in candidates:
            rp = p.resolve()
            if rp in seen or any(part in EXCLUDE_DIRS for part in rp.parts):
                continue
            seen.add(rp)
            out.append(p)
    return out


@dataclasses.dataclass
class Waiver:
    """One parsed ``# detlint: ok[...]`` pragma."""

    line: int                      # 1-based line the pragma covers
    rules: Tuple[str, ...]         # rule ids it waives ("*" = all)
    reason: str = ""

    def covers(self, rule: str, lo: int, hi: int) -> bool:
        return (self.line >= lo and self.line <= hi
                and (rule in self.rules or "*" in self.rules))


@dataclasses.dataclass
class SourceModule:
    """A parsed source file plus everything the rules need to judge it."""

    path: Path
    text: str
    tree: ast.AST
    lines: List[str]
    parents: Dict[ast.AST, ast.AST]
    waivers: List[Waiver]

    @property
    def rel(self) -> str:
        try:
            return str(self.path.resolve().relative_to(repo_root()))
        except ValueError:
            return str(self.path)

    def waiver_for(self, rule: str, node: ast.AST) -> Optional[Waiver]:
        """The pragma waiving ``rule`` at ``node``, if any.  A pragma
        waives a finding when its line falls anywhere inside the flagged
        node's [lineno, end_lineno] span (multi-line calls included)."""
        lo = getattr(node, "lineno", 0)
        hi = getattr(node, "end_lineno", lo)
        for w in self.waivers:
            if w.covers(rule, lo, hi):
                return w
        return None

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)


def _parse_waivers(lines: List[str]) -> List[Waiver]:
    waivers = []
    for i, line in enumerate(lines, start=1):
        m = _PRAGMA.search(line)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        # a comment-only pragma line covers the next code line (skipping
        # the rest of its own comment block and blank lines)
        covered = i
        if line.lstrip().startswith("#"):
            covered = i + 1
            while covered <= len(lines) and (
                    not lines[covered - 1].strip()
                    or lines[covered - 1].lstrip().startswith("#")):
                covered += 1
        waivers.append(Waiver(line=covered, rules=rules,
                              reason=m.group(2).strip()))
    return waivers


def parse_source(text: str, path) -> SourceModule:
    """Parse source text into a ``SourceModule`` (also the test seam:
    fixture snippets parse through the same path real files do)."""
    tree = ast.parse(text)
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    lines = text.splitlines()
    return SourceModule(path=Path(path), text=text, tree=tree, lines=lines,
                        parents=parents, waivers=_parse_waivers(lines))


def parse_module(path) -> SourceModule:
    path = Path(path)
    return parse_source(path.read_text(), path)


def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.sum' for Attribute(Name('torch'), 'sum'); None for anything
    that is not a pure Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


# ---------------------------------------------------------------------------
# Dotted-symbol resolution (the doc checker's pinning machinery)
# ---------------------------------------------------------------------------


def resolve_symbol(ref: str):
    """Resolve 'pkg.mod.attr.attr' to (object, import_cut) or None.

    Imports the longest importable module prefix, then walks attributes.
    ``import_cut`` is the dotted module path actually imported — the
    prefix the caller documented the symbol as living under.
    """
    parts = ref.split(".")
    for cut in range(len(parts), 0, -1):
        mod_path = ".".join(parts[:cut])
        try:
            obj = importlib.import_module(mod_path)
        except ImportError:
            continue
        try:
            for attr in parts[cut:]:
                obj = getattr(obj, attr)
        except AttributeError:
            return None
        return obj, mod_path
    return None


def symbol_resolves(ref: str) -> bool:
    return resolve_symbol(ref) is not None


def symbol_origin(ref: str) -> Optional[str]:
    """The defining module (``__module__``) of the resolved object, or
    None when it does not resolve / has no recorded origin."""
    hit = resolve_symbol(ref)
    if hit is None:
        return None
    obj, _ = hit
    return getattr(obj, "__module__", None) or getattr(obj, "__name__", None)


def symbol_origin_ok(ref: str) -> bool:
    """True when ``ref`` resolves AND its defining module lives under the
    documented prefix.

    This is the moved-module guard: ``repro_torch.serve.engine.Engine``
    keeps resolving through a stale package re-export even after ``Engine``
    migrates elsewhere, which a resolution alone would pass.  Here the
    resolved object's ``__module__`` must share the documented parent
    package (``repro_torch.serve...``), so a cross-package move fails the pin
    until the doc is updated.  Objects without a ``__module__``
    (arrays, ints) only need to resolve.
    """
    hit = resolve_symbol(ref)
    if hit is None:
        return False
    obj, cut = hit
    origin = getattr(obj, "__module__", None)
    if origin is None or origin == cut:
        return True
    # documented parent package: everything up to the symbol's module cut,
    # relaxed to the top two components (repro_torch.serve,
    # repro_torch.reduce, ...)
    doc_pkg = ".".join(cut.split(".")[:2])
    return origin == cut or origin.startswith(doc_pkg)
