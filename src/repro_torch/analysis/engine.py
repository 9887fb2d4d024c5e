"""Shared machinery for the invariant checker: findings, source files,
pragmas, the allowlist, the rule registry and the runner.

Everything here works on *source text* — rules parse the repo with
:mod:`ast` and never import runtime modules, so the checker runs in a
bare interpreter (no numpy/msgpack needed) and can lint code whose
imports would fail.

Suppression has two layers, used for different things:

* **pragmas** — in-source comments for per-site decisions the code
  itself should document: ``# ra: allow-blocking`` (RA4) and
  ``# ra: event-types a,b`` (RA2 dynamic publish sites).  A pragma on
  the flagged line, the line above, or any line of a multi-line
  statement applies.
* **allowlist file** — repo-level intentional exceptions, one stable
  finding key per line with a mandatory ``--`` justification.  Entries
  that no longer match anything become warnings, so the list cannot
  accumulate dead weight silently.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path

SEVERITIES = ("error", "warn")

_PRAGMA_RE = re.compile(r"#\s*ra:\s*(.+?)\s*$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation, pointing at a source (or docs) line.

    ``key`` is the stable identity used by the allowlist: it names the
    *invariant instance* (rule, surface, symbol), never a line number,
    so moving code around does not invalidate suppressions.
    """
    rule: str                 # "RA1".."RA5" or "RA0" (checker-internal)
    path: str                 # repo-relative, "/"-separated
    line: int                 # 1-based; 0 = whole file
    message: str
    severity: str = "error"
    key: str = ""

    @property
    def where(self) -> str:
        return f"{self.path}:{self.line}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "severity": self.severity,
                "key": self.key}


class SourceFile:
    """One parsed repo file: AST, raw lines and ``# ra:`` pragmas."""

    def __init__(self, rel: str, text: str):
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=rel)
        # line -> pragma payload ("allow-blocking", "event-types a,b")
        self.pragmas: dict[int, str] = {}
        for i, ln in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(ln)
            if m:
                self.pragmas[i] = m.group(1)

    def line(self, n: int) -> str:
        return self.lines[n - 1] if 1 <= n <= len(self.lines) else ""

    def pragma_for(self, node: ast.AST, name: str) -> str | None:
        """Pragma ``name`` applying to ``node``: on any line the node
        spans, or on the line directly above it."""
        lo = getattr(node, "lineno", 0)
        hi = getattr(node, "end_lineno", lo) or lo
        for n in range(lo - 1, hi + 1):
            p = self.pragmas.get(n)
            if p is not None and p.split()[0] == name:
                return p[len(name):].strip()
        return None


class Project:
    """Lazy, cached access to repo files for the rules."""

    def __init__(self, root: str | Path):
        self.root = Path(root).resolve()
        self._cache: dict[str, SourceFile | None] = {}

    def path(self, rel: str) -> Path:
        return self.root / rel

    def text(self, rel: str) -> str | None:
        p = self.path(rel)
        if not p.is_file():
            return None
        return p.read_text(encoding="utf-8")

    def source(self, rel: str) -> SourceFile | None:
        if rel not in self._cache:
            text = self.text(rel)
            self._cache[rel] = (None if text is None
                                else SourceFile(rel, text))
        return self._cache[rel]

    def walk_py(self, rel_dir: str) -> list[str]:
        base = self.path(rel_dir)
        if not base.is_dir():
            return []
        return sorted(p.relative_to(self.root).as_posix()
                      for p in base.rglob("*.py"))

    def missing(self, rule: str, rel: str) -> Finding:
        return Finding(rule, rel, 0,
                       f"expected file is missing (the {rule} surface "
                       f"moved without updating repro_torch.analysis)",
                       key=f"{rule}:missing-file:{rel}")


# ---------------------------------------------------------------------------
# small AST helpers shared by several rules
# ---------------------------------------------------------------------------

def top_level_class(tree: ast.Module, name: str) -> ast.ClassDef | None:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def top_level_func(tree: ast.Module, name: str) -> ast.FunctionDef | None:
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def class_method(cls: ast.ClassDef, name: str):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def name_refs(node: ast.AST) -> set[str]:
    """Every bare ``Name`` referenced anywhere under ``node``."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def dict_literal_keys(node: ast.Dict) -> list[tuple[str, int]]:
    out = []
    for k in node.keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            out.append((k.value, k.lineno))
    return out


def returned_dict_keys(fn: ast.AST) -> list[tuple[str, int]]:
    """Keys of dict literals (or ``dict(k=...)`` calls) returned by
    ``fn``, with their line numbers."""
    out: list[tuple[str, int]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        v = node.value
        if isinstance(v, ast.Dict):
            out.extend(dict_literal_keys(v))
        elif isinstance(v, ast.Call) and isinstance(v.func, ast.Name) \
                and v.func.id == "dict":
            out.extend((kw.arg, kw.value.lineno) for kw in v.keywords
                       if kw.arg is not None)
    return out


def is_self_attr(node: ast.AST, attrs: set[str] | None = None,
                 base: str = "self") -> str | None:
    """``self.X`` -> ``"X"`` (when X in ``attrs``, if given)."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == base:
        if attrs is None or node.attr in attrs:
            return node.attr
    return None


# ---------------------------------------------------------------------------
# allowlist
# ---------------------------------------------------------------------------

DEFAULT_ALLOWLIST = Path(__file__).with_name("allowlist.txt")


def load_allowlist(path: str | Path | None) -> tuple[dict[str, str],
                                                     list[Finding]]:
    """Parse ``key -- justification`` lines; malformed entries are
    findings (an exception without a reason is not an exception)."""
    allow: dict[str, str] = {}
    problems: list[Finding] = []
    if path is None:
        return allow, problems
    p = Path(path)
    if not p.is_file():
        return allow, problems
    rel = p.name
    for i, raw in enumerate(p.read_text(encoding="utf-8").splitlines(),
                            start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        key, sep, why = line.partition(" -- ")
        key, why = key.strip(), why.strip()
        if not sep or not why:
            problems.append(Finding(
                "RA0", rel, i,
                f"allowlist entry {key!r} has no ' -- justification'",
                key=f"RA0:allowlist-format:{i}"))
            continue
        allow[key] = why
    return allow, problems


# ---------------------------------------------------------------------------
# registry + runner
# ---------------------------------------------------------------------------

def _registry() -> dict:
    from repro_torch.analysis import (ra1_wire, ra2_events, ra3_meters,
                                ra4_async, ra5_locks, ra6_protocol,
                                ra7_invariants, ra8_protocol_docs)
    return {
        "RA1": (ra1_wire.check, ra1_wire.TITLE),
        "RA2": (ra2_events.check, ra2_events.TITLE),
        "RA3": (ra3_meters.check, ra3_meters.TITLE),
        "RA4": (ra4_async.check, ra4_async.TITLE),
        "RA5": (ra5_locks.check, ra5_locks.TITLE),
        "RA6": (ra6_protocol.check, ra6_protocol.TITLE),
        "RA7": (ra7_invariants.check, ra7_invariants.TITLE),
        "RA8": (ra8_protocol_docs.check, ra8_protocol_docs.TITLE),
    }


def rule_ids() -> list[str]:
    return sorted(_registry())


def rule_titles() -> dict[str, str]:
    return {rid: title for rid, (_, title) in _registry().items()}


def run_rules(root: str | Path, rules: list[str] | None = None,
              allowlist: str | Path | None = DEFAULT_ALLOWLIST
              ) -> tuple[list[Finding], int]:
    """Run ``rules`` (default: all) against the repo at ``root``.

    Returns ``(findings, n_suppressed)``: findings that survived the
    allowlist (sorted rule, path, line) and the suppressed count.
    Unused allowlist entries surface as ``warn`` findings.
    """
    reg = _registry()
    ids = rule_ids() if rules is None else list(rules)
    unknown = [r for r in ids if r not in reg]
    if unknown:
        raise ValueError(f"unknown rule ids: {unknown} "
                         f"(have {rule_ids()})")
    project = Project(root)
    found: list[Finding] = []
    for rid in ids:
        found.extend(reg[rid][0](project))
    allow, problems = load_allowlist(allowlist)
    kept = [f for f in found if f.key not in allow]
    n_suppressed = len(found) - len(kept)
    used = {f.key for f in found if f.key in allow}
    kept.extend(problems)
    for key in sorted(set(allow) - used):
        # only report unused entries for the rules that actually ran,
        # so `--rules RA1` does not flag RA2's entries as stale
        if key.split(":", 1)[0] in ids:
            kept.append(Finding(
                "RA0", Path(str(allowlist)).name, 0,
                f"allowlist entry {key!r} matches no finding "
                f"(fixed? delete the entry)", severity="warn",
                key=f"RA0:unused:{key}"))
    kept.sort(key=lambda f: (f.rule, f.path, f.line, f.message))
    return kept, n_suppressed


# ---------------------------------------------------------------------------
# output
# ---------------------------------------------------------------------------

def format_text(findings: list[Finding], n_suppressed: int,
                rules: list[str]) -> str:
    out = []
    for f in findings:
        out.append(f"{f.rule} {f.severity:5s} {f.where}  {f.message}"
                   + (f"  [{f.key}]" if f.key else ""))
    out.append(f"{len(findings)} finding(s) from {', '.join(rules)}"
               f" ({n_suppressed} allowlisted)")
    return "\n".join(out)


def format_json(findings: list[Finding], n_suppressed: int,
                rules: list[str]) -> str:
    return json.dumps({
        "rules": rules,
        "n_findings": len(findings),
        "n_suppressed": n_suppressed,
        "findings": [f.as_dict() for f in findings],
    }, indent=2, sort_keys=True)
