"""The port's invariant checker (``repro_torch.analysis``), static half,
against the reference's (``repro.analysis``).

Each rule's fixture tree (``tests/fixtures/analysis/<rule>/``) is copied
with ``src/repro/`` moved to ``src/repro_torch/``: the port's checker must
flag exactly its ``EXPECT:`` lines and give the reference checker's
findings on the original tree, path for path once mapped.  The port's own
tree is clean under its allowlist and, with the allowlist off, shows the
same six keys the reference's tree shows under the reference's.  The
allowlist machinery, pragmas, the JSON format and the command line are
held as ``tests/test_analysis.py`` holds the reference's."""
from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import engine as jengine
from repro_torch.analysis import engine

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
RULES = ("RA1", "RA2", "RA3", "RA4", "RA5", "RA6", "RA7", "RA8")

_EXPECT = re.compile(r"EXPECT:(RA\d)\b")


def _port_path(s: str) -> str:
    return s.replace("src/repro/", "src/repro_torch/")


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """Every rule's fixture tree with ``src/repro`` renamed
    ``src/repro_torch``: {rule: root}."""
    base = tmp_path_factory.mktemp("fixtures")
    out = {}
    for rule in RULES:
        dst = base / rule.lower()
        shutil.copytree(FIXTURES / rule.lower(), dst)
        (dst / "src" / "repro").rename(dst / "src" / "repro_torch")
        out[rule] = dst
    return out


def expected_lines(root: Path, rule: str) -> set[tuple[str, int]]:
    """``(relpath, lineno)`` of every EXPECT marker for ``rule``."""
    out = set()
    for p in sorted(root.rglob("*")):
        if p.suffix not in (".py", ".md"):
            continue
        for i, line in enumerate(p.read_text().splitlines(), start=1):
            for m in _EXPECT.finditer(line):
                if m.group(1) == rule:
                    out.add((p.relative_to(root).as_posix(), i))
    return out


def _as_rows(findings, mapper=lambda s: s):
    return sorted((f.rule, mapper(f.key), mapper(f.path), f.line,
                   f.severity, mapper(f.message)) for f in findings)


# ---------------------------------------------------------------------------
# each rule on its mapped fixture: the marked lines, the reference's findings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", RULES)
def test_rule_flags_mapped_fixture_as_the_reference(rule, mapped):
    root = mapped[rule]
    want = expected_lines(root, rule)
    assert want, f"fixture for {rule} has no EXPECT markers"
    findings, n_suppressed = engine.run_rules(root, [rule], allowlist=None)
    assert n_suppressed == 0
    assert all(f.rule == rule for f in findings)
    got = {(f.path, f.line) for f in findings}
    assert got == want, (
        f"{rule} drifted from its fixture:\n"
        f"  missed:   {sorted(want - got)}\n"
        f"  spurious: {sorted(got - want)}")
    ref, _ = jengine.run_rules(FIXTURES / rule.lower(), [rule],
                               allowlist=None)
    assert _as_rows(findings) == _as_rows(ref, _port_path)


@pytest.mark.parametrize("rule", RULES)
def test_rule_findings_carry_stable_keys(rule, mapped):
    findings, _ = engine.run_rules(mapped[rule], [rule], allowlist=None)
    assert findings
    for f in findings:
        assert f.key and f.key.startswith(rule + ":")
        assert f.severity == "error"
        if rule != "RA4":   # RA4's key ends with the line by design
            assert str(f.line) not in f.key.split(":"), \
                f"line number leaked into key {f.key!r}"


def test_registry_matches_the_reference():
    assert engine.rule_ids() == jengine.rule_ids() == list(RULES)
    assert engine.rule_titles() == jengine.rule_titles()


# ---------------------------------------------------------------------------
# the port's tree
# ---------------------------------------------------------------------------

def test_port_tree_is_clean():
    findings, n_suppressed = engine.run_rules(REPO)
    assert findings == [], "\n" + engine.format_text(
        findings, n_suppressed, list(RULES))
    allow, problems = engine.load_allowlist(engine.DEFAULT_ALLOWLIST)
    raw, _ = engine.run_rules(REPO, allowlist=None)
    assert problems == []
    assert n_suppressed == sum(f.key in allow for f in raw) >= len(allow)


def test_port_findings_without_allowlist_are_the_reference_keys():
    """With suppression off the port's tree shows exactly its allowlist's
    keys, which are the reference allowlist's keys and the keys the
    reference's tree shows."""
    allow, _ = engine.load_allowlist(engine.DEFAULT_ALLOWLIST)
    jallow, _ = jengine.load_allowlist(jengine.DEFAULT_ALLOWLIST)
    findings, n_suppressed = engine.run_rules(REPO, allowlist=None)
    ref, _ = jengine.run_rules(REPO, allowlist=None)
    assert n_suppressed == 0
    assert {f.key for f in findings} == set(allow) == set(jallow) \
        == {f.key for f in ref}
    assert len(allow) == 6
    assert all("docs/events.md" in why for why in allow.values())
    # the copy's lines differ from the reference's by its docstrings
    assert [r[:3] + r[4:] for r in _as_rows(findings)] == \
        [r[:3] + r[4:] for r in _as_rows(ref, _port_path)]


def test_port_scans_only_the_port():
    """Every surface the rules read is under ``src/repro_torch`` or
    ``docs/``; none is the reference's."""
    from repro_torch.analysis import (ra1_wire, ra2_events, ra3_meters,
                                      ra4_async, ra5_locks, ra6_protocol,
                                      ra7_invariants, ra8_protocol_docs)
    paths = [ra1_wire.MESSAGES, ra2_events.EVENTS, *ra2_events.SCAN,
             *ra2_events.OPTIONAL_SCAN,
             ra3_meters.SERVER, ra3_meters.REACTOR, ra3_meters.RUNTIME,
             ra4_async.SCAN_DIR, ra5_locks.STORE, ra5_locks.SERVER,
             ra6_protocol.PROTOCOL, ra6_protocol.EVENTS,
             ra7_invariants.PROTOCOL, ra7_invariants.TRACE,
             ra8_protocol_docs.PROTOCOL]
    for p in paths:
        assert p == "src/repro_torch" or p.startswith("src/repro_torch/"), p
        assert (REPO / p).exists(), p
    assert engine.DEFAULT_ALLOWLIST == (
        REPO / "src" / "repro_torch" / "analysis" / "allowlist.txt")


def test_missing_surface_names_the_port(tmp_path):
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    findings, _ = engine.run_rules(tmp_path, ["RA1"], allowlist=None)
    assert [f.key for f in findings] == [
        "RA1:missing-file:src/repro_torch/core/messages.py"]
    assert "repro_torch.analysis" in findings[0].message


# ---------------------------------------------------------------------------
# allowlist machinery and pragmas
# ---------------------------------------------------------------------------

def test_allowlist_suppresses_by_stable_key(tmp_path, mapped):
    allowfile = tmp_path / "allow.txt"
    allowfile.write_text(
        "# comment\n\n"
        "RA1:direction:OP_MYSTERY -- fixture op, direction is a test\n")
    base, _ = engine.run_rules(mapped["RA1"], ["RA1"], allowlist=None)
    kept, n_suppressed = engine.run_rules(mapped["RA1"], ["RA1"],
                                          allowlist=allowfile)
    assert n_suppressed == 1
    assert len(kept) == len(base) - 1
    assert "RA1:direction:OP_MYSTERY" not in {f.key for f in kept}


def test_allowlist_entry_without_justification_is_a_finding(tmp_path,
                                                            mapped):
    allowfile = tmp_path / "allow.txt"
    allowfile.write_text("RA1:direction:OP_MYSTERY\n")
    kept, n_suppressed = engine.run_rules(mapped["RA1"], ["RA1"],
                                          allowlist=allowfile)
    assert n_suppressed == 0
    bad = [f for f in kept if f.rule == "RA0"]
    assert len(bad) == 1 and bad[0].line == 1
    assert "justification" in bad[0].message


def test_unused_allowlist_entry_warns_only_for_rules_that_ran(tmp_path,
                                                              mapped):
    allowfile = tmp_path / "allow.txt"
    allowfile.write_text("RA2:unknown-type:nope -- long gone\n")
    kept, _ = engine.run_rules(mapped["RA1"], ["RA1"], allowlist=allowfile)
    assert not any(f.rule == "RA0" for f in kept)
    kept, _ = engine.run_rules(mapped["RA2"], ["RA2"], allowlist=allowfile)
    stale = [f for f in kept if f.key == "RA0:unused:RA2:unknown-type:nope"]
    assert len(stale) == 1 and stale[0].severity == "warn"


def test_pragma_applies_to_own_line_and_line_above():
    sf = engine.SourceFile("x.py", (
        "# ra: allow-blocking\n"
        "a = f()\n"
        "b = g()  # ra: allow-blocking\n"
        "\n"
        "c = h()\n"))
    by_line = {c.lineno: c for c in ast.walk(sf.tree)
               if isinstance(c, ast.Call)}
    assert sf.pragma_for(by_line[2], "allow-blocking") is not None
    assert sf.pragma_for(by_line[3], "allow-blocking") is not None
    assert sf.pragma_for(by_line[5], "allow-blocking") is None
    assert sf.pragma_for(by_line[2], "event-types") is None


def test_json_format_equals_the_reference(mapped):
    findings, n_suppressed = engine.run_rules(mapped["RA1"], ["RA1"],
                                              allowlist=None)
    blob = json.loads(engine.format_json(findings, n_suppressed, ["RA1"]))
    assert blob["n_findings"] == len(findings) > 0
    assert blob["n_suppressed"] == 0
    assert blob["findings"][0].keys() == {
        "rule", "path", "line", "message", "severity", "key"}
    ref, _ = jengine.run_rules(FIXTURES / "ra1", ["RA1"], allowlist=None)
    assert _port_path(jengine.format_json(ref, 0, ["RA1"])) == \
        engine.format_json(findings, 0, ["RA1"])


# ---------------------------------------------------------------------------
# the command line: python -m repro_torch.analysis
# ---------------------------------------------------------------------------

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})


def test_cli_clean_tree_exits_zero():
    proc = _cli("--format", "json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    blob = json.loads(proc.stdout)
    assert blob["n_findings"] == 0 and blob["n_suppressed"] >= 6


def test_cli_dirty_tree_exits_one(mapped):
    proc = _cli("--root", str(mapped["RA1"]), "--rules", "RA1",
                "--allowlist", "none")
    assert proc.returncode == 1
    assert "RA1" in proc.stdout and "src/repro_torch/core/messages.py" \
        in proc.stdout


def test_cli_rejects_bad_use():
    assert _cli("--rules", "RA9").returncode == 2
    # the reference's fixture has no src/repro_torch: not a checkout
    assert _cli("--root", str(FIXTURES / "ra1")).returncode == 2
    assert _cli("--root", str(FIXTURES / "ra2" / "docs")).returncode == 2
    assert _cli("--trace", "x.jsonl", "--rules", "RA6").returncode == 2


def test_cli_list_rules():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    for rid in RULES:
        assert rid in proc.stdout
