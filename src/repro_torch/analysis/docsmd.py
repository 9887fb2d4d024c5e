"""Markdown helpers: parse the authoritative tables in ``docs/``.

`docs/events.md` and `docs/meters.md` declare their schemas as GitHub
tables whose first column is a backticked key.  The conformance rules
(RA2/RA3) parse those tables here and diff them against the code — so
the docs are an enforced contract, not prose that drifts.
"""
from __future__ import annotations

import dataclasses
import re

_ROW_RE = re.compile(r"^\s*\|(.+)\|\s*$")
_TICKED = re.compile(r"`([^`]+)`")
_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_-]*$")


@dataclasses.dataclass
class Row:
    key: str                 # first backticked cell, backticks stripped
    cells: list[str]         # raw cell text, including the first
    line: int                # 1-based line in the doc

    def ticked_fields(self, col: int) -> list[str]:
        """Backticked identifier tokens in cell ``col`` — the field
        list convention used by the docs tables (parenthetical notes
        stay outside backticks, so they are not picked up)."""
        if col >= len(self.cells):
            return []
        return [t for t in _TICKED.findall(self.cells[col])
                if _IDENT.match(t)]


def split_sections(text: str) -> list[tuple[str, int, list[str]]]:
    """``(heading, heading_line, body_lines)`` per ``##``-level section
    (sub-headings stay inside their parent's body)."""
    sections: list[tuple[str, int, list[str]]] = []
    heading, start, body = "", 1, []
    for i, ln in enumerate(text.splitlines(), start=1):
        if ln.startswith("## ") and not ln.startswith("###"):
            if heading or body:
                sections.append((heading, start, body))
            heading, start, body = ln[3:].strip(), i, []
        else:
            body.append(ln)
    sections.append((heading, start, body))
    return sections


def table_rows(body: list[str], first_line: int) -> list[Row]:
    """Data rows of every table in ``body``: skips header and ``---``
    separator rows, keeps only rows whose first cell is a single
    backticked key."""
    rows: list[Row] = []
    for off, ln in enumerate(body):
        m = _ROW_RE.match(ln)
        if not m:
            continue
        cells = [c.strip() for c in m.group(1).split("|")]
        if not cells or set(cells[0]) <= {"-", ":", " "}:
            continue                      # |---|---| separator
        first = _TICKED.findall(cells[0])
        if len(first) != 1 or cells[0] != f"`{first[0]}`":
            continue                      # header row / prose cell
        rows.append(Row(first[0], cells, first_line + off))
    return rows


def section_rows(text: str, heading_substr: str) -> list[Row] | None:
    """Rows of all tables under the first ``##`` section whose heading
    contains ``heading_substr``; None when no such section exists."""
    for heading, line, body in split_sections(text):
        if heading_substr in heading:
            return table_rows(body, line + 1)
    return None
