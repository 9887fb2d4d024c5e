"""repro_torch.analysis — AST-based invariant checker for the port's
runtime (``src/repro_torch``), held to the same ``docs/`` spec as the
reference's copy.

Five hand-maintained invariant surfaces, five rules (see
``docs/analysis.md`` for the catalog):

* **RA1** wire-codec conformance (``core/messages.py``)
* **RA2** event-schema conformance (``EVENT_TYPES`` vs publish sites
  vs ``docs/events.md``)
* **RA3** meter drift (stats surfaces vs ``docs/meters.md``)
* **RA4** blocking calls inside ``async def`` bodies
* **RA5** lock discipline (``ObjectStore`` / ``ServerCore`` state)

Pure stdlib + source parsing: the checker never imports the modules it
lints, so it runs in a bare interpreter and in CI before dependencies
are installed (it imports no torch).  Entry point:
``python -m repro_torch.analysis``; programmatic use via
:func:`repro_torch.analysis.engine.run_rules`.
"""
from repro_torch.analysis.engine import (DEFAULT_ALLOWLIST, Finding,
                                         rule_ids, rule_titles, run_rules)

__all__ = ["DEFAULT_ALLOWLIST", "Finding", "rule_ids", "rule_titles",
           "run_rules"]
