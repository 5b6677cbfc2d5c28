"""Result model for the kernel-contract linter (twin of
``repro.analysis.report``): ``Violation`` (one broken invariant at one
site) and ``Report`` (the full run: every (site, rule) pair checked, plus
the violations), with its JSON round trip."""
from __future__ import annotations

import dataclasses
import json
from typing import List, Tuple

__all__ = ["Violation", "Report"]


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant broken at one site.

    ``rule`` is the registered rule name (``fusion-contract``, ...),
    ``site`` the site name it fired on, ``message`` the human-readable
    account of what the recorded evidence (aten ops, launch and rotation
    counters, PTX, shared-memory attributes, cache pointers) showed
    against the contract."""

    rule: str
    site: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.site}: {self.message}"


@dataclasses.dataclass
class Report:
    """Outcome of one lint run: ``checked`` lists every (site, rule)
    pair that ran (so a vacuous run -- zero sites built -- is visibly
    different from a clean one), ``violations`` what failed."""

    checked: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    violations: List[Violation] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def merge(self, other: "Report") -> "Report":
        self.checked.extend(other.checked)
        self.violations.extend(other.violations)
        return self

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "checked": [list(c) for c in self.checked],
            "violations": [dataclasses.asdict(v) for v in self.violations],
        }

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 1)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "Report":
        return cls(checked=[tuple(c) for c in d.get("checked", [])],
                   violations=[Violation(**v) for v in d.get("violations", [])])

    @classmethod
    def from_json(cls, text: str) -> "Report":
        return cls.from_dict(json.loads(text))

    def format_text(self) -> str:
        lines = [f"checked {len(self.checked)} (site, rule) pairs"]
        if self.ok:
            lines.append("OK: no contract violations")
        else:
            lines.append(f"{len(self.violations)} violation(s):")
            lines.extend(f"  {v}" for v in self.violations)
        return "\n".join(lines)
