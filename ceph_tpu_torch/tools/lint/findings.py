# Copy of ceph_tpu/tools/lint/findings.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""Finding + suppression-baseline model for tpu-lint.

A finding's identity is ``(check, file, key)`` — deliberately NOT the
line number, so unrelated edits above a baselined site don't stale the
suppression.  ``key`` is the checker-chosen stable handle (a message
name, a config key, a lock name...).  Baseline entries are committed in
``baseline.json`` and every one must carry a non-empty one-line reason;
the lint driver turns entries that suppress nothing into findings, so
the file can only shrink (the reference analog: a suppressions file that
rots is worse than none).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Finding:
    check: str      # family/rule, e.g. "wire-abi/layout-break"
    file: str       # repo-relative path
    line: int
    key: str        # stable identity within (check, file)
    message: str
    suppressed_reason: Optional[str] = None

    @property
    def ident(self) -> str:
        return f"{self.check}::{self.file}::{self.key}"

    def to_json(self) -> Dict:
        out = {"check": self.check, "file": self.file, "line": self.line,
               "key": self.key, "message": self.message}
        if self.suppressed_reason:
            out["suppressed_reason"] = self.suppressed_reason
        return out

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.check}] {self.message}"


@dataclass
class BaselineEntry:
    check: str
    file: str
    key: str
    reason: str

    @property
    def ident(self) -> str:
        return f"{self.check}::{self.file}::{self.key}"


@dataclass
class Baseline:
    entries: List[BaselineEntry] = field(default_factory=list)

    @staticmethod
    def key_of(f: Finding) -> str:
        return f.ident

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not path or not os.path.exists(path):
            return cls()
        with open(path, encoding="utf-8") as fh:
            raw = json.load(fh)
        entries = []
        for e in raw.get("suppressions", []):
            reason = (e.get("reason") or "").strip()
            if not reason:
                raise ValueError(
                    f"baseline entry {e.get('check')}::{e.get('file')}::"
                    f"{e.get('key')} has no reason — every suppression "
                    f"must carry a one-line justification")
            entries.append(BaselineEntry(check=e["check"], file=e["file"],
                                         key=e["key"], reason=reason))
        return cls(entries)

    def match(self, f: Finding) -> Optional[str]:
        for e in self.entries:
            if (e.check == f.check and e.file == f.file
                    and e.key == f.key):
                return e.reason
        return None

    def save(self, path: str) -> None:
        data = {"suppressions": [
            {"check": e.check, "file": e.file, "key": e.key,
             "reason": e.reason}
            for e in sorted(self.entries,
                            key=lambda e: (e.check, e.file, e.key))]}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(data, fh, indent=1, sort_keys=True)
            fh.write("\n")
