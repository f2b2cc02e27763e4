# Copy of ceph_tpu/tools/lint/__init__.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.  Where the two differ: the lint
# scans the ceph_tpu_torch tree, and its wire-ABI lockfile is its own copy
# of ``corpus/wire/ABI.lock``, ``ABI.lock`` beside ``baseline.json``, so
# ``--update-wire-lock`` never rewrites a file of the reference.
"""tpu-lint: project-invariant static analysis for the ceph_tpu_torch tree.

The runtime half of these invariants already exists (``common/lockdep``
for lock-order cycles, ``wire_corpus --check`` for archived frames); this
package is the static half (reference: the tree the paper mirrors enforces
them with src/common/lockdep.cc, ceph-dencoder round-trips and
debug-build asserts).  Four checker families:

- ``wire-abi``    — wire ids + FIXED_FIELDS layouts vs the committed
                    lockfile ``ABI.lock`` (append-only tails,
                    no id reuse, corpus/dencoder/golden coverage)
- ``async-safety``— blocking calls in ``async def`` bodies, thread locks
                    held across ``await``, raw cross-loop calls that
                    bypass ``call_soon_threadsafe``
- ``registry``    — config keys vs the ``common/config.py`` schema (both
                    directions), perf-counter bumps vs declarations, asok
                    renderer/command coherence
- ``codec``       — struct format strings vs argument counts, FIXED
                    layout hygiene (declared fields, defaults for the
                    truncated-tail decode rule, known kind codes)

Entry point::

    python -m ceph_tpu_torch.tools.lint            # exit 0 = clean/baselined
    python -m ceph_tpu_torch.tools.lint --json     # machine-readable findings

Findings are suppressed per-finding via ``baseline.json`` next to this
file; every entry carries a one-line justification and a stale entry
(suppressing nothing) is itself a finding, so the baseline can only
shrink.  ``--update-wire-lock`` regenerates the ABI lockfile — the one
sanctioned way to land an (append-only) wire layout change.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.tools.lint.findings import Baseline, Finding

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")
WIRE_LOCK_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "ABI.lock")

CHECK_FAMILIES = ("wire-abi", "async-safety", "registry", "codec")


@dataclass
class LintReport:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    files_scanned: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> Dict:
        return {
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [f.to_json() for f in self.suppressed],
        }


def _py_files(root: str, paths: Optional[List[str]]) -> List[str]:
    out = []
    for base in (paths or [os.path.join(root, "ceph_tpu_torch")]):
        if os.path.isfile(base):
            out.append(base)
            continue
        for dirpath, dirnames, files in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            out.extend(os.path.join(dirpath, f)
                       for f in files if f.endswith(".py"))
    return sorted(out)


def run_lint(
    root: str = REPO_ROOT,
    paths: Optional[List[str]] = None,
    checks: Tuple[str, ...] = CHECK_FAMILIES,
    baseline_path: Optional[str] = BASELINE_PATH,
    wire_lock_path: str = WIRE_LOCK_PATH,
    wire_sources: Optional[List[Tuple[str, str]]] = None,
    corpus_dir: Optional[str] = None,
    coverage: bool = True,
) -> LintReport:
    """Run the checker families over the tree and fold the baseline in.

    ``wire_sources`` overrides the scanned (path, source-text) pairs for
    the wire-ABI family — tests feed doctored copies of ``types.py``
    through the real committed lockfile.  ``coverage=False`` skips the
    runtime corpus-coverage walk (pure-AST mode).
    """
    from ceph_tpu_torch.tools.lint import async_safety, codec, registry, wire_abi

    files = _py_files(root, paths)
    sources: List[Tuple[str, str]] = []
    for p in files:
        try:
            with open(p, encoding="utf-8") as f:
                sources.append((os.path.relpath(p, root), f.read()))
        except (OSError, UnicodeDecodeError):
            sources.append((os.path.relpath(p, root), ""))

    findings: List[Finding] = []
    if "wire-abi" in checks:
        findings += wire_abi.check(
            root, lock_path=wire_lock_path, sources=wire_sources,
            corpus_dir=corpus_dir, coverage=coverage)
    if "async-safety" in checks:
        findings += async_safety.check(sources)
    if "registry" in checks:
        findings += registry.check(root, sources)
    if "codec" in checks:
        findings += codec.check(sources, wire_sources=wire_sources)

    report = LintReport(files_scanned=len(files))
    baseline = Baseline.load(baseline_path) if baseline_path else Baseline()
    used = set()
    for f in findings:
        reason = baseline.match(f)
        if reason is not None:
            f.suppressed_reason = reason
            used.add(baseline.key_of(f))
            report.suppressed.append(f)
        else:
            report.findings.append(f)
    # a baseline entry that no longer suppresses anything is stale: the
    # defect was fixed (delete the entry) or the identity drifted (the
    # suppression silently stopped protecting) — either way, a finding.
    # Likewise an --update-baseline TODO reason left in place: the
    # suppression works, but an unjustified one must not pass CI.
    bl_rel = os.path.relpath(baseline_path or BASELINE_PATH, root)
    scanned_files = {rel for rel, _ in sources}
    full_scope = paths is None
    for entry in baseline.entries:
        # entries of families that did not run this invocation, or (on a
        # path-scoped run) whose file was not scanned, cannot be judged
        # stale — a --checks subset or one-file pre-commit run must not
        # demand removal of a suppression the full run still needs.  A
        # FULL run judges unscanned files too: there, an entry naming a
        # file that no longer exists IS the classic stale case.
        if entry.check.split("/", 1)[0] not in checks:
            continue
        if not full_scope and entry.file not in scanned_files:
            continue
        if entry.ident not in used:
            report.findings.append(Finding(
                check="baseline/stale", file=bl_rel, line=1,
                key=entry.key,
                message=f"baseline entry suppresses nothing: {entry.key!r} "
                        f"(reason: {entry.reason}) — remove it",
            ))
        elif entry.reason.lower().startswith("todo"):
            report.findings.append(Finding(
                check="baseline/unjustified", file=bl_rel, line=1,
                key=entry.key,
                message=f"baseline entry {entry.key!r} still carries the "
                        f"--update-baseline TODO reason — write the real "
                        f"one-line justification",
            ))
    report.findings.sort(key=lambda f: (f.check, f.file, f.line, f.key))
    return report
