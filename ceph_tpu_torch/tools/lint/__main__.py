# Copy of ceph_tpu/tools/lint/__main__.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""CLI driver: ``python -m ceph_tpu_torch.tools.lint``.

Exit status is the contract (CI gates on it): 0 when every finding is
fixed or baselined, 1 otherwise.  ``--json`` emits the machine-readable
findings document; ``--update-wire-lock`` regenerates
the lint's ``ABI.lock`` from the current declarations (the sanctioned
wire-change workflow, see README "Static analysis & sanitizers");
``--update-baseline`` rewrites the suppression baseline from the current
findings with TODO reasons that a human must replace before commit (the
baseline loader rejects empty reasons).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ceph_tpu_torch.tools.lint import (BASELINE_PATH, CHECK_FAMILIES, REPO_ROOT,
                                 WIRE_LOCK_PATH, run_lint)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.tools.lint",
        description="project-invariant static analysis for ceph_tpu_torch")
    p.add_argument("paths", nargs="*",
                   help="files/dirs to scan (default: ceph_tpu_torch/)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable findings on stdout")
    p.add_argument("--checks", default=",".join(CHECK_FAMILIES),
                   help=f"comma-separated families "
                        f"(default: {','.join(CHECK_FAMILIES)})")
    p.add_argument("--no-baseline", action="store_true",
                   help="report baselined findings too")
    p.add_argument("--update-wire-lock", action="store_true",
                   help="regenerate the lint's ABI.lock from the "
                        "current message declarations and exit")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite baseline.json from current findings "
                        "(reasons left as TODO for a human)")
    p.add_argument("--root", default=REPO_ROOT, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.update_wire_lock:
        from ceph_tpu_torch.tools.lint import wire_abi

        sources = []
        for rel in wire_abi.WIRE_SOURCES:
            path = os.path.join(args.root, rel)
            if os.path.exists(path):
                with open(path, encoding="utf-8") as fh:
                    sources.append((rel, fh.read()))
        decls = wire_abi.extract(sources)
        lock_path = os.path.join(
            args.root, os.path.relpath(WIRE_LOCK_PATH, REPO_ROOT))
        wire_abi.write_lock(lock_path, decls)
        print(f"wire-ABI lockfile written: {len(decls)} messages -> "
              f"{lock_path}")
        return 0

    checks = tuple(c.strip() for c in args.checks.split(",") if c.strip())
    unknown = [c for c in checks if c not in CHECK_FAMILIES]
    if unknown:
        print(f"unknown check families: {unknown} "
              f"(have: {list(CHECK_FAMILIES)})", file=sys.stderr)
        return 2

    report = run_lint(
        root=args.root,
        paths=[os.path.abspath(p) for p in args.paths] or None,
        checks=checks,
        baseline_path=None if args.no_baseline else BASELINE_PATH,
    )

    if args.update_baseline:
        from ceph_tpu_torch.tools.lint.findings import Baseline, BaselineEntry

        # only a FULL run may rewrite the baseline: a --checks subset or
        # path-scoped run cannot judge entries outside its scope, and
        # dropping them would destroy hand-written justifications
        if args.paths or set(checks) != set(CHECK_FAMILIES) \
                or args.no_baseline:
            print("--update-baseline requires a full run (no paths, all "
                  "check families, baseline enabled)", file=sys.stderr)
            return 2
        # MERGE, never rewrite-from-scratch: existing entries that still
        # suppress something keep their hand-written reasons; only NEW
        # findings gain TODO entries.  (Stale entries — suppressing
        # nothing — are dropped, which is what their finding demands.)
        old = Baseline.load(BASELINE_PATH)
        kept_idents = {f.ident for f in report.suppressed}
        entries = [e for e in old.entries if e.ident in kept_idents]
        entries += [BaselineEntry(
            check=f.check, file=f.file, key=f.key,
            reason="TODO: justify this suppression in one line")
            for f in report.findings
            if not f.check.startswith("baseline/")]
        Baseline(entries).save(BASELINE_PATH)
        n_new = len(entries) - len([e for e in entries
                                    if e.ident in kept_idents])
        print(f"baseline now has {len(entries)} entries "
              f"({n_new} new with TODO reasons — replace them before "
              f"committing)")
        return 0

    if args.json:
        print(json.dumps(report.to_json(), indent=1))
    else:
        for f in report.findings:
            print(f"FAIL {f.render()}", file=sys.stderr)
        n_sup = len(report.suppressed)
        print(f"tpu-lint: {report.files_scanned} files, "
              f"{len(report.findings)} finding(s)"
              + (f", {n_sup} baselined" if n_sup else ""))
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
