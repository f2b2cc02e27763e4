# Copy of ceph_tpu/tools/lint/wire_abi.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""wire-abi checker family: the message registry vs the committed
lockfile ``ABI.lock`` beside it (the port's copy of
``corpus/wire/ABI.lock``).

The wire contract this tree lives by (types.py FIXED_FIELDS comments,
r11/r13/r15 golden frames) is append-only: a FIXED message may only GROW
at the tail, with a version bump, and old frames must keep decoding via
the truncated-tail rule.  Review discipline enforced that for fifteen
rounds; this checker enforces it mechanically:

- every ``@message(id[, version=v])`` class is extracted from source by
  AST (no imports — a doctored tree that would not even import still
  gets checked), along with its FIXED_FIELDS layout wherever declared
  (class body or module-level ``Cls.FIXED_FIELDS = [...]``);
- duplicate wire ids are an error even across files (the runtime
  registry only catches collisions that actually import together);
- against the lockfile: removed messages, reused/changed ids, version
  regressions, any non-append layout change (insert, reorder, rename,
  kind change, removal), and a grown tail without a version bump all
  fail;
- messages absent from the lockfile fail with ``wire-abi/unlocked`` —
  ``python -m ceph_tpu_torch.tools.lint --update-wire-lock`` is the one
  sanctioned way to commit a layout change, which makes every wire
  evolution an explicit, reviewable diff of ABI.lock;
- coverage: every FIXED message must be archived in corpus/wire, must
  round-trip through the dencoder, and (when version >= 2) must have a
  golden old-build frame — delegated to
  ``wire_corpus.coverage_gaps()`` so ``wire_corpus --check --strict``
  and the lint share one implementation of the walk.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.tools.lint.findings import Finding

# the modules that declare wire messages (repo-relative); FIXED_FIELDS
# assigned outside these files would be invisible, so codec hygiene also
# checks no other file assigns one
WIRE_SOURCES = (
    os.path.join("ceph_tpu_torch", "rados", "types.py"),
    os.path.join("ceph_tpu_torch", "rados", "messenger.py"),
    os.path.join("ceph_tpu_torch", "mgr", "daemon.py"),
)

VALID_KINDS = {"q", "Q", "d", "?", "s", "y", "Q*", "s*", "qq*", "addr"}


@dataclass
class MsgDecl:
    name: str
    file: str
    line: int
    type_id: int
    version: int
    fixed_fields: Optional[List[Tuple[str, str]]] = None
    fixed_line: int = 0
    # dataclass field names declared in the class body, in order, with
    # whether each carries a default (the truncated-tail rule needs one)
    fields: List[Tuple[str, bool]] = field(default_factory=list)


def _literal_fields(node: ast.AST) -> Optional[List[Tuple[str, str]]]:
    """Evaluate a FIXED_FIELDS literal: a list of (name, kind) tuples."""
    try:
        val = ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None
    if not isinstance(val, list):
        return None
    out = []
    for item in val:
        if (not isinstance(item, tuple) or len(item) != 2
                or not all(isinstance(x, str) for x in item)):
            return None
        out.append((item[0], item[1]))
    return out


def extract(sources: List[Tuple[str, str]]) -> List[MsgDecl]:
    """(relpath, source) pairs -> message declarations, in file order."""
    decls: List[MsgDecl] = []
    for relpath, text in sources:
        try:
            tree = ast.parse(text)
        except SyntaxError:
            continue  # codec family reports unparsable files
        by_name: Dict[str, MsgDecl] = {}
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                decl = _class_decl(node, relpath)
                if decl is not None:
                    by_name[decl.name] = decl
                    decls.append(decl)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                # module-level Cls.FIXED_FIELDS = [...]
                tgt = node.targets[0]
                if (isinstance(tgt, ast.Attribute)
                        and tgt.attr == "FIXED_FIELDS"
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id in by_name):
                    fields = _literal_fields(node.value)
                    if fields is not None:
                        by_name[tgt.value.id].fixed_fields = fields
                        by_name[tgt.value.id].fixed_line = node.lineno
    return decls


def _class_decl(node: ast.ClassDef, relpath: str) -> Optional[MsgDecl]:
    type_id = version = None
    for deco in node.decorator_list:
        if (isinstance(deco, ast.Call)
                and ((isinstance(deco.func, ast.Name)
                      and deco.func.id == "message")
                     or (isinstance(deco.func, ast.Attribute)
                         and deco.func.attr == "message"))):
            if deco.args and isinstance(deco.args[0], ast.Constant):
                type_id = deco.args[0].value
            version = 1
            for kw in deco.keywords:
                if kw.arg == "version" and isinstance(kw.value, ast.Constant):
                    version = kw.value.value
    if type_id is None:
        return None
    decl = MsgDecl(name=node.name, file=relpath, line=node.lineno,
                   type_id=int(type_id), version=int(version or 1))
    for stmt in node.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                          ast.Name):
            decl.fields.append((stmt.target.id, stmt.value is not None))
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            if stmt.targets[0].id == "FIXED_FIELDS":
                fields = _literal_fields(stmt.value)
                if fields is not None:
                    decl.fixed_fields = fields
                    decl.fixed_line = stmt.lineno
    return decl


def make_lock(decls: List[MsgDecl]) -> Dict:
    """The lockfile document for the current declarations."""
    return {
        "comment": "wire-ABI lockfile: update ONLY via "
                   "`python -m ceph_tpu_torch.tools.lint --update-wire-lock` "
                   "after an append-only layout change + version bump",
        "messages": {
            d.name: {
                "id": d.type_id,
                "version": d.version,
                "fixed": ([list(f) for f in d.fixed_fields]
                          if d.fixed_fields is not None else None),
            }
            for d in sorted(decls, key=lambda d: d.type_id)
        },
    }


def load_lock(path: str) -> Optional[Dict]:
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def write_lock(path: str, decls: List[MsgDecl]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(make_lock(decls), fh, indent=1, sort_keys=True)
        fh.write("\n")


def check(root: str, lock_path: str,
          sources: Optional[List[Tuple[str, str]]] = None,
          corpus_dir: Optional[str] = None,
          coverage: bool = True) -> List[Finding]:
    if sources is None:
        sources = []
        for rel in WIRE_SOURCES:
            p = os.path.join(root, rel)
            if os.path.exists(p):
                with open(p, encoding="utf-8") as fh:
                    sources.append((rel, fh.read()))
    decls = extract(sources)
    findings = _check_decls(decls, load_lock(lock_path), lock_path, root)
    if coverage:
        findings += _check_coverage(corpus_dir)
    return findings


def _check_decls(decls: List[MsgDecl], lock: Optional[Dict],
                 lock_path: str, root: str) -> List[Finding]:
    findings: List[Finding] = []
    lock_rel = os.path.relpath(lock_path, root)

    by_id: Dict[int, MsgDecl] = {}
    by_name: Dict[str, MsgDecl] = {}
    for d in decls:
        if d.type_id in by_id:
            findings.append(Finding(
                check="wire-abi/duplicate-id", file=d.file, line=d.line,
                key=d.name,
                message=f"wire type id {d.type_id} of {d.name} already "
                        f"taken by {by_id[d.type_id].name} "
                        f"({by_id[d.type_id].file}:{by_id[d.type_id].line})"))
        else:
            by_id[d.type_id] = d
        by_name[d.name] = d

    if lock is None:
        findings.append(Finding(
            check="wire-abi/no-lockfile", file=lock_rel, line=1,
            key="ABI.lock",
            message=f"wire-ABI lockfile missing at {lock_rel}; run "
                    f"`python -m ceph_tpu_torch.tools.lint --update-wire-lock` "
                    f"and commit it"))
        return findings

    locked = lock.get("messages", {})
    for name, rec in locked.items():
        d = by_name.get(name)
        if d is None:
            findings.append(Finding(
                check="wire-abi/removed", file=lock_rel, line=1, key=name,
                message=f"message {name} (wire id {rec['id']}) is in the "
                        f"lockfile but no longer declared — wire messages "
                        f"cannot be removed while peers may still send "
                        f"them (deprecate in place)"))
            continue
        if d.type_id != rec["id"]:
            findings.append(Finding(
                check="wire-abi/id-changed", file=d.file, line=d.line,
                key=name,
                message=f"{name} wire id changed {rec['id']} -> "
                        f"{d.type_id}; ids are forever (an old peer "
                        f"would decode the frame as the other type)"))
        if d.version < rec["version"]:
            findings.append(Finding(
                check="wire-abi/version-regressed", file=d.file,
                line=d.line, key=name,
                message=f"{name} version regressed v{rec['version']} -> "
                        f"v{d.version}"))
        findings += _check_layout(d, rec, name)

    for name, d in by_name.items():
        if name not in locked:
            findings.append(Finding(
                check="wire-abi/unlocked", file=d.file, line=d.line,
                key=name,
                message=f"message {name} (wire id {d.type_id}) is not in "
                        f"{lock_rel}; run --update-wire-lock and commit "
                        f"the lockfile diff alongside the new message"))
    return findings


def _check_layout(d: MsgDecl, rec: Dict, name: str) -> List[Finding]:
    findings: List[Finding] = []
    locked_fixed = rec.get("fixed")
    if locked_fixed is None and d.fixed_fields is None:
        return findings
    if locked_fixed is None:
        # pickled -> FIXED is a wire format change: old peers send pickle
        # frames the new FIXED decoder would misparse unless versioned
        if d.version <= rec["version"]:
            findings.append(Finding(
                check="wire-abi/tail-without-version-bump", file=d.file,
                line=d.fixed_line or d.line, key=name,
                message=f"{name} gained a FIXED layout without a version "
                        f"bump (locked v{rec['version']}, still "
                        f"v{d.version})"))
        return findings
    if d.fixed_fields is None:
        findings.append(Finding(
            check="wire-abi/layout-break", file=d.file, line=d.line,
            key=name,
            message=f"{name} lost its FIXED_FIELDS layout; the locked "
                    f"binary layout ({len(locked_fixed)} fields) is the "
                    f"wire contract"))
        return findings
    cur = [tuple(f) for f in d.fixed_fields]
    want = [tuple(f) for f in locked_fixed]
    for i, w in enumerate(want):
        if i >= len(cur):
            findings.append(Finding(
                check="wire-abi/layout-break", file=d.file,
                line=d.fixed_line or d.line, key=name,
                message=f"{name} FIXED_FIELDS truncated: locked field "
                        f"{i} {w} removed (layouts are append-only)"))
            return findings
        if cur[i] != w:
            findings.append(Finding(
                check="wire-abi/layout-break", file=d.file,
                line=d.fixed_line or d.line, key=name,
                message=f"{name} FIXED_FIELDS slot {i} changed "
                        f"{w} -> {cur[i]}: layouts are append-only "
                        f"(no insert/reorder/rename/retype; new fields "
                        f"go at the tail with a version bump)"))
            return findings
    if len(cur) > len(want) and d.version <= rec["version"]:
        findings.append(Finding(
            check="wire-abi/tail-without-version-bump", file=d.file,
            line=d.fixed_line or d.line, key=name,
            message=f"{name} FIXED_FIELDS grew "
                    f"{len(want)} -> {len(cur)} fields but the wire "
                    f"version did not bump (locked v{rec['version']}, "
                    f"still v{d.version}); old decoders need the "
                    f"version to know the tail may be truncated"))
    return findings


def _check_coverage(corpus_dir: Optional[str]) -> List[Finding]:
    """FIXED-type corpus/dencoder/golden coverage, via wire_corpus (one
    implementation of the walk, shared with ``wire_corpus --strict``)."""
    from ceph_tpu_torch.tools import wire_corpus

    findings = []
    for gap in wire_corpus.coverage_gaps(corpus_dir or
                                         wire_corpus.CORPUS_DIR):
        findings.append(Finding(
            check="wire-abi/coverage", file=gap.file, line=gap.line,
            key=f"{gap.type_name}:{gap.kind}", message=gap.message))
    return findings
