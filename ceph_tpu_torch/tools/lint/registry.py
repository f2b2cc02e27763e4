# Copy of ceph_tpu/tools/lint/registry.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""registry checker family: name registries that only fail at runtime.

Three registries where a typo'd string ships silently and explodes (or
worse, silently defaults) in production:

- config keys: every constant key passed to ``conf.get``/``conf.set``
  must be declared in ``common/config.py``'s ``DEFAULT_SCHEMA`` (the
  Config class accepts unknown keys as passthrough, so a misspelled
  option reads its fallback default forever); and the reverse — a
  schema option no code ever reads is dead weight that operators will
  set to no effect.  Dynamic ``conf.get(f"prefix_{x}")`` families are
  honored by composition: an option counts as referenced when a dynamic
  prefix matches AND the remaining suffix appears as a string constant
  somewhere in the tree (so ``osd_{key}`` + ``"hit_set_period"`` covers
  ``osd_hit_set_period`` without whitelisting every osd_* option).
- perf counters: every counter name bumped via
  ``inc/dec/tinc/hinc/time_avg`` must be declared by some
  ``PerfCountersBuilder.add_*`` or ``PerfCounters.ensure`` call —
  bumping an undeclared counter raises ``KeyError`` on the hot path,
  but only on the first traversal of that path.
- asok commands: every key in ``tools/ceph.py``'s ``ASOK_RENDERERS``
  must match a command some daemon actually registers (a renamed
  command silently orphans its renderer — the ``ceph daemon``/``ceph
  tell`` output degrades to raw JSON with no test failing).  Commands
  WITHOUT a custom renderer are fine: ``print_asok_result``'s JSON
  fallback is the default renderer for every registered command.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.tools.lint.findings import Finding

CONFIG_REL = os.path.join("ceph_tpu_torch", "common", "config.py")
CEPH_TOOL_REL = os.path.join("ceph_tpu_torch", "tools", "ceph.py")

_PERF_DECL = {"add_u64", "add_u64_counter", "add_time_avg",
              "add_histogram", "ensure"}
_PERF_USE = {"inc", "dec", "tinc", "hinc", "time_avg"}
# receivers that denote THE config object (rgw's plain `cfg` dicts and
# arbitrary dict.get sites must not match)
_CONF_RECV = re.compile(r"(^|\.)conf(ig)?$")


def check(root: str, sources: List[Tuple[str, str]]) -> List[Finding]:
    findings: List[Finding] = []
    schema, schema_lines = _parse_schema(root)
    if schema is None:
        return findings  # no config module in scanned tree (test trees)

    # Registry coherence is a WHOLE-TREE property: a counter declared in
    # osd.py legitimizes a bump in scheduler.py.  A path-scoped run
    # (pre-commit on one file) must therefore build the reference pools
    # from the full tree — scanned sources win (tests feed doctored
    # copies), everything else loads from disk — while per-site findings
    # are still emitted only for the files actually scanned.
    scanned = {relpath for relpath, _ in sources}
    global_sources = list(sources)
    tree_dir = os.path.join(root, "ceph_tpu_torch")
    if os.path.isdir(tree_dir):
        for dirpath, dirnames, files in os.walk(tree_dir):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in files:
                if not fn.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), root)
                if rel not in scanned:
                    try:
                        with open(os.path.join(dirpath, fn),
                                  encoding="utf-8") as fh:
                            global_sources.append((rel, fh.read()))
                    except (OSError, UnicodeDecodeError):
                        pass

    conf_refs: List[Tuple[str, int, str]] = []   # (file, line, key)
    dyn_prefixes: Set[str] = set()
    perf_decl: Set[str] = set()
    perf_use: List[Tuple[str, int, str]] = []
    asok_cmds: Set[str] = set()
    renderers: List[Tuple[str, int, str]] = []
    all_constants: Set[str] = set()

    for relpath, text in global_sources:
        try:
            tree = ast.parse(text)
        except SyntaxError:
            continue
        is_config = relpath.replace("/", os.sep) == CONFIG_REL
        for node in ast.walk(tree):
            # config.py's own Option("name") literals must not count as
            # references, or no option could ever be dead
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str) \
                    and not is_config:
                all_constants.add(node.value)
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            recv = ast.unparse(func.value)
            if func.attr in ("get", "set") and not is_config \
                    and _CONF_RECV.search(recv) and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    conf_refs.append((relpath, node.lineno, arg.value))
                elif isinstance(arg, ast.JoinedStr) and arg.values \
                        and isinstance(arg.values[0], ast.Constant):
                    dyn_prefixes.add(str(arg.values[0].value))
            if func.attr in _PERF_DECL and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    perf_decl.add(arg.value)
            if func.attr in _PERF_USE and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    perf_use.append((relpath, node.lineno, arg.value))
            if func.attr == "register" and node.args and "asok" in recv:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    asok_cmds.add(arg.value)
        if relpath.replace("/", os.sep) == CEPH_TOOL_REL:
            renderers = _renderer_keys(tree, relpath)
        if relpath.replace("/", os.sep) == os.path.join(
                "ceph_tpu_torch", "common", "admin_socket.py"):
            # AdminSocket's built-in self.register(...) commands
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "register" and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    asok_cmds.add(node.args[0].value)

    # -- config: referenced key must exist in the schema ---------------------
    for relpath, line, key in conf_refs:
        if relpath not in scanned:
            continue
        if key not in schema:
            findings.append(Finding(
                check="registry/unknown-config-key", file=relpath,
                line=line, key=key,
                message=f"config key {key!r} is not declared in "
                        f"common/config.py DEFAULT_SCHEMA — unknown keys "
                        f"read as untyped passthrough, so a typo silently "
                        f"returns the call-site fallback forever"))

    # -- config: schema option must be referenced somewhere ------------------
    # tests count as references for the dead-option direction (injection
    # and CI-gate options are legitimately exercised only from tests)
    tests_dir = os.path.join(root, "tests")
    if os.path.isdir(tests_dir):
        lit = re.compile(r"""["']([A-Za-z0-9_.:-]+)["']""")
        for fn in os.listdir(tests_dir):
            if fn.endswith(".py"):
                with open(os.path.join(tests_dir, fn),
                          encoding="utf-8") as fh:
                    all_constants.update(lit.findall(fh.read()))
    referenced = {k for _, _, k in conf_refs}
    # dead-option findings belong to config.py: only a run that scans it
    # may emit them (a one-file pre-commit run must stay quiet)
    config_scanned = CONFIG_REL in {r.replace("/", os.sep)
                                    for r in scanned}
    for opt in (sorted(schema) if config_scanned else ()):
        if opt in referenced or opt in all_constants:
            continue
        if any(opt.startswith(p) and opt[len(p):] in all_constants
               for p in dyn_prefixes):
            continue  # dynamic prefix + constant suffix composition
        findings.append(Finding(
            check="registry/dead-config-option", file=CONFIG_REL,
            line=schema_lines.get(opt, 1), key=opt,
            message=f"schema option {opt!r} is never read by any code "
                    f"path — operators setting it get silent no-ops; "
                    f"wire it up or remove the declaration"))

    # -- perf counters -------------------------------------------------------
    for relpath, line, name in perf_use:
        if relpath not in scanned:
            continue
        if name not in perf_decl:
            findings.append(Finding(
                check="registry/undeclared-perf-counter", file=relpath,
                line=line, key=name,
                message=f"perf counter {name!r} is bumped but never "
                        f"declared by any PerfCountersBuilder.add_* / "
                        f"ensure() — first traversal of this path raises "
                        f"KeyError"))

    # -- asok renderers ------------------------------------------------------
    for relpath, line, key in renderers:
        if relpath not in scanned:
            continue
        if key not in asok_cmds:
            findings.append(Finding(
                check="registry/orphan-asok-renderer", file=relpath,
                line=line, key=key,
                message=f"ASOK_RENDERERS[{key!r}] matches no registered "
                        f"admin-socket command — a renamed command "
                        f"silently degrades `ceph daemon/tell` output to "
                        f"the raw-JSON fallback"))
    return findings


def _parse_schema(root: str
                  ) -> Tuple[Optional[Set[str]], Dict[str, int]]:
    path = os.path.join(root, CONFIG_REL)
    if not os.path.exists(path):
        return None, {}
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    names: Set[str] = set()
    lines: Dict[str, int] = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "Option" and node.args
                and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
            lines[node.args[0].value] = node.lineno
    return names, lines


def _renderer_keys(tree: ast.AST, relpath: str
                   ) -> List[Tuple[str, int, str]]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "ASOK_RENDERERS" \
                and isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out.append((relpath, k.lineno, k.value))
    return out
