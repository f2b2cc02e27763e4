# Copy of ceph_tpu/tools/lint/codec.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""codec hygiene checker family.

Binary codecs fail at the byte level, long after the typo: a struct
format string with one conversion too few packs garbage lengths; a
FIXED_FIELDS entry naming a field the dataclass doesn't declare (or one
without a default) breaks the truncated-tail decode rule the whole
golden-frame compatibility story rests on.  Statically checkable, so
check it statically:

- ``struct-arity``: ``struct.pack(fmt, ...)`` / ``pack_into`` with a
  constant format must receive exactly as many values as the format has
  conversions; module/class-level ``NAME = struct.Struct(fmt)``
  instances are tracked so ``NAME.pack(...)`` is checked too (starred
  args or dynamic formats are skipped, not guessed);
- ``fixed-field``: every FIXED_FIELDS entry must name a declared
  dataclass field, use a known kind code, and the field must carry a
  default — ``_unpack_fixed`` materializes truncated tails from the
  dataclass defaults, so a default-less field would make every old
  frame undecodable;
- ``fixed-tail-default``: post-v1 FIXED messages must keep ALL fields
  defaulted (the truncated-tail rule instantiates ``cls()``);
- ``slab-host-roundtrip``: a name bound from a slab gather
  (``*.gather_rows(...)`` / ``slab_gather(...)``) may be a DEVICE array
  on the pagestore's device arm; materializing it on the host
  (``np.asarray`` / ``np.frombuffer`` / ``.copy()``) outside the
  module's declared ``SLAB_IO_BOUNDARY`` helpers silently reintroduces
  the per-read d2h the device arm exists to delete — declare the exit
  or stay on device;
- unparsable files are reported here (one family owns the syntax check).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.tools.lint.findings import Finding
from ceph_tpu_torch.tools.lint.wire_abi import VALID_KINDS, extract

_FMT_TOKEN = re.compile(r"(\d*)([xcbB?hHiIlLqQnNefdspP])")


def _fmt_arity(fmt: str) -> Optional[int]:
    """Number of values a struct format consumes, or None if malformed."""
    body = fmt
    if body[:1] in "@=<>!":
        body = body[1:]
    pos, count = 0, 0
    for m in _FMT_TOKEN.finditer(body):
        if m.start() != pos:
            return None
        pos = m.end()
        rep = int(m.group(1)) if m.group(1) else 1
        conv = m.group(2)
        if conv == "x":
            continue  # pad byte: consumes no value
        if conv in "sp":
            count += 1  # N-byte string is ONE value
        else:
            count += rep
    if pos != len(body):
        return None
    return count


class _StructScanner(ast.NodeVisitor):
    def __init__(self, relpath: str, findings: List[Finding]):
        self.relpath = relpath
        self.findings = findings
        self.struct_vars: Dict[str, int] = {}  # NAME -> arity

    def visit_Assign(self, node):
        # NAME = struct.Struct("<fmt")  (module or class scope both walk
        # through here; instance attrs self.X are tracked by attr name)
        if len(node.targets) == 1 and isinstance(node.value, ast.Call):
            call = node.value
            if (isinstance(call.func, ast.Attribute)
                    and call.func.attr == "Struct" and call.args
                    and isinstance(call.args[0], ast.Constant)
                    and isinstance(call.args[0].value, str)):
                arity = _fmt_arity(call.args[0].value)
                tgt = node.targets[0]
                name = tgt.id if isinstance(tgt, ast.Name) else (
                    tgt.attr if isinstance(tgt, ast.Attribute) else None)
                if name is not None and arity is not None:
                    self.struct_vars[name] = arity
        self.generic_visit(node)

    def visit_Call(self, node):
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr == "pack":
                self._check_pack(node, func, skip=0)
            elif func.attr == "pack_into":
                self._check_pack(node, func, skip=2)
        self.generic_visit(node)

    def _check_pack(self, node, func: ast.Attribute, skip: int) -> None:
        if any(isinstance(a, ast.Starred) for a in node.args) \
                or node.keywords:
            return  # dynamic arity: not checkable
        recv = func.value
        arity: Optional[int] = None
        fmt_src = ""
        args = node.args
        if isinstance(recv, ast.Name) and recv.id == "struct" \
                or (isinstance(recv, ast.Attribute)
                    and recv.attr == "struct"):
            # struct.pack(fmt, *vals) / struct.pack_into(fmt, buf, off, *v)
            if not args or not isinstance(args[0], ast.Constant) \
                    or not isinstance(args[0].value, str):
                return
            fmt_src = args[0].value
            arity = _fmt_arity(fmt_src)
            args = args[1:]
        else:
            # STRUCT_VAR.pack(*vals) / X.pack_into(buf, off, *vals)
            name = recv.id if isinstance(recv, ast.Name) else (
                recv.attr if isinstance(recv, ast.Attribute) else None)
            if name is None or name not in self.struct_vars:
                return
            arity = self.struct_vars[name]
            fmt_src = name
        if arity is None:
            return
        nvals = len(args) - skip
        if nvals != arity:
            self.findings.append(Finding(
                check="codec/struct-arity", file=self.relpath,
                line=node.lineno, key=f"{fmt_src}@L{node.lineno}",
                message=f"struct pack of {fmt_src!r} consumes {arity} "
                        f"value(s) but {nvals} given — mispacked lengths "
                        f"corrupt every frame downstream"))


_SLAB_GATHER_ATTRS = {"gather_rows"}
_SLAB_GATHER_NAMES = {"slab_gather"}
_HOST_MATERIALIZERS = {"asarray", "frombuffer"}


def _slab_boundary(tree: ast.Module) -> set:
    """Module-level ``SLAB_IO_BOUNDARY = ("fn", ...)`` — the declared
    host-exit helpers this module is allowed to materialize slab-gather
    results in."""
    names: set = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "SLAB_IO_BOUNDARY" \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) \
                        and isinstance(elt.value, str):
                    names.add(elt.value)
    return names


def _is_gather_call(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _SLAB_GATHER_ATTRS:
        return True
    return isinstance(f, ast.Name) and f.id in _SLAB_GATHER_NAMES


class _SlabScanner(ast.NodeVisitor):
    """codec/slab-host-roundtrip (see module docstring).  Purely
    name-local: a gather result is tracked per enclosing function, and
    only the three materializer shapes the device arm actually pays for
    are flagged — no alias chasing, no cross-function flow."""

    def __init__(self, relpath: str, boundary: set,
                 findings: List[Finding]):
        self.relpath = relpath
        self.boundary = boundary
        self.findings = findings
        self._fn: List[str] = []
        self._tainted: List[set] = []

    def _visit_fn(self, node):
        self._fn.append(node.name)
        self._tainted.append(set())
        self.generic_visit(node)
        self._fn.pop()
        self._tainted.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _flag(self, node, what: str) -> None:
        if self._fn and self._fn[-1] in self.boundary:
            return
        self.findings.append(Finding(
            check="codec/slab-host-roundtrip", file=self.relpath,
            line=node.lineno,
            key=f"{self._fn[-1] if self._fn else '<module>'}"
                f"@L{node.lineno}",
            message=f"{what} on a slab-gather result outside the "
                    f"declared SLAB_IO_BOUNDARY helpers — on the "
                    f"device arm this is a hidden per-read d2h; keep "
                    f"the result on device or declare the exit"))

    def visit_Assign(self, node):
        if self._tainted and _is_gather_call(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self._tainted[-1].add(tgt.id)
        self.generic_visit(node)

    def _arg_tainted(self, arg) -> bool:
        if isinstance(arg, ast.Name) and self._tainted \
                and arg.id in self._tainted[-1]:
            return True
        return _is_gather_call(arg)

    def visit_Call(self, node):
        f = node.func
        if isinstance(f, ast.Attribute):
            recv = f.value
            if f.attr in _HOST_MATERIALIZERS \
                    and isinstance(recv, ast.Name) \
                    and recv.id in ("np", "numpy") and node.args \
                    and self._arg_tainted(node.args[0]):
                self._flag(node, f"np.{f.attr}")
            elif f.attr == "copy" and not node.args \
                    and self._arg_tainted(recv):
                self._flag(node, ".copy()")
        self.generic_visit(node)


def check(sources: List[Tuple[str, str]],
          wire_sources: Optional[List[Tuple[str, str]]] = None
          ) -> List[Finding]:
    findings: List[Finding] = []
    parsed: List[Tuple[str, str]] = []
    for relpath, text in sources:
        try:
            tree = ast.parse(text)
        except SyntaxError as e:
            findings.append(Finding(
                check="codec/syntax", file=relpath,
                line=e.lineno or 1, key="syntax",
                message=f"file does not parse: {e.msg}"))
            continue
        parsed.append((relpath, text))
        _StructScanner(relpath, findings).visit(tree)
        _SlabScanner(relpath, _slab_boundary(tree), findings).visit(tree)

    # FIXED layout hygiene over the wire-declaring modules (or the
    # doctored override a test feeds in)
    wire_srcs = wire_sources if wire_sources is not None else [
        (p, t) for p, t in parsed
        if p.endswith(("rados/types.py", "rados/messenger.py",
                       "mgr/daemon.py"))]
    for d in extract(wire_srcs):
        if d.fixed_fields is None:
            continue
        declared = {n for n, _ in d.fields}
        defaulted = {n for n, has in d.fields if has}
        for fname, kind in d.fixed_fields:
            if kind not in VALID_KINDS:
                findings.append(Finding(
                    check="codec/fixed-field", file=d.file,
                    line=d.fixed_line or d.line,
                    key=f"{d.name}.{fname}:kind",
                    message=f"{d.name}.FIXED_FIELDS: unknown kind "
                            f"{kind!r} for field {fname!r} (valid: "
                            f"{sorted(VALID_KINDS)})"))
            if fname not in declared:
                findings.append(Finding(
                    check="codec/fixed-field", file=d.file,
                    line=d.fixed_line or d.line,
                    key=f"{d.name}.{fname}:undeclared",
                    message=f"{d.name}.FIXED_FIELDS names {fname!r} "
                            f"but the dataclass declares no such field "
                            f"— decode would stamp a ghost attribute"))
            elif fname not in defaulted:
                findings.append(Finding(
                    check="codec/fixed-field", file=d.file,
                    line=d.fixed_line or d.line,
                    key=f"{d.name}.{fname}:no-default",
                    message=f"{d.name}.{fname} has no default: the "
                            f"truncated-tail decode rule materializes "
                            f"old frames from dataclass defaults, so "
                            f"every FIXED field needs one"))
        if d.version >= 2:
            for fname, has_default in d.fields:
                if not has_default:
                    findings.append(Finding(
                        check="codec/fixed-tail-default", file=d.file,
                        line=d.line, key=f"{d.name}.{fname}",
                        message=f"{d.name} is v{d.version} but field "
                                f"{fname!r} has no default — "
                                f"`_unpack_fixed` instantiates `cls()` "
                                f"to default unsent tails, which "
                                f"requires every field defaulted"))
    return findings
