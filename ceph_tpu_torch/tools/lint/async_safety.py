# Copy of ceph_tpu/tools/lint/async_safety.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""async-safety checker family.

The reactor/messenger plane mixes asyncio event loops with real threads
(reactor workers, the BatchingQueue dispatcher, native calls), which is
exactly where review keeps catching the same three defects:

- ``blocking-call``: a synchronous blocker (``time.sleep``, subprocess,
  a blocking ``threading.Lock.acquire``) inside an ``async def`` stalls
  the WHOLE event loop — every connection, heartbeat and timer on it;
- ``lock-across-await``: a ``with <thread-lock>:`` block containing an
  ``await`` parks the lock across a suspension point, so any OTHER task
  or thread contending for it deadlocks the loop (asyncio locks use
  ``async with``; thread locks must be released before awaiting);
- ``cross-loop-call``: calling ``loop.call_soon``/``create_task`` on a
  STORED loop from sync code may run on a foreign thread — the home-loop
  idiom is ``call_soon_threadsafe`` (messenger.py/reactor.py hop this
  way everywhere; this checker keeps it that way);
- ``shm-ring-payload`` (cross-process seam): objects queued onto a
  shared-memory ring (ShmRingPipe ``put_record``/``send_bytes``/
  ``send_gather``) must be WIRE BYTES or fixed-layout packs — a live
  message/connection/loop/lock object cannot cross a fork, and a
  reference pushed into shm is silently a different object on the far
  side.  Flagged: a bare object-ish name (``msg``, ``conn``, ``loop``,
  ``lock``, ``task``, ``sock`` ...) or ``self`` passed as a ring
  payload element;
- ``shm-lifecycle`` (cross-process seam): a module that opens
  ``multiprocessing.shared_memory.SharedMemory`` must pair it with both
  ``.close()`` and ``.unlink()`` on some teardown path — a missing
  close leaks the mapping, a missing unlink leaks /dev/shm segments
  past every process's death.

Heuristic exemptions (calibrated on the shipped tree):

- ``asyncio.get_running_loop().create_task(...)`` and locals assigned
  from an expression containing ``get_running_loop`` are loop-correct by
  construction (``get_running_loop`` raises off-loop, it cannot cross);
- calls wrapped in an argument to ``call_soon_threadsafe`` /
  ``run_coroutine_threadsafe`` ARE the idiom, not a violation;
- ``await x.acquire()`` is an asyncio acquire; only the non-awaited,
  argument-less form is flagged.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Tuple

from ceph_tpu_torch.tools.lint.findings import Finding

# sync calls that block the calling thread (and with it, the loop)
_BLOCKING = {
    "time.sleep": "blocks the event loop; use `await asyncio.sleep`",
    "os.system": "blocks the event loop; use an executor",
    "subprocess.run": "blocks the event loop; use "
                      "`asyncio.create_subprocess_exec` or an executor",
    "subprocess.call": "blocks the event loop",
    "subprocess.check_call": "blocks the event loop",
    "subprocess.check_output": "blocks the event loop",
    "socket.create_connection": "blocks the event loop; use "
                                "`asyncio.open_connection`",
}

_LOOP_METHODS = {"call_soon", "call_later", "call_at", "create_task"}
_THREADSAFE = {"call_soon_threadsafe", "run_coroutine_threadsafe"}

# shm ring producer surface (shm_ring.ShmRingPipe / ShmConnEndpoint):
# payload elements must be byte-plane values, never live objects
_SHM_PUT = {"put_record", "send_bytes", "send_gather"}
# bare names that denote live runtime objects on the wrong side of a
# fork (heuristic, like _LOCKISH: calibrated on the shipped tree)
_OBJECTISH = re.compile(
    r"^(msg|message|conn|connection|loop|lock|mutex|task|future|sock"
    r"|socket|worker|group|self)$")


_LOCKISH = re.compile(r"(^|[^a-z])(lock|mutex)")


def _lockish(src: str) -> bool:
    # word-start match: `self._lock`, `lock`, `shard_lock` hit;
    # `block`, `self.blocked`, `unlock` (the 'l' follows a letter) miss
    return _LOCKISH.search(src.lower()) is not None


class _Scanner(ast.NodeVisitor):
    def __init__(self, relpath: str, findings: List[Finding]):
        self.relpath = relpath
        self.findings = findings
        # stack of (is_async, get_running_loop_locals, node)
        self.funcs: List[Tuple[bool, set, ast.AST]] = []
        self.threadsafe_depth = 0
        self.await_depth = 0

    # -- function scopes -----------------------------------------------------

    def _visit_func(self, node, is_async: bool) -> None:
        loop_locals = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name) \
                    and "get_running_loop" in ast.unparse(sub.value):
                loop_locals.add(sub.targets[0].id)
        self.funcs.append((is_async, loop_locals, node))
        self.generic_visit(node)
        self.funcs.pop()

    def visit_FunctionDef(self, node):
        self._visit_func(node, False)

    def visit_AsyncFunctionDef(self, node):
        self._visit_func(node, True)

    def visit_Lambda(self, node):
        # a lambda inherits its enclosing context (it runs wherever it is
        # called; for the threadsafe-wrap exemption the wrap matters)
        self.generic_visit(node)

    @property
    def in_async(self) -> bool:
        return bool(self.funcs) and self.funcs[-1][0]

    # -- await tracking (awaited calls are not blocking) ---------------------

    def visit_Await(self, node):
        self.await_depth += 1
        self.generic_visit(node)
        self.await_depth -= 1

    # -- calls ---------------------------------------------------------------

    def visit_Call(self, node):
        func = node.func
        dotted = ""
        if isinstance(func, (ast.Attribute, ast.Name)):
            try:
                dotted = ast.unparse(func)
            except Exception:  # pragma: no cover - unparse is total here
                dotted = ""

        if self.in_async:
            self._check_blocking(node, func, dotted)

        if isinstance(func, ast.Attribute) and func.attr in _THREADSAFE:
            self.threadsafe_depth += 1
            self.generic_visit(node)
            self.threadsafe_depth -= 1
            return

        if isinstance(func, ast.Attribute) and func.attr in _LOOP_METHODS:
            self._check_cross_loop(node, func)

        if isinstance(func, ast.Attribute) and func.attr in _SHM_PUT:
            self._check_shm_payload(node, func)

        self.generic_visit(node)

    def _check_shm_payload(self, node, func: ast.Attribute) -> None:
        """Cross-process seam: ring payload elements must be byte-plane
        values.  put_record(kind, parts) / send_gather(wp, parts) carry
        the payload LAST; send_bytes(parts) carries it first."""
        if not node.args:
            return
        payload = node.args[-1]
        elements = []
        if isinstance(payload, (ast.List, ast.Tuple)):
            for e in payload.elts:
                elements.append(e.value if isinstance(e, ast.Starred)
                                else e)
        else:
            elements.append(payload)
        for e in elements:
            name = e.id if isinstance(e, ast.Name) else None
            if name is not None and _OBJECTISH.match(name):
                self.findings.append(Finding(
                    check="async-safety/shm-ring-payload",
                    file=self.relpath, line=node.lineno,
                    key=f"{func.attr}:{name}@L{node.lineno}",
                    message=f"`{name}` queued onto a shared-memory ring "
                            f"via `{func.attr}` in {self._func_name()}: "
                            f"only wire-frame bytes / fixed-layout packs "
                            f"may cross the process seam — a live "
                            f"object reference is a DIFFERENT object on "
                            f"the far side of the fork (serialize to "
                            f"bytes first)"))

    def _check_blocking(self, node, func, dotted: str) -> None:
        for pat, why in _BLOCKING.items():
            if dotted == pat or dotted.endswith("." + pat):
                self.findings.append(Finding(
                    check="async-safety/blocking-call", file=self.relpath,
                    line=node.lineno, key=f"{pat}@L{node.lineno}",
                    message=f"`{pat}` inside `async def` "
                            f"{self._func_name()}: {why}"))
                return
        # blocking .acquire() on a lock-looking receiver, not awaited:
        # a threading lock acquire would park the whole loop
        if (isinstance(func, ast.Attribute) and func.attr == "acquire"
                and not node.args and not node.keywords
                and self.await_depth == 0
                and _lockish(ast.unparse(func.value))):
            self.findings.append(Finding(
                check="async-safety/blocking-call", file=self.relpath,
                line=node.lineno,
                key=f"acquire:{ast.unparse(func.value)}@L{node.lineno}",
                message=f"non-awaited blocking "
                        f"`{ast.unparse(func.value)}.acquire()` inside "
                        f"`async def` {self._func_name()}: a thread-lock "
                        f"acquire stalls the event loop (await an asyncio "
                        f"lock, or release before suspension)"))

    def _check_cross_loop(self, node, func: ast.Attribute) -> None:
        if self.threadsafe_depth:
            return  # wrapped in call_soon_threadsafe(...): the idiom
        if self.in_async:
            return  # on-loop by definition (async bodies run in the loop)
        recv = ast.unparse(func.value)
        if recv.startswith("asyncio"):
            return  # asyncio.get_running_loop()/asyncio.ensure_future
        if self.funcs and isinstance(func.value, ast.Name) \
                and func.value.id in self.funcs[-1][1]:
            return  # local assigned from get_running_loop: on-loop
        self.findings.append(Finding(
            check="async-safety/cross-loop-call", file=self.relpath,
            line=node.lineno, key=f"{recv}.{func.attr}@L{node.lineno}",
            message=f"`{recv}.{func.attr}(...)` from sync code in "
                    f"{self._func_name()}: a stored loop may be homed on "
                    f"another thread — use "
                    f"`{recv}.call_soon_threadsafe(...)` (the "
                    f"messenger/reactor home-loop idiom) or prove the "
                    f"caller is on that loop via "
                    f"`asyncio.get_running_loop()`"))

    # -- with blocks ---------------------------------------------------------

    def visit_With(self, node):
        has_await = any(isinstance(x, (ast.Await, ast.AsyncFor,
                                       ast.AsyncWith))
                        for x in ast.walk(node))
        if has_await:
            for item in node.items:
                src = ast.unparse(item.context_expr)
                if _lockish(src):
                    self.findings.append(Finding(
                        check="async-safety/lock-across-await",
                        file=self.relpath, line=node.lineno,
                        key=f"{src}@L{node.lineno}",
                        message=f"thread lock `{src}` held across an "
                                f"`await` in {self._func_name()}: any "
                                f"other thread or task contending for it "
                                f"deadlocks against the suspended task "
                                f"(narrow the critical section, or use "
                                f"`async with` on an asyncio lock)"))
        self.generic_visit(node)

    def _func_name(self) -> str:
        for is_async, _, node in reversed(self.funcs):
            if hasattr(node, "name"):
                return f"`{node.name}`"
        return "<module>"


_SHM_OPEN = re.compile(r"\bSharedMemory\s*\(")


def _check_shm_lifecycle(relpath: str, text: str,
                         findings: List[Finding]) -> None:
    """A module opening SharedMemory must pair it with close AND unlink
    somewhere on its teardown paths (the /dev/shm segment outlives
    every process until SOMEONE unlinks; the mapping leaks until
    someone closes)."""
    m = _SHM_OPEN.search(text)
    if m is None:
        return
    missing = [what for what, pat in (("close", ".close("),
                                      ("unlink", ".unlink("))
               if pat not in text]
    if missing:
        line = text[:m.start()].count("\n") + 1
        findings.append(Finding(
            check="async-safety/shm-lifecycle", file=relpath, line=line,
            key=f"shm-lifecycle:{'+'.join(missing)}",
            message=f"`SharedMemory(` opened with no paired "
                    f"{' / '.join('.' + w + '()' for w in missing)} in "
                    f"this module: shared-memory segments outlive every "
                    f"process until unlinked, and mappings leak until "
                    f"closed — add the teardown pair "
                    f"(creator unlinks, both ends close)"))


def check(sources: List[Tuple[str, str]]) -> List[Finding]:
    findings: List[Finding] = []
    for relpath, text in sources:
        try:
            tree = ast.parse(text)
        except SyntaxError:
            continue  # codec family reports unparsable files
        _Scanner(relpath, findings).visit(tree)
        _check_shm_lifecycle(relpath, text, findings)
    return findings
