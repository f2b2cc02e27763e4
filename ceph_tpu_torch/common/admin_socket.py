# Copy of ceph_tpu/common/admin_socket.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Admin socket: per-daemon unix-socket command server.

Role-equivalent of the reference's AdminSocket (reference
src/common/admin_socket.cc): each daemon exposes a ``.asok`` unix socket;
clients send a JSON request ``{"prefix": "<command>", ...args}`` terminated
by newline and receive a JSON reply.  Subsystems register hooks at runtime;
the always-present core commands mirror the reference's: ``help``,
``version``, ``perf dump``, ``perf schema``, ``config show``, ``config
set``, ``config diff``, ``log flush``, ``log dump``, ``dump_historic_ops``
/ ``dump_ops_in_flight`` (via the OpTracker hook, src/common/TrackedOp.h).
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Any, Callable, Dict, Optional


class AdminSocket:
    def __init__(self, ctx, path: Optional[str] = None):
        self.ctx = ctx
        self.path = path
        self._hooks: Dict[str, Callable[[Dict[str, Any]], Any]] = {}
        self._help: Dict[str, str] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self.register("help", lambda a: dict(self._help), "list commands")
        self.register("version", lambda a: {"version": self.ctx.version},
                      "framework version")
        self.register("perf dump", lambda a: self.ctx.perf.dump(),
                      "dump perf counters")
        self.register("perf schema", lambda a: self.ctx.perf.schema(),
                      "dump perf counter schema")
        self.register("perf reset", self._perf_reset,
                      "zero counters in one set (name=<set>) or all sets")
        self.register("config show", lambda a: self.ctx.conf.show(),
                      "effective config")
        self.register("config diff", lambda a: self.ctx.conf.diff(),
                      "config vs defaults")
        self.register("config set", self._config_set, "set a runtime option")
        self.register("config get", lambda a: {a["key"]: self.ctx.conf.get(a["key"])},
                      "get one option")
        self.register("log flush", self._log_flush, "drain async log writes")
        self.register("log dump", self._log_dump, "dump in-memory log ring")
        # reference command name (`ceph daemon X log dump_recent`): same
        # ring, including the separately pinned error entries
        self.register("log dump_recent", self._log_dump,
                      "dump in-memory log ring (alias of log dump)")

    # -- hooks ---------------------------------------------------------------

    def register(self, prefix: str, hook: Callable[[Dict[str, Any]], Any],
                 help_text: str = "") -> None:
        self._hooks[prefix] = hook
        self._help[prefix] = help_text

    def unregister(self, prefix: str) -> None:
        self._hooks.pop(prefix, None)
        self._help.pop(prefix, None)

    def _perf_reset(self, args: Dict[str, Any]) -> Dict[str, Any]:
        reset = self.ctx.perf.reset(args.get("name", "all"))
        return {"success": bool(reset), "reset": reset}

    def _config_set(self, args: Dict[str, Any]) -> Dict[str, Any]:
        self.ctx.conf.set(args["key"], args["value"], source="cli")
        return {"success": True, "key": args["key"], "value": self.ctx.conf.get(args["key"])}

    def _log_flush(self, args: Dict[str, Any]) -> Dict[str, Any]:
        self.ctx.log.flush()
        return {"success": True}

    def _log_dump(self, args: Dict[str, Any]) -> Any:
        return [
            {"stamp": e[0], "subsys": e[1], "level": e[2], "message": e[3]}
            for e in self.ctx.log.dump_recent()
        ]

    # -- direct (in-process) execution --------------------------------------

    def execute(self, prefix: str, **args: Any) -> Any:
        """Run one hook.  May return an AWAITABLE when the hook is an
        async def (long-running commands like `pg scrub`): async
        callers (the unix-socket server, the MCommand tell handlers)
        await it; sync callers get the coroutine and must drive it."""
        hook = self._hooks.get(prefix)
        if hook is None:
            raise KeyError(f"unknown admin command {prefix!r}")
        return hook(args)

    async def execute_async(self, prefix: str, **args: Any) -> Any:
        """execute(), with awaitable results awaited — the one call
        async transports (asok server, MCommand) should use."""
        import inspect

        result = self.execute(prefix, **args)
        if inspect.isawaitable(result):
            result = await result
        return result

    # -- unix socket server --------------------------------------------------

    async def start(self, path: Optional[str] = None) -> str:
        self.path = path or self.path
        if self.path is None:
            raise ValueError("admin socket path not set")
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._server = await asyncio.start_unix_server(self._serve, path=self.path)
        return self.path

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=1.0)
            except asyncio.TimeoutError:
                pass
            self._server = None
        if self.path and os.path.exists(self.path):
            try:
                os.unlink(self.path)
            except OSError:
                pass

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                try:
                    req = json.loads(line)
                    prefix = req.pop("prefix")
                    result = await self.execute_async(prefix, **req)
                    reply = {"ok": True, "result": result}
                except Exception as e:  # command errors go back to the caller
                    reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                writer.write(json.dumps(reply, default=repr).encode() + b"\n")
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()


async def asok_command(path: str, prefix: str, **args: Any) -> Any:
    """Client helper: one command against a daemon's admin socket
    (the `ceph daemon <name> <cmd>` role)."""
    reader, writer = await asyncio.open_unix_connection(path)
    try:
        req = {"prefix": prefix, **args}
        writer.write(json.dumps(req).encode() + b"\n")
        await writer.drain()
        line = await reader.readline()
        reply = json.loads(line)
        if not reply.get("ok"):
            raise RuntimeError(reply.get("error", "admin command failed"))
        return reply["result"]
    finally:
        writer.close()
