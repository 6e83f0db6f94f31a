"""Unix-socket live introspection (AdminSocket analog).

Parity with the reference's ``src/common/admin_socket.{h,cc}``
(``ceph daemon <x> perf dump`` / ``config show`` / ``config set``):
a background thread serves newline-delimited JSON commands
(``{"prefix": "perf dump"}``) over a unix socket, replying with JSON.
Custom hooks register like ``AdminSocketHook``s.

The reference package's cache dumps are served: ``dump_ec_schedules``,
``dump_placement_caches`` (the fused placement->peering pipeline cache
and the EC schedule cache's counters) and ``dump_stripe_cache`` (the
online write path's stripe buffers).
"""

from __future__ import annotations

import json
import os
import socket
import threading
from typing import Callable

from .config import Config, global_config
from .perf_counters import registry


class AdminSocket:
    def __init__(self, path: str, config: Config | None = None):
        self.path = path
        self.config = config or global_config()
        self._hooks: dict[str, Callable[[dict], dict]] = {}
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.register("perf dump", lambda cmd: registry().dump())
        self.register("perf schema", lambda cmd: registry().schema())
        self.register(
            "perf reset", lambda cmd: (registry().reset(), {"success": "reset"})[1]
        )
        self.register("config show", lambda cmd: self.config.show())
        self.register("config set", self._config_set)
        self.register("dump_ec_schedules", self._dump_ec_schedules)
        self.register("dump_placement_caches", self._dump_placement_caches)
        self.register("dump_stripe_cache", self._dump_stripe_cache)
        self.register("help", lambda cmd: {"commands": sorted(self._hooks)})

    @staticmethod
    def _dump_ec_schedules(cmd: dict) -> dict:
        # lazy import: the hook must not pull torch into processes that
        # only poke config/perf over the socket
        from ..ec.schedule import dump_ec_schedules

        return dump_ec_schedules()

    @staticmethod
    def _dump_placement_caches(cmd: dict) -> dict:
        # lazy import, same reason as _dump_ec_schedules
        from ..recovery.pipeline import dump_placement_caches

        return dump_placement_caches()

    @staticmethod
    def _dump_stripe_cache(cmd: dict) -> dict:
        # lazy import, same reason as _dump_ec_schedules
        from ..ec.online import dump_stripe_cache

        return dump_stripe_cache()

    def _config_set(self, cmd: dict) -> dict:
        self.config.set(cmd["key"], cmd["value"])
        return {"success": f"{cmd['key']} = {self.config.get(cmd['key'])}"}

    def register(self, prefix: str, hook: Callable[[dict], dict]) -> None:
        self._hooks[prefix] = hook

    def start(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.path)
        self._sock.listen(4)
        self._sock.settimeout(0.2)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        assert self._sock is not None
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                # bound per-connection time: an idle client must not
                # wedge the single-threaded serve loop
                conn.settimeout(2.0)
                data = b""
                while not data.endswith(b"\n"):
                    try:
                        chunk = conn.recv(65536)
                    except socket.timeout:
                        break
                    if not chunk:
                        break
                    data += chunk
                try:
                    cmd = json.loads(data.decode() or "{}")
                    hook = self._hooks.get(cmd.get("prefix", ""))
                    if hook is None:
                        reply = {"error": f"unknown command {cmd.get('prefix')!r}"}
                    else:
                        reply = hook(cmd)
                except Exception as e:  # noqa: BLE001 — reply with the error
                    reply = {"error": str(e)}
                conn.sendall(json.dumps(reply).encode() + b"\n")
            finally:
                conn.close()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        if self._sock:
            self._sock.close()
        if os.path.exists(self.path):
            os.unlink(self.path)


def ask(path: str, prefix: str, **kwargs) -> dict:
    """Client helper (the ``ceph daemon`` side)."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(path)
    try:
        s.sendall(json.dumps({"prefix": prefix, **kwargs}).encode() + b"\n")
        data = b""
        while not data.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        return json.loads(data.decode())
    finally:
        s.close()
