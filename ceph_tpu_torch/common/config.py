"""Typed, layered configuration.

Parity with the reference's option/config system (upstream
``src/common/options/*.yaml.in`` schemas code-generated into
``md_config_t``, ``src/common/config.cc``): options are declared with
name/type/default/level/description/see_also and validated; values
layer as compiled defaults < config file (JSON) < environment
(``CEPH_TPU_<NAME>``) < command line < runtime ``set`` — the same
precedence order as the reference's file/env/argv/mon-db stack.
Observers are notified on change (``md_config_obs_t`` analog).

The schema holds only the options the port's code reads, under the
reference's names; a later slice adds the options its own code reads.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Callable

OPT_INT = "int"
OPT_FLOAT = "float"
OPT_STR = "str"
OPT_BOOL = "bool"

_CASTS: dict[str, Callable[[str], Any]] = {
    OPT_INT: int,
    OPT_FLOAT: float,
    OPT_STR: str,
    OPT_BOOL: lambda s: s if isinstance(s, bool) else s.lower() in ("1", "true", "yes", "on"),
}

LEVEL_BASIC = "basic"
LEVEL_ADVANCED = "advanced"
LEVEL_DEV = "dev"


@dataclass(frozen=True)
class Option:
    name: str
    type: str
    default: Any
    level: str = LEVEL_ADVANCED
    desc: str = ""
    min: float | None = None
    max: float | None = None
    enum_allowed: tuple[str, ...] = ()
    see_also: tuple[str, ...] = ()

    def validate(self, value: Any) -> Any:
        try:
            value = _CASTS[self.type](value) if not isinstance(value, bool) or self.type == OPT_BOOL else value
        except (ValueError, TypeError) as e:
            raise ValueError(f"{self.name}: cannot parse {value!r} as {self.type}") from e
        if self.min is not None and value < self.min:
            raise ValueError(f"{self.name}: {value} < min {self.min}")
        if self.max is not None and value > self.max:
            raise ValueError(f"{self.name}: {value} > max {self.max}")
        if self.enum_allowed and value not in self.enum_allowed:
            raise ValueError(
                f"{self.name}: {value!r} not in {self.enum_allowed}"
            )
        return value


# The option schema (the *.yaml.in analog): the options the port reads.
SCHEMA: list[Option] = [
    Option("recovery_max_bytes_per_sec", OPT_FLOAT, 0.0, LEVEL_ADVANCED,
           "token-bucket cap on recovery decode bandwidth (bytes/s); "
           "0 disables the throttle", min=0.0,
           see_also=("recovery_burst_bytes",)),
    Option("recovery_burst_bytes", OPT_INT, 64 * 1024 * 1024, LEVEL_ADVANCED,
           "token-bucket burst size for the recovery throttle (bytes)",
           min=1, see_also=("recovery_max_bytes_per_sec",)),
    Option("recovery_max_debt_bytes", OPT_INT, 256 * 1024 * 1024,
           LEVEL_ADVANCED,
           "clamp on how far a single oversized request may drive the "
           "recovery token bucket negative (bytes); bounds the worst-case "
           "throttle stall to max_debt/rate seconds",
           min=1, see_also=("recovery_burst_bytes",)),
    Option("recovery_retry_max", OPT_INT, 4, LEVEL_ADVANCED,
           "re-derivations of a pattern group whose decode fails "
           "verification before its PGs are reported inconsistent "
           "(0 disables retry)", min=0),
    Option("recovery_xor_schedule", OPT_STR, "auto", LEVEL_ADVANCED,
           "batched-repair decode engine for pattern groups: 'auto' "
           "runs CSE-shrunk XOR schedules for bit-level (bitmatrix/"
           "cauchy) groups and keeps the GF(2^8) LUT decode for table "
           "codecs; 'on' forces XOR schedules for every group "
           "(bit-plane layout for table codecs); 'off' decodes "
           "bit-level groups with the dense bit-matrix product",
           enum_allowed=("auto", "on", "off")),
    Option("recovery_schedule_cache_max", OPT_INT, 64, LEVEL_ADVANCED,
           "bound on cached decode engines per ScheduleCache (compiled "
           "XOR schedules + dense adapters), evicted LRU; 0 removes "
           "the bound", min=0,
           see_also=("recovery_xor_schedule",)),
]


class Config:
    """Layered config: defaults < file < env < argv < runtime set."""

    ENV_PREFIX = "CEPH_TPU_"

    def __init__(
        self,
        config_file: str | None = None,
        argv: list[str] | None = None,
        env: dict[str, str] | None = None,
        schema: list[Option] | None = None,
    ):
        self.schema = {o.name: o for o in (schema or SCHEMA)}
        self._values: dict[str, Any] = {}
        self._source: dict[str, str] = {}
        self._observers: list[Callable[[str, Any], None]] = []
        if config_file and os.path.exists(config_file):
            with open(config_file) as f:
                for k, v in json.load(f).items():
                    self._set(k, v, "file")
        env = dict(os.environ if env is None else env)
        for k, v in env.items():
            if k.startswith(self.ENV_PREFIX):
                name = k[len(self.ENV_PREFIX):].lower()
                if name in self.schema:
                    self._set(name, v, "env")
        for arg in argv or []:
            if arg.startswith("--") and "=" in arg:
                name, v = arg[2:].split("=", 1)
                name = name.replace("-", "_")
                if name in self.schema:
                    self._set(name, v, "argv")

    def _set(self, name: str, value: Any, source: str) -> None:
        if name not in self.schema:
            raise KeyError(f"unknown option {name!r}")
        value = self.schema[name].validate(value)
        old = self._values.get(name)
        self._values[name] = value
        self._source[name] = source
        if old != value:
            for obs in self._observers:
                obs(name, value)

    def get(self, name: str) -> Any:
        if name in self._values:
            return self._values[name]
        return self.schema[name].default

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def set(self, name: str, value: Any) -> None:
        """Runtime override (the ``config set`` / admin-socket path)."""
        self._set(name, value, "override")

    def rm(self, name: str) -> None:
        self._values.pop(name, None)
        self._source.pop(name, None)

    def source(self, name: str) -> str:
        return self._source.get(name, "default")

    def add_observer(self, fn: Callable[[str, Any], None]) -> None:
        self._observers.append(fn)

    def show(self, level: str | None = None) -> dict[str, dict]:
        out = {}
        for name, opt in sorted(self.schema.items()):
            if level and opt.level != level:
                continue
            out[name] = {
                "value": self.get(name),
                "default": opt.default,
                "source": self.source(name),
                "level": opt.level,
                "desc": opt.desc,
            }
        return out


_global: Config | None = None


def global_config() -> Config:
    global _global
    if _global is None:
        _global = Config()
    return _global
