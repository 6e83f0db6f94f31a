"""Leveled per-subsystem debug logging (dout/derr analog).

Parity with the reference's ``src/common/dout.h`` pattern: each
subsystem (crush, osdmap, ec, balancer, ...) has an integer level 0-20
settable at runtime (``debug_<subsys>`` options); messages carry the
subsystem tag.  Built on :mod:`logging` so handlers/formatters compose
with the host application.
"""

from __future__ import annotations

import logging
import sys

_SUBSYS_LEVELS: dict[str, int] = {}
_BASE = "ceph_tpu_torch"


def _to_py_level(lvl: int) -> int:
    """Map 0-20 debug levels onto logging levels: 0 -> WARNING-ish
    silence, 1-5 -> INFO, >5 -> DEBUG (all messages)."""
    if lvl <= 0:
        return logging.WARNING
    if lvl <= 5:
        return logging.INFO
    return logging.DEBUG


def set_subsys_level(subsys: str, level: int) -> None:
    _SUBSYS_LEVELS[subsys] = level
    logging.getLogger(f"{_BASE}.{subsys}").setLevel(_to_py_level(level))


def get_subsys_level(subsys: str) -> int:
    return _SUBSYS_LEVELS.get(subsys, 1)


def get_logger(subsys: str) -> logging.Logger:
    logger = logging.getLogger(f"{_BASE}.{subsys}")
    if not logger.level:
        logger.setLevel(_to_py_level(get_subsys_level(subsys)))
    return logger


def init_logging(stream=None, level: int = 1) -> None:
    """Install a derr-style stderr handler on the package root."""
    root = logging.getLogger(_BASE)
    if root.handlers:
        return
    h = logging.StreamHandler(stream or sys.stderr)
    h.setFormatter(
        logging.Formatter(
            "%(asctime)s %(name)s %(levelname).1s %(message)s"
        )
    )
    root.addHandler(h)
    root.setLevel(_to_py_level(level))


def wire_config(config) -> None:
    """Subscribe subsystem levels to debug_* config options."""
    for name in list(config.schema):
        if name.startswith("debug_"):
            set_subsys_level(name[len("debug_"):], config.get(name))

    def on_change(name: str, value) -> None:
        if name.startswith("debug_"):
            set_subsys_level(name[len("debug_"):], value)

    config.add_observer(on_change)
