"""EC plugin registry: profile strings -> codec instances on a device.

Parity with the reference's ``src/erasure-code/ErasureCodePlugin.{h,cc}``
(``ErasureCodePluginRegistry::{instance,load,add,get,factory}``), minus
``dlopen``: plugins register via :func:`register_plugin` (the
``__erasure_code_init`` analog) at import, or lazily through the
built-in table.  Profiles are string->string maps exactly like the
reference's (``plugin=``, ``k``, ``m``, ``technique``, ``w``,
``packetsize``, ``crush-failure-domain``, ...).

The port's factory also takes the device the codec computes on
(default ``"cuda"``, which raises without a card) and sets it on the
plugin before ``init``, so every inner codec (LRC's layers, CLAY's
base code, decoders) is built on the same device.
"""

from __future__ import annotations

from typing import Callable

from .. import resolve_device
from .interface import ErasureCodeInterface, ErasureCodeError, Profile

_PLUGINS: dict[str, Callable[[], "type[ErasureCodeInterface]"]] = {}


def register_plugin(name: str, loader: Callable[[], type]) -> None:
    _PLUGINS[name] = loader


def _builtin(name: str):
    if name in ("jerasure", "jax"):
        from .plugins.jerasure import ErasureCodeJerasure

        return ErasureCodeJerasure
    if name == "isa":
        from .plugins.isa import ErasureCodeIsa

        return ErasureCodeIsa
    if name == "lrc":
        from .plugins.lrc import ErasureCodeLrc

        return ErasureCodeLrc
    if name == "clay":
        from .plugins.clay import ErasureCodeClay

        return ErasureCodeClay
    if name == "shec":
        from .plugins.shec import ErasureCodeShec

        return ErasureCodeShec
    return None


class ErasureCodePluginRegistry:
    """Singleton factory keyed by plugin name."""

    _instance: "ErasureCodePluginRegistry | None" = None

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def load(self, name: str):
        if name in _PLUGINS:
            return _PLUGINS[name]()
        klass = _builtin(name)
        if klass is None:
            raise ErasureCodeError(f"unknown erasure-code plugin {name!r}")
        return klass

    def factory(self, profile: dict[str, str] | Profile,
                device="cuda") -> ErasureCodeInterface:
        if isinstance(profile, dict):
            profile = Profile(dict(profile))
        name = profile.get("plugin", "jerasure")
        klass = self.load(name)
        ec = klass()
        ec.device = resolve_device(device)
        ec.init(profile)
        return ec


def create(profile: dict[str, str], device="cuda") -> ErasureCodeInterface:
    """Convenience: build + init a codec from a profile dict on
    ``device``."""
    return ErasureCodePluginRegistry.instance().factory(profile, device)
