from .map import OSDMap, Pool, Incremental, PGId
from .mapping import OSDMapMapping, compile_pool_mapping

__all__ = [
    "OSDMap",
    "Pool",
    "Incremental",
    "PGId",
    "OSDMapMapping",
    "compile_pool_mapping",
]
