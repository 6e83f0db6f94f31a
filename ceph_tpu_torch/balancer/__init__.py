"""The balancer: the upmap optimizer (``calc_pg_upmaps``), the mgr
balancer's evaluate/optimize/execute loop (``Balancer``, upmap and
crush-compat modes) and the pg_num autoscaler.  Remaps and the upmap
scorer run on the device the caller names (the card by default)."""

from .upmap import calc_pg_upmaps
from .module import Balancer, Eval

__all__ = ["calc_pg_upmaps", "Balancer", "Eval"]
