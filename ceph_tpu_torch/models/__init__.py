from .clusters import build_flat, build_hierarchy, build_simple  # noqa: F401
