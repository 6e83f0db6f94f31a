from .map import (  # noqa: F401
    ALG_STRAW2,
    ALG_UNIFORM,
    ITEM_NONE,
    Bucket,
    CrushMap,
    DenseCrushMap,
    Rule,
    Step,
    Tunables,
)
