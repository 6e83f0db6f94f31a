"""CRUSH map model: hierarchy, rules, tunables, and dense packing.

The mutable Python model plays the role of the reference's CrushWrapper
mutation/serialization API (upstream ``src/crush/CrushWrapper.{h,cc}`` --
add_bucket / insert_item / adjust_item_weight / rule management /
tunable profiles), re-designed for a device pipeline: a map is *compiled*
(``to_dense``) into flat dense arrays -- the form both the C++ CPU
reference and the JAX interpreter consume -- rather than walked through
pointers.

Weights are 16.16 fixed point u32 (0x10000 == 1.0) exactly as in the
spec; bucket ids are negative, devices (OSDs) non-negative.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field, asdict

import numpy as np

ITEM_NONE = 0x7FFFFFFF

ALG_UNIFORM = 1
ALG_LIST = 2
ALG_TREE = 3
ALG_STRAW = 4
ALG_STRAW2 = 5

ALG_NAMES = {
    ALG_UNIFORM: "uniform",
    ALG_LIST: "list",
    ALG_TREE: "tree",
    ALG_STRAW: "straw",
    ALG_STRAW2: "straw2",
}
ALG_IDS = {v: k for k, v in ALG_NAMES.items()}

# Rule step opcodes (shared with cpp/crush_ref.cpp :: RuleStep).
OP_TAKE = 1
OP_CHOOSE_FIRSTN = 2
OP_CHOOSE_INDEP = 3
OP_CHOOSELEAF_FIRSTN = 4
OP_CHOOSELEAF_INDEP = 5
OP_EMIT = 6
OP_SET_CHOOSE_TRIES = 7
OP_SET_CHOOSELEAF_TRIES = 8
OP_SET_CHOOSE_LOCAL_TRIES = 9
OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 10
OP_SET_CHOOSELEAF_VARY_R = 11
OP_SET_CHOOSELEAF_STABLE = 12


@dataclass(frozen=True)
class Tunables:
    """Retry/stability knobs (upstream ``crush_map`` fields, crush.h)."""

    choose_total_tries: int = 50
    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1

    @staticmethod
    def profile(name: str) -> "Tunables":
        profiles = {
            # historical profiles; jewel == optimal == default
            "legacy": Tunables(19, 2, 5, 0, 0, 0),
            "argonaut": Tunables(19, 2, 5, 0, 0, 0),
            "bobtail": Tunables(50, 0, 0, 1, 0, 0),
            "firefly": Tunables(50, 0, 0, 1, 1, 0),
            "hammer": Tunables(50, 0, 0, 1, 1, 0),
            "jewel": Tunables(50, 0, 0, 1, 1, 1),
            "optimal": Tunables(50, 0, 0, 1, 1, 1),
            "default": Tunables(50, 0, 0, 1, 1, 1),
        }
        return profiles[name]


@dataclass
class Step:
    op: int
    arg1: int = 0
    arg2: int = 0


@dataclass
class Bucket:
    id: int  # negative
    name: str
    type_id: int
    alg: int = ALG_STRAW2
    items: list[int] = field(default_factory=list)
    item_weights: list[int] = field(default_factory=list)  # 16.16

    @property
    def weight(self) -> int:
        return sum(self.item_weights)


@dataclass
class Rule:
    id: int
    name: str
    kind: str = "replicated"  # or "erasure"
    steps: list[Step] = field(default_factory=list)


class CrushMap:
    """Mutable CRUSH map with a CrushWrapper-parity mutation API."""

    _uid_counter = itertools.count(1)

    def __init__(self, tunables: Tunables | None = None):
        self.tunables = tunables or Tunables.profile("default")
        self.types: dict[int, str] = {0: "osd"}
        self.buckets: dict[int, Bucket] = {}  # id (negative) -> bucket
        self.rules: dict[int, Rule] = {}
        self.device_names: dict[int, str] = {}  # osd id -> name
        self.device_classes: dict[int, str] = {}  # osd id -> class name
        # (uid, version) identifies map content for compile caches: uid
        # is process-unique (never reused, unlike id()), version bumps
        # on every API mutation.  Direct field edits bypass it —
        # mutate through the API.
        self.uid = next(CrushMap._uid_counter)
        self.version = 0
        self._dense_cache: dict = {}  # keyed (version, choose_args name)
        # per-pool alternate weight sets (reference crush_choose_arg /
        # CrushWrapper::choose_args, the crush-compat balancer's lever):
        # name -> {bucket_id -> [alt item weights]}
        self.choose_args: dict[str, dict[int, list[int]]] = {}
        self._shadow_of: dict[int, tuple[int, str]] = {}

    def _mutated(self) -> None:
        self.version += 1
        self._dense_cache = {}

    def set_tunables(self, tunables: Tunables | str) -> None:
        """Switch tunables (profile name or explicit Tunables); the API
        route so caches invalidate."""
        if isinstance(tunables, str):
            tunables = Tunables.profile(tunables)
        self.tunables = tunables
        self._mutated()

    def __getstate__(self):
        d = self.__dict__.copy()
        d["_dense_cache"] = {}  # not worth copying/pickling
        return d

    def __deepcopy__(self, memo):
        import copy as _copy

        new = CrushMap.__new__(CrushMap)
        memo[id(self)] = new
        state = self.__getstate__()
        new.__dict__.update(_copy.deepcopy(state, memo))
        # a copy is a distinct map for cache purposes
        new.uid = next(CrushMap._uid_counter)
        return new

    # ---- types ----

    def add_type(self, type_id: int, name: str) -> None:
        self.types[type_id] = name
        self._mutated()

    def type_id(self, name: str) -> int:
        for tid, tname in self.types.items():
            if tname == name:
                return tid
        raise KeyError(name)

    # ---- devices ----

    def add_device(self, osd: int, name: str | None = None, device_class: str | None = None) -> None:
        self.device_names[osd] = name or f"osd.{osd}"
        if device_class is not None:
            self.device_classes[osd] = device_class
        self._mutated()

    @property
    def max_devices(self) -> int:
        ids = list(self.device_names)
        for b in self.buckets.values():
            ids.extend(i for i in b.items if i >= 0)
        return max(ids, default=-1) + 1

    # ---- buckets ----

    def add_bucket(
        self,
        name: str,
        type_name: str,
        alg: int = ALG_STRAW2,
        bucket_id: int | None = None,
    ) -> Bucket:
        if bucket_id is None:
            bucket_id = min(self.buckets, default=0) - 1
        if bucket_id >= 0 or bucket_id in self.buckets:
            raise ValueError(f"bad bucket id {bucket_id}")
        if any(b.name == name for b in self.buckets.values()):
            raise ValueError(f"duplicate bucket name {name}")
        b = Bucket(id=bucket_id, name=name, type_id=self.type_id(type_name), alg=alg)
        self.buckets[bucket_id] = b
        self._mutated()
        return b

    def bucket_by_name(self, name: str) -> Bucket:
        for b in self.buckets.values():
            if b.name == name:
                return b
        raise KeyError(name)

    def item_name(self, item: int) -> str:
        if item >= 0:
            return self.device_names.get(item, f"osd.{item}")
        return self.buckets[item].name

    def insert_item(self, bucket_id: int, item: int, weight: int) -> None:
        """Add item (device >= 0 or bucket < 0) with 16.16 weight."""
        b = self.buckets[bucket_id]
        if item in b.items:
            raise ValueError(f"item {item} already in bucket {b.name}")
        if item >= 0 and item not in self.device_names:
            self.add_device(item)
        b.items.append(item)
        b.item_weights.append(int(weight))
        self._mutated()

    def remove_item(self, bucket_id: int, item: int) -> None:
        b = self.buckets[bucket_id]
        i = b.items.index(item)
        del b.items[i]
        del b.item_weights[i]
        self._mutated()

    def adjust_item_weight(self, bucket_id: int, item: int, weight: int) -> None:
        b = self.buckets[bucket_id]
        b.item_weights[b.items.index(item)] = int(weight)
        self._mutated()

    def adjust_subtree_weights(self, bucket_id: int) -> int:
        """Recompute this subtree's item weights bottom-up; returns total."""
        b = self.buckets[bucket_id]
        self._mutated()
        total = 0
        for i, item in enumerate(b.items):
            if item < 0:
                b.item_weights[i] = self.adjust_subtree_weights(item)
            total += b.item_weights[i]
        return total

    def parent_of(self, item: int) -> int | None:
        for b in self.buckets.values():
            if item in b.items:
                return b.id
        return None

    # ---- rules ----

    def add_rule(self, name: str, steps: list[Step], kind: str = "replicated", rule_id: int | None = None) -> Rule:
        if rule_id is None:
            rule_id = max(self.rules, default=-1) + 1
        r = Rule(id=rule_id, name=name, kind=kind, steps=steps)
        self.rules[rule_id] = r
        self._mutated()
        return r

    def rule_by_name(self, name: str) -> Rule:
        for r in self.rules.values():
            if r.name == name:
                return r
        raise KeyError(name)

    def make_replicated_rule(
        self,
        name: str,
        root: str,
        failure_domain: str,
        device_class: str | None = None,
    ) -> Rule:
        """`take root [class X]; chooseleaf firstn 0 type fd; emit`."""
        root_id = self._resolve_take(root, device_class)
        fd = self.type_id(failure_domain)
        steps = [Step(OP_TAKE, root_id), Step(OP_CHOOSELEAF_FIRSTN, 0, fd), Step(OP_EMIT)]
        return self.add_rule(name, steps)

    def make_erasure_rule(
        self,
        name: str,
        root: str,
        failure_domain: str,
        device_class: str | None = None,
    ) -> Rule:
        root_id = self._resolve_take(root, device_class)
        fd = self.type_id(failure_domain)
        steps = [
            Step(OP_SET_CHOOSELEAF_TRIES, 5),
            Step(OP_TAKE, root_id),
            Step(OP_CHOOSELEAF_INDEP, 0, fd) if fd != 0 else Step(OP_CHOOSE_INDEP, 0, 0),
            Step(OP_EMIT),
        ]
        return self.add_rule(name, steps, kind="erasure")

    def _resolve_take(self, root: str, device_class: str | None) -> int:
        if device_class is None:
            return self.bucket_by_name(root).id
        return self.class_shadow_root(
            self.bucket_by_name(root).id, device_class
        )

    # ---- device-class shadow trees ----
    #
    # Reference semantics (CrushWrapper::populate_classes /
    # device_class_clone): a rule's `take <root> class <c>` resolves to
    # a per-class clone of the subtree containing only the devices of
    # that class, buckets named `<name>~<c>`, with weights re-summed.
    # Shadow trees are rebuilt on demand and tracked so decompile can
    # print the class form.

    def class_shadow_root(self, root_id: int, device_class: str) -> int:
        shadow = self._build_class_shadow(root_id, device_class)
        if shadow is None:
            raise ValueError(
                f"no devices of class {device_class!r} under "
                f"{self.buckets[root_id].name}"
            )
        return shadow

    def shadow_origin(self, bucket_id: int) -> tuple[int, str] | None:
        """(original bucket id, class) if bucket_id is a shadow."""
        return getattr(self, "_shadow_of", {}).get(bucket_id)

    def _build_class_shadow(self, bid: int, cls: str) -> int | None:
        if not hasattr(self, "_shadow_of"):
            self._shadow_of: dict[int, tuple[int, str]] = {}
        b = self.buckets[bid]
        shadow_name = f"{b.name}~{cls}"
        keep_id = None
        try:
            existing = self.bucket_by_name(shadow_name)
            # rebuild in place (weights may have changed), keeping the
            # id stable so rules referencing the shadow stay valid
            keep_id = existing.id
            del self.buckets[existing.id]
            self._shadow_of.pop(existing.id, None)
            self._mutated()
        except KeyError:
            pass
        items: list[int] = []
        weights: list[int] = []
        for item, w in zip(b.items, b.item_weights):
            if item >= 0:
                if self.device_classes.get(item) == cls:
                    items.append(item)
                    weights.append(w)
            else:
                sub = self._build_class_shadow(item, cls)
                if sub is not None:
                    items.append(sub)
                    weights.append(self.buckets[sub].weight)
        if not items:
            return None
        sb = self.add_bucket(
            shadow_name, self.types[b.type_id], alg=b.alg, bucket_id=keep_id
        )
        for item, w in zip(items, weights):
            self.insert_item(sb.id, item, w)
        self._shadow_of[sb.id] = (bid, cls)
        return sb.id

    # ---- hierarchy queries ----

    def max_depth(self) -> int:
        """Longest bucket chain (root bucket -> ... -> device edge count)."""

        def depth(bid: int) -> int:
            b = self.buckets[bid]
            sub = [depth(i) for i in b.items if i < 0]
            return 1 + max(sub, default=0)

        roots = [bid for bid in self.buckets if self.parent_of(bid) is None]
        return max((depth(r) for r in roots), default=0)

    # ---- serialization (framework-native, versioned JSON) ----

    def to_obj(self) -> dict:
        return {
            "version": 1,
            "tunables": asdict(self.tunables),
            "types": self.types,
            "devices": {str(k): v for k, v in self.device_names.items()},
            "device_classes": {str(k): v for k, v in self.device_classes.items()},
            "buckets": [
                {
                    "id": b.id,
                    "name": b.name,
                    "type_id": b.type_id,
                    "alg": b.alg,
                    "items": b.items,
                    "item_weights": b.item_weights,
                }
                for b in self.buckets.values()
            ],
            "rules": [
                {
                    "id": r.id,
                    "name": r.name,
                    "kind": r.kind,
                    "steps": [[s.op, s.arg1, s.arg2] for s in r.steps],
                }
                for r in self.rules.values()
            ],
            "choose_args": {
                name: {str(bid): w for bid, w in per.items()}
                for name, per in self.choose_args.items()
            },
            "shadow_of": {
                str(sid): [orig, cls]
                for sid, (orig, cls) in self._shadow_of.items()
            },
        }

    def encode(self) -> bytes:
        return json.dumps(self.to_obj(), sort_keys=True).encode()

    @staticmethod
    def from_obj(obj: dict) -> "CrushMap":
        m = CrushMap(Tunables(**obj["tunables"]))
        m.types = {int(k): v for k, v in obj["types"].items()}
        m.device_names = {int(k): v for k, v in obj["devices"].items()}
        m.device_classes = {int(k): v for k, v in obj.get("device_classes", {}).items()}
        for bo in obj["buckets"]:
            b = Bucket(
                id=bo["id"],
                name=bo["name"],
                type_id=bo["type_id"],
                alg=bo["alg"],
                items=list(bo["items"]),
                item_weights=list(bo["item_weights"]),
            )
            m.buckets[b.id] = b
        for ro in obj["rules"]:
            m.rules[ro["id"]] = Rule(
                id=ro["id"],
                name=ro["name"],
                kind=ro["kind"],
                steps=[Step(*s) for s in ro["steps"]],
            )
        m.choose_args = {
            name: {int(bid): list(w) for bid, w in per.items()}
            for name, per in obj.get("choose_args", {}).items()
        }
        m._shadow_of = {
            int(sid): (orig, cls)
            for sid, (orig, cls) in obj.get("shadow_of", {}).items()
        }
        m._mutated()
        return m

    @staticmethod
    def decode(data: bytes) -> "CrushMap":
        return CrushMap.from_obj(json.loads(data.decode()))

    # ---- choose_args (alternate weight sets) ----

    def create_choose_args(self, name: str) -> dict[int, list[int]]:
        """New weight-set initialized from the current bucket weights."""
        per = {bid: list(b.item_weights) for bid, b in self.buckets.items()}
        self.choose_args[name] = per
        self._mutated()
        return per

    def rm_choose_args(self, name: str) -> None:
        self.choose_args.pop(name, None)
        self._mutated()

    def choose_args_name_for_pool(self, pool_id: int) -> str | None:
        """Weight-set placement resolution (upstream ``do_rule`` picks
        choose_args by pool id, falling back to the compat set)."""
        if str(pool_id) in self.choose_args:
            return str(pool_id)
        if "compat" in self.choose_args:
            return "compat"
        return None

    def choose_args_adjust_item_weight(
        self, name: str, bucket_id: int, item: int, weight: int
    ) -> None:
        b = self.buckets[bucket_id]
        self.choose_args[name][bucket_id][b.items.index(item)] = int(weight)
        self._mutated()

    # ---- dense packing ----

    def to_dense(self, choose_args: str | None = None) -> "DenseCrushMap":
        # small dict, not a single slot: with per-pool weight sets the
        # host placement path alternates choose_args names per pool and
        # a one-entry cache would rebuild the dense map per PG lookup
        key = (self.version, choose_args)
        cached = self._dense_cache.get(key)
        if cached is not None:
            return cached
        if len(self._dense_cache) >= 8 or (
            self._dense_cache and next(iter(self._dense_cache))[0] != self.version
        ):
            self._dense_cache.clear()  # stale version or cap reached
        dense = self._to_dense(choose_args)
        self._dense_cache[key] = dense
        return dense

    def _to_dense(self, choose_args: str | None = None) -> "DenseCrushMap":
        n_buckets = max((-bid for bid in self.buckets), default=0)
        max_fanout = max((len(b.items) for b in self.buckets.values()), default=1)
        max_fanout = max(max_fanout, 1)
        override = self.choose_args.get(choose_args, {}) if choose_args else {}
        alg = np.zeros(n_buckets, np.int32)
        btype = np.zeros(n_buckets, np.int32)
        size = np.zeros(n_buckets, np.int32)
        items = np.zeros((n_buckets, max_fanout), np.int32)
        weights = np.zeros((n_buckets, max_fanout), np.uint32)
        for bid, b in self.buckets.items():
            i = -1 - bid
            alg[i] = b.alg
            btype[i] = b.type_id
            size[i] = len(b.items)
            items[i, : len(b.items)] = b.items
            w = override.get(bid, b.item_weights)
            if len(w) != len(b.items):  # stale weight-set row: fall back
                w = b.item_weights
            weights[i, : len(b.items)] = w
        from .legacy import aux_arrays

        aux = aux_arrays(alg, size, weights)  # None unless legacy algs
        scaled, tree_w, max_nodes = aux if aux is not None else (None, None, 0)
        return DenseCrushMap(
            n_buckets=n_buckets,
            max_fanout=max_fanout,
            max_devices=self.max_devices,
            max_depth=self.max_depth(),
            tunables=self.tunables,
            alg=alg,
            btype=btype,
            size=size,
            items=items,
            weights=weights,
            scaled=scaled,
            tree_weights=tree_w,
            max_tree_nodes=max_nodes,
        )


@dataclass
class DenseCrushMap:
    """Flat dense form consumed by the C++ reference and the JAX path."""

    n_buckets: int
    max_fanout: int
    max_devices: int
    max_depth: int
    tunables: Tunables
    alg: np.ndarray  # [n_buckets] int32
    btype: np.ndarray  # [n_buckets] int32
    size: np.ndarray  # [n_buckets] int32
    items: np.ndarray  # [n_buckets, max_fanout] int32
    weights: np.ndarray  # [n_buckets, max_fanout] uint32
    # legacy-alg derived state (upstream builder.c), present only when a
    # list/straw1/tree bucket exists: per-item straws (straw1) or prefix
    # sums (list) packed in one table, plus tree node weights
    scaled: np.ndarray | None = None  # [n_buckets, max_fanout] uint32
    tree_weights: np.ndarray | None = None  # [n_buckets, max_tree_nodes] u32
    max_tree_nodes: int = 0

    def algs_present(self) -> set[int]:
        return set(int(a) for a in np.unique(self.alg[self.size > 0]))

    def legacy_algs_present(self) -> set[int]:
        return self.algs_present() & {ALG_LIST, ALG_TREE, ALG_STRAW}
