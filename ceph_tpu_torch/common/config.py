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
           "decode-launch retries before a pattern group's PGs are "
           "reported failed (0 disables retry)", min=0,
           see_also=("recovery_backoff_base_ms",)),
    Option("recovery_backoff_base_ms", OPT_FLOAT, 50.0, LEVEL_ADVANCED,
           "base delay for exponential backoff between decode-launch "
           "retries (milliseconds); doubled per attempt plus seeded "
           "jitter", min=0.0, see_also=("recovery_retry_max",)),
    Option("recovery_shard_groups", OPT_BOOL, True, LEVEL_ADVANCED,
           "route large pattern groups through the mesh-sharded decode "
           "when the executor is given a mesh (byte axis split over "
           "devices, psum'd progress counters)",
           see_also=("recovery_shard_min_bytes",)),
    Option("recovery_shard_min_bytes", OPT_INT, 1 << 23, LEVEL_ADVANCED,
           "smallest pattern-group operand (bytes moved: read + "
           "rebuilt) routed to the mesh-sharded decode; smaller groups "
           "stay on the single-device fast path where dispatch + "
           "collective overhead beats the parallelism.  Default is the "
           "reference package's (its CPU crossover on 8 virtual "
           "devices); the port's crossover is not measured", min=0,
           see_also=("recovery_shard_groups",)),
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
           "the bound.  Long chaos timelines visit many erasure "
           "patterns — without a bound the cache grows for the life "
           "of the run", min=0,
           see_also=("recovery_xor_schedule",)),
    Option("recovery_coschedule_max", OPT_INT, 4, LEVEL_ADVANCED,
           "small pattern groups dispatched back-to-back per "
           "supervised scheduling window when a mesh is attached "
           "(async launches round-robined over local devices); 1 "
           "serializes launches as before", min=1),
    Option("recovery_work_stealing", OPT_STR, "auto", LEVEL_ADVANCED,
           "route byte-level pattern groups through the fault-tolerant "
           "work-stealing dispatcher (over-decomposed sub-shards, "
           "greedy assignment as chips drain, straggler hedging, "
           "chip conviction): 'auto' enables it only when a rank "
           "drives more than one CUDA device and keeps the static "
           "sharded path otherwise; "
           "'on' forces it everywhere (tests/benches); 'off' pins the "
           "static path", enum_allowed=("auto", "on", "off"),
           see_also=("recovery_subshards_per_chip",
                     "recovery_dispatch_hedge_factor",
                     "recovery_chip_fail_threshold")),
    Option("recovery_subshards_per_chip", OPT_INT, 4, LEVEL_ADVANCED,
           "over-decomposition factor for work-stealing dispatch: each "
           "pattern group splits into ~subshards_per_chip x n_chips "
           "byte-range sub-shards (power-of-two bucketed widths, so "
           "the split never recompiles); higher values smooth skewed "
           "group mixes at the cost of per-launch overhead", min=1,
           see_also=("recovery_work_stealing",)),
    Option("recovery_dispatch_hedge_factor", OPT_FLOAT, 3.0,
           LEVEL_ADVANCED,
           "straggler deadline multiplier: a sub-shard is overdue (and "
           "hedge-redispatched to an idle chip) when its launch runs "
           "longer than hedge_factor x the owning chip's EWMA "
           "completion-time estimate; first completion wins, the "
           "loser's bytes are discarded", min=1.0,
           see_also=("recovery_work_stealing",
                     "recovery_chip_fail_threshold")),
    Option("recovery_chip_fail_threshold", OPT_INT, 3, LEVEL_ADVANCED,
           "consecutive deadline misses before a chip is convicted and "
           "its queue drains to survivors; ChipLostError is raised "
           "only when every chip is convicted (never a hang)", min=1,
           see_also=("recovery_dispatch_hedge_factor",
                     "recovery_retry_max")),
    Option("osd_op_complaint_time", OPT_FLOAT, 30.0, LEVEL_ADVANCED,
           "an op in flight (or completed) at least this old (seconds) "
           "is a slow op: counted, kept in the slow-op history, and "
           "surfaced by dump_slow_ops_in_flight / "
           "dump_historic_slow_ops (reference analog of the same name)",
           min=0.0),
    Option("osd_mclock_client_res_bps", OPT_FLOAT, 0.0, LEVEL_ADVANCED,
           "mclock reservation for client traffic (bytes/s guaranteed); "
           "0 disables the reservation term",
           min=0.0, see_also=("osd_mclock_client_wgt",
                              "osd_mclock_client_lim_bps")),
    Option("osd_mclock_client_wgt", OPT_FLOAT, 1.0, LEVEL_ADVANCED,
           "mclock weight for client traffic (relative share of "
           "capacity past reservations)", min=0.0),
    Option("osd_mclock_client_lim_bps", OPT_FLOAT, 0.0, LEVEL_ADVANCED,
           "mclock limit for client traffic (bytes/s hard cap); 0 "
           "means uncapped", min=0.0),
    Option("osd_mclock_recovery_res_bps", OPT_FLOAT, 0.0, LEVEL_ADVANCED,
           "mclock reservation for recovery (bytes/s guaranteed so "
           "client load can never starve repair); 0 disables",
           min=0.0, see_also=("osd_mclock_recovery_wgt",
                              "osd_mclock_recovery_lim_bps")),
    Option("osd_mclock_recovery_wgt", OPT_FLOAT, 1.0, LEVEL_ADVANCED,
           "mclock weight for recovery traffic", min=0.0),
    Option("osd_mclock_recovery_lim_bps", OPT_FLOAT, 0.0, LEVEL_ADVANCED,
           "mclock limit for recovery (bytes/s hard cap bounding its "
           "interference with client tail latency); 0 means uncapped",
           min=0.0),
    Option("osd_mclock_scrub_res_bps", OPT_FLOAT, 0.0, LEVEL_ADVANCED,
           "mclock reservation for scrub traffic (bytes/s guaranteed "
           "so client/recovery load can never starve integrity "
           "checking); 0 disables",
           min=0.0, see_also=("osd_mclock_scrub_wgt",
                              "osd_mclock_scrub_lim_bps")),
    Option("osd_mclock_scrub_wgt", OPT_FLOAT, 0.5, LEVEL_ADVANCED,
           "mclock weight for scrub traffic (background work: half a "
           "client share by default)", min=0.0),
    Option("osd_mclock_scrub_lim_bps", OPT_FLOAT, 0.0, LEVEL_ADVANCED,
           "mclock limit for scrub traffic (bytes/s hard cap bounding "
           "a scrub storm's interference with client tail latency); 0 "
           "means uncapped", min=0.0),
    Option("osd_heartbeat_interval", OPT_FLOAT, 6.0, LEVEL_ADVANCED,
           "seconds between OSD heartbeat pings (drives the liveness "
           "detector's polling cadence when nothing else advances the "
           "virtual clock)", min=0.001,
           see_also=("osd_heartbeat_grace",)),
    Option("osd_heartbeat_grace", OPT_FLOAT, 20.0, LEVEL_ADVANCED,
           "seconds without an ack before the detector may mark an "
           "OSD down (the mon/OSD heartbeat grace of the same name)",
           min=0.0, see_also=("mon_osd_adjust_heartbeat_grace",)),
    Option("mon_osd_down_out_interval", OPT_FLOAT, 600.0, LEVEL_ADVANCED,
           "seconds a detector-marked-down OSD stays down before it "
           "is automatically marked out (0 disables auto-out); "
           "map-event downs are never auto-outed", min=0.0,
           see_also=("mon_osd_min_in_ratio",)),
    Option("mon_osd_min_in_ratio", OPT_FLOAT, 0.75, LEVEL_ADVANCED,
           "auto-out stops once it would push the in-OSD fraction "
           "below this floor (reference analog of the same name)",
           min=0.0, max=1.0),
    Option("mon_osd_min_down_reporters", OPT_INT, 2, LEVEL_ADVANCED,
           "distinct peer failure reports required before a "
           "heartbeat-silent OSD can be marked down", min=1),
    Option("mon_osd_laggy_halflife", OPT_FLOAT, 3600.0, LEVEL_ADVANCED,
           "decay halflife (seconds) for the per-OSD laggy score and "
           "the markdown (flap) count", min=0.001),
    Option("mon_osd_laggy_weight", OPT_FLOAT, 0.3, LEVEL_ADVANCED,
           "EWMA weight a slow-but-acking OSD's laggy score gains per "
           "heartbeat tick", min=0.0, max=1.0),
    Option("mon_osd_adjust_heartbeat_grace", OPT_BOOL, True,
           LEVEL_ADVANCED,
           "scale the effective heartbeat grace by 2^markdowns for "
           "repeat offenders (the markdown-log flap damper); off = "
           "flat grace",
           see_also=("mon_osd_grace_doublings_max",)),
    Option("mon_osd_grace_doublings_max", OPT_FLOAT, 5.0, LEVEL_ADVANCED,
           "cap on markdown-log grace doublings (effective grace <= "
           "grace * 2^cap)", min=0.0),
    Option("osd_scrub_stagger_period", OPT_FLOAT, 0.0, LEVEL_ADVANCED,
           "deep-scrub stagger period (seconds): each PG scrubs in a "
           "hashed phase window inside the period so pool-wide scrub "
           "bandwidth is flat instead of one burst; 0 scrubs the "
           "whole pool every pass", min=0.0),
    Option("osd_max_backfills", OPT_INT, 1, LEVEL_ADVANCED,
           "backfill pattern groups admitted per repair group in the "
           "supervised scheduler (the reference's backfill reservation "
           "analog); repair and backfill share one token bucket", min=1),
    Option("sparse_dirty_compaction", OPT_STR, "auto", LEVEL_ADVANCED,
           "route peering, PG classification and pg_hist refolds "
           "through the compacted dirty-set path (gather dirty lanes, "
           "compute on a power-of-two bucket, scatter back) instead of "
           "dense full-width launches: 'auto' enables it when the "
           "geometry is large enough for the ladder to have at least "
           "one rung below the dense width; 'on' forces it everywhere "
           "(tests/benches); 'off' pins the dense reference path",
           enum_allowed=("auto", "on", "off"),
           see_also=("sparse_min_bucket", "sparse_ladder_rungs")),
    Option("sparse_min_bucket", OPT_INT, 32, LEVEL_ADVANCED,
           "smallest power-of-two bucket width in the dirty-set "
           "compaction ladder; dirty sets smaller than this still pay "
           "for min_bucket lanes.  The rung is picked on the host from "
           "one read of the dirty count, so each width is one more "
           "launch shape, never a recompile", min=1,
           see_also=("sparse_dirty_compaction",)),
    Option("sparse_ladder_rungs", OPT_INT, 4, LEVEL_ADVANCED,
           "maximum number of compacted bucket widths below the dense "
           "width (each 4x the last, starting at sparse_min_bucket); "
           "the dense full-width branch is always appended as the "
           "ladder's top rung and bit-equality reference", min=1,
           see_also=("sparse_dirty_compaction", "sparse_min_bucket")),
    Option("flight_recorder", OPT_STR, "auto", LEVEL_ADVANCED,
           "device-resident flight recorder: a fixed-shape ring of "
           "per-epoch telemetry lanes recorded inside the epoch loop "
           "and drained at snapshot boundaries: 'on' records "
           "everywhere, 'off' pins the recorder-free loop, 'auto' is "
           "off (the reference follows a bench-decided default file, "
           "which the port does not have)",
           enum_allowed=("auto", "on", "off"),
           see_also=("flight_ring_epochs",)),
    Option("flight_ring_epochs", OPT_INT, 1024, LEVEL_ADVANCED,
           "rows in the flight recorder's device ring (one telemetry "
           "row per epoch; power of two).  Once the ring wraps, older "
           "epochs overwrite: crash dumps carry the last ring_epochs "
           "epochs", min=2,
           see_also=("flight_recorder",)),
    Option("debug_bucket_checks", OPT_BOOL, False, LEVEL_ADVANCED,
           "assert power-of-two bucketing (assert_bucketed) on the "
           "padded seam sizes entering the device path — the write "
           "path's batch bucket: an unbucketed data-dependent count "
           "raises UnbucketedShapeError at the seam instead of giving "
           "every batch a shape of its own.  Host-side integer checks "
           "only — debug/CI only"),
    Option("debug_fsync_audit", OPT_BOOL, False, LEVEL_ADVANCED,
           "audit the durable-write commit chain (FsyncAudit) around "
           "checkpoint saves: every os.replace must see a prior file "
           "fsync and a later directory fsync or FsyncAuditError is "
           "raised (the runtime twin of the lint's J016).  Patches "
           "os.fsync/os.replace for the save scope — debug/CI only"),
    Option("debug_rank_checks", OPT_BOOL, False, LEVEL_ADVANCED,
           "raise RankDivergenceError when a divergent run's live ranks "
           "stay at the same step and epoch with different view "
           "fingerprints after the bounded retries, and check the "
           "operands of every mesh seam (sharded decode, scrub, PG-state "
           "classifier, reconcile merge) with assert_rank_identical "
           "before the collective.  Debug/CI only"),
    Option("reconcile_every_epochs", OPT_INT, 8, LEVEL_ADVANCED,
           "epochs each divergent rank advances its own device-resident "
           "view between reconciliation rounds; smaller values converge "
           "skewed observations faster at the cost of more merges per "
           "simulated second", min=1,
           see_also=("reconcile_deadline_epochs", "debug_rank_checks")),
    Option("reconcile_deadline_epochs", OPT_INT, 3, LEVEL_ADVANCED,
           "consecutive reconciliation rounds a rank's contributed "
           "epoch may sit still before the rank is marked laggy and "
           "the survivors proceed on its last-merged view; once laggy, "
           "recovery_retry_max further stalled rounds (with seeded "
           "exponential backoff per recovery_backoff_base_ms) raise "
           "RankStalledError on every rank instead of a hang", min=1,
           see_also=("reconcile_every_epochs", "recovery_retry_max",
                     "recovery_backoff_base_ms")),
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
