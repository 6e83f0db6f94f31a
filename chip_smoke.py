"""Drive ceph_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. build: compile the CUDA kernels from ``ceph_tpu_torch/csrc/`` with
   nvcc (sm_90a, one nvcc per source, all at once) and print the build
   seconds, the card, every kernel's registers and spills, and each
   straw2 kernel's instructions per draw in the SASS, split by pipe
   (ALU, FMA, memory, other);
2. kernels: hold K1 (negdraw), K2 (level_choose) and K3 (descend_fused)
   against their plain PyTorch versions on the card, bit for bit, at the
   slice's shapes (1M lanes, build_simple(1024) tables), time both, and
   give each its pipe floor; then K1 and K3 on their edges (fanout 1, 5,
   33, zero weights mid-row, weights 1 and 0xFFFFFFFF, rows off a
   16-byte boundary, 4099 rows, K3's global-memory tables and
   ``empty_is_hard`` both ways), bit for bit;
3. ec_kernels: the same for K4 (matrix_encode: k=8 m=3 and k=4 m=2 over
   32 MiB chunks), K5 (bitmatrix_encode: cauchy_good k=8 m=3 w=8,
   packetsize 2048, over the same, and that code's 64-row decoder with
   data chunks 0 and 1 lost) and K7 (byte_lut: one CLAY repair
   transform, 32 MiB, and the CLAY encode's, 64 MiB; beside the
   ``torch.take`` call), plus each kernel's edge shapes (ragged
   lengths, K4 at (4, 2, 4100), (5, 1, 131), its global-memory tables
   (k=128 m=8), empty data and data 1 byte past a 16-byte boundary, K5
   at w = 6, 7 and 32, its 64- and 128-row decoders, 256 input rows,
   packets of 3, 8 and 48 bytes, data 1 and 4 bytes past a 16-byte
   boundary, K7 at 16 n + 3 bytes, 7 bytes and unaligned), bit for bit;
   K4-K7 carry ptxas's registers and spills;
4. crush: ``make_batch_runner`` on build_simple(1024)'s replicated rule
   (3 replicas), 1M objects, in each mode; bit-equal across them and to
   the C++ reference tier on a 50k sample; placements/s for each (timed
   in turns, median of 6 calls each), and a torch.profiler
   breakdown of one call each; two rules whose choose step has an
   effective numrep <= 0 place nothing, equal to the C++ tier, in
   ``descend`` mode (run before the path's launch counts start);
5. osdmap: ``OSDMapMapping.update`` on build_osdmap(1024, pg_num=32768)
   with upmap items, a full pg_upmap, pg_temp, primary affinity and one
   OSD down; a sample of PGs must equal the scalar pipeline;
5a. general: the general engine (``crush/interp.py``) on 1M objects of
   (a) a uniform 1024-OSD hierarchy (32 racks, 8 hosts, 4 OSDs) under
   its replicated rule and (b) the same shape with straw2 root and racks
   over uniform hosts, 32 OSDs out, under a replicated and an EC rule
   (6 slots): the router's tier, host syncs and K1 launches per call
   (K1 > 0 on (b)), placements/s with the compacted-straggler rounds it
   runs at this size and with masked ones (:func:`masked_rounds`; in
   turns, median of 2 each; equal results), a profile of one compacted
   call of (b)'s EC rule, 65,536 placements each way equal to the C++
   tier;
5b. rebalance: BASELINE config 5, ``parallel/placement.py::
   sharded_rebalance_sim`` on build_simple(10000, 8 OSDs a host, 16
   hosts a rack) with 100 OSDs out: 12 launches of 8 chunks of 2^20
   objects (100,663,296): placements/s, moved fraction beside the
   ideal 3.0%, K3 launches, host syncs and peak memory; 16,384 objects
   at the start of the first and of the last launch placed and counted
   as the C++ tier does;
6. ec_encode: jerasure reed_sol_van k=8 m=3 (BASELINE's headline) and
   k=4 m=2 (BASELINE config 2) with a 4 KiB stripe unit, and
   cauchy_good k=8 m=3 packetsize 2048 (K5; a 64 KiB stripe unit, its
   alignment), on a batch of 64 objects of 4 MiB (256 MiB of data per
   call): data GB/s device-resident (``encode_async``) and through
   ``stripe.encode_object`` for one 4 MiB object (host copies
   included); parity equal to the C++ tier on 4 MiB of columns
   (``cppref.bitmatrix_encode`` for the packet layout);
7. ec_decode: the three codes with m chunks erased (data chunks first),
   decoded through ``ec.decode`` and device-resident; bit-equal to the
   data; GB/s;
8. ec_plugins: the 15 profiles of ``nonregression.ec_cases`` built on
   the card reproduce every ``"ec"`` digest of
   ``tests/golden/archive.json``; a CLAY k=4 m=2 (d=5) repair of one
   chunk of a 64 MiB object, bit-equal to the lost chunk; an LRC
   k=4 m=2 l=3 decode of one lost chunk;
9. schedule_kernel: K6 (schedule_apply) against its plain version at
   the main shape (the repair schedule of cauchy_good k=8 m=3 w=8
   p=2048 with chunks {0, 8} lost, over [8, 32 MiB]), timed beside K5
   on the same repair, and on its edges (a w = 32 schedule on the
   global-memory path, NW = 1,000,003 and 100, words 4 bytes past a
   16-byte boundary, packet sizes 3 and 5, the bit-plane layout at S =
   131, S = 0), bit for bit, with the program's op, level, group and
   work-slot counts and its launch shape;
9a. scrub_kernel: K8 (crc32c_rows, ``csrc/scrub.cu``) against its plain
   version at a scrub pass of the supervised store (8192 x 11 rows of 32
   KiB: a warp a row) and at one decode-verify group (32 rows of 32 KiB:
   a block a row), each timed with its bound and its cut (lanes a row,
   segment bytes), with ptxas's registers, spills and shared memory and
   the fold loop's instructions a byte by pipe (``testing/sass.py``), and
   on its edges (SCRUB_EDGES: L = 0, below 16, one below, at and above
   each timed shape's segment and twice it, rows 1-15 bytes past a
   16-byte boundary across segments, one row of 64 MiB, more rows than
   one grid covers, the check value 0xE3069283), bit for bit; edge rows
   over 8 KiB are held against the plain version on their 4 KiB pieces
   combined on the host;
9b. online_kernel: K9 (stripe_absorb, ``csrc/online.cu``, the stripe
   buffer's write loop, in place, compact Δdata) and its commit
   (stripe_commit) against their plain versions at BASELINE config 10's
   full width (1024 sets x 4 ways of 4,096-byte chunks, cauchy-good k=5
   m=1 w=8, a warm buffer, a batch of 256 writes), each side on its own
   clone of the buffer, timed (a fresh clone before each call, outside
   its window) with its bound (bytes or hash operations) and K9's
   longest per-set chain, with ptxas's registers and spills, and on its
   edges (``testing/online_edges.py``: an eviction chain in one set, all
   full, all misses on a cold buffer, invalid lanes between valid ones, a
   key evicted and hit again, batches of 1 and 512, two cancelling
   writes to a resident slot), bit for bit; phase 2's K6 launch timed at
   the old full-width shape and at the compact one, each beside its
   bound;
10. recovery: ``recover_pool`` for ``rack:0:down_out`` on
   build_osdmap(1024, pg_num=8192, size=11, erasure) with 32 KiB
   chunks, for jerasure reed_sol_van k=8 m=3 under ``auto`` (K4) and
   ``recovery_xor_schedule=on`` (K6, bit-plane) and cauchy_good k=8
   m=3 p=2048 under ``auto`` (K6, packet): every rebuilt shard equals
   the stored one, one launch per pattern, the peering equals a numpy
   classification; timed (median of RECOVERY_REPS calls), the first
   code profiled;
10a. supervised: ``SupervisedRecovery`` on the same map and RS k=8 m=3
   with every shard of the pool stored (32 KiB each): mid-repair-loss,
   scrub-storm (a ``Scrubber`` riding the loop, ``write_shard`` writing
   repairs back) and flapping-osd (0.5 s heartbeat grace), each with an
   EventJournal, a HealthTimeline graded by an SLO and an OpTracker on
   the virtual clock, each counted from 0 (launches, host syncs by
   torch's sync-debug warnings, wall seconds) and gated (converged,
   every rebuilt shard equal to the store, the unrecoverable PGs exactly
   those left below k, every corruption found and a clean closing scrub,
   a detection); the [rows, L] of every K8 launch of the three passes
   (min, median, max, count by shape);
   then config 6's traffic pass (``traffic``: mid-repair-loss with a
   ``TrafficEngine`` of 65,536 ops a step riding every health sample,
   then a 40x overload over 10 one-second steps on the converged map)
   and its scrub pass (``scrub_qos``: scrub-storm with a ``Scrubber``, an
   engine of 16,384 ops a step and its integrity loop), each run without
   and with config 6's mclock arbiter (the scrub pass's with three
   classes), each pass counted from 0 and gated (both runs converged,
   rebuilt bytes and the same unrecoverable PGs in both, rebuilt shards
   equal to the store, every
   sample's ops accounted for; the arbiter's lower recovery-phase p99,
   client grants of 64 bytes an op, recovery grants covering the bytes
   rebuilt, OK -> WARN -> OK across the overload; the scrub gates, the
   client p99 under scrub load within its SLO, the integrity loop's
   checksummed writes and verified degraded reads), and one ``observe``
   measured alone (kernel launches, host syncs, CUDA-event ms);
   scrub-storm, flapping-osd and the traffic pass at 128 PGs on the card
   and the CPU with equal ``summary()`` (the traffic pass: equal samples
   and histograms, ``mean_ms`` within ``TRAFFIC_REPLAY_RTOL``);
10b. epoch: the epoch loop (``recovery/superstep.py::EpochDriver``) at
   BASELINE config 7 (build_osdmap(1024, pg_num=8192, size=6, erasure),
   two slow OSDs, 64 ops a step): 512 superstep epochs in chunks of 256
   and 128 staged epochs, epochs/s and host syncs an epoch each (at most
   one on a quiet superstep epoch, the chunk copies apart); a
   rack-cascade walk on the same map with compaction auto and off, each
   through both paths (the four series bit-equal, K3 launched, the rungs
   taken); the staged series over one chunk equal to the superstep's;
   launches an epoch by piece (tape, liveness, peering, traffic, scrub,
   row) from torch.profiler spans over 8 config-7 epochs and the walk's
   epochs through its first dirty one, host ms an epoch by piece and the
   two paths' rates in turns over 64 config-7 epochs each; the walk at 64 OSDs and
   128 PGs equal on the card and the CPU, every lane;
10c. fleet: scenario fleets (``recovery/fleet.py::FleetDriver``) at
   BASELINE config 8 as bench/config8_fleet.py sets it (256 ssd-burst
   lanes over 256 epochs, build_osdmap(32, pg_num=16, size=6, erasure),
   32 ops a step), a run one replay of the compiled fleet's CUDA graph
   (``FleetProgram``: its capture ms, nodes and memory; the dirty lanes
   peered through a memo of pool keys on the card; a run of each size
   and a replayed fleet of 255 with no wrapper call, host read, sync
   warning or build): a run timed with ``pull=False``
   (cluster-epochs/s, K3 launches by the bodies' pass counters, the
   memo's peerings), and 32 lanes over 32 epochs at config 7's width
   (1024 OSDs, 8192 PGs); each against the host-decided loop (every
   lane, the final state and the memo's counts equal; the rates in
   turns); lanes 0 and 1 of each
   equal to new ``EpochDriver``s (and config 8's to ``run_sequential``
   through the tape program and to its host-decided loop: the
   sequential rates), a fleet of 255 equal to the first 255 lanes, the
   per-lane ring of 64 lanes equal to the host-decided loop's, Monte
   Carlo durability (``recovery/durability.py``) for ssd-burst and the
   panel's ssd-steady and ssd-skew fleets, launches an epoch by piece of
   the host-decided loop (torch.profiler spans over the first 3 epochs,
   before the first map events), and 4 lanes
   over 16 epochs on the card and the CPU with the recorder on, every
   lane and the ring equal; then one line of the reference's config-8
   record (``cli/status.py fleet`` renders it);
10d. divergent: config 6's ``--divergent`` pass
   (``recovery/reconcile.py::DivergentDriver``) on the recovery phase's
   map: two rank views of flap, rank 1 seeing every event 2.5 s late,
   48 epochs, each rank's chunk one load and one replay of the
   template's tape program (``TapeProgram``'s CUDA graph), gated
   (converged, a detection-to-convergence latency, the views'
   fingerprints equal to the unskewed reference's, every round and view
   equal to the host-decided run's; the two in turns: rounds/s); the
   same at 64 OSDs and 128 PGs on the card and the CPU, every round and
   every lane equal; then one line of the reference's divergent record
   (``cli/status.py ranks`` renders it);
10e. checkpoint: BASELINE config 9 (``recovery/checkpoint.py``) as
   bench/config9_checkpoint.py runs it, at config 7's width (flap, 256
   ops, 256 epochs): the run without checkpoints, the checkpointed run
   with a snapshot every 16 epochs (the path's launch counts; every
   snapshot's lane CRCs through K8): durable write bytes/s and bytes a
   snapshot, the overhead at 16 and 64, a kill mid-write at the midpoint
   and the restore's load and replay seconds, one snapshot's lane CRCs
   on the card (K8 launches, ms) beside the host crc32c's rate on the
   same lanes; gated (checkpointed and resumed series bit-equal, a
   corrupted newest snapshot falling back with a ``checkpoint.torn``
   event, a SIGKILL'd ``_crashbox`` child on the card, a fleet at config
   8's settings and the divergent pass at 64 OSDs killed and restored
   bit-equal, a snapshot the card wrote restored on the CPU and the rest
   of the run there equal to the card's); then one line of the
   reference's config-9 record (``cli/status.py checkpoint``);
10f. writepath: BASELINE config 10 (``workload/writepath.py::
   WritepathDriver``: K9, K6 and K9's commit each epoch) at full width
   (config 7's map, 256 ops, 128 epochs of flap, ssd-steady, ssd-burst
   and ssd-skew, a 1024 x 4 buffer of 4,096-byte chunks), a chunk one
   replay of the compiled write path's CUDA graph (captured on each
   driver's first run): encoded bytes/s, hit rate, delta and full
   bytes, epochs/s a mix, the graph's capture ms, nodes, conditional
   nodes, bodies and reserved memory, a replay's calls, reads, sync
   warnings and builds, the graph, the eager body, the host-decided
   loop and the staged path in turns, the card's busy share through the
   graph and the host-decided loop, launches an epoch by piece of the
   host-decided loop (epoch body, write batch, the stripe step and
   within it K9, K6, the commit), K9's, K6's and the commit's ms and the
   whole stripe step's card ms on the last batch (a fresh clone of the
   buffer before each call, outside its window); gated
   (``writepath_bitequal`` on the card for the five codec families of
   bench/config10_online_ec.py, graph = eager body = host-decided =
   staged on both series and the buffer, K9, K6 and the commit in every
   replay, one capture a driver and none for a second cap, a replay with
   no call, read or warning, a host read in the write stage failing the
   capture, the epoch lanes unchanged by the write stage, a wrong delta
   caught by ``scrub_stripe_buffer``, ``flight_recorder=on``
   bit-invisible through the graph's flight twin with its ring equal to
   the host-decided loop's, the ring's stripe lanes equal to the write
   rows and its dump and trace export valid, the bench's own settings
   equal on the card and the CPU); then one line of the reference's
   config-10 record (``cli/status.py writepath``);
11. balancer: BASELINE config 3 — five bulk remaps of
   build_osdmap(1024, pg_num=10240), one reweight toggled before each
   (PG mappings/s); the upmap balancer (max_deviation 1.0, 2000
   entries a plan) on build_skewed_osdmap(1024, pg_num=10240) until a
   plan is empty, per plan its entries, seconds, rounds, launches, the
   device scorer's ms by CUDA events and the remaps' seconds; the
   final table's SHA-256 equal to the reference's
   (``testing/golden.py``), converged, the first plan equal to each
   scorer's (device and numpy, both timed), a profiled first
   ``optimize()``; one crush-compat
   tick, not worse; each map's mapping against the scalar pipeline on
   256 PGs;
12. cli: crushtool ``--test --show-statistics --show-mappings`` over
   65536 x on build_simple(1024) on the card, equal to ``--cpu``;
   osdmaptool ``--createsimple 1024 --pg-num 10240``,
   ``--test-map-pgs`` and ``--upmap`` (2000 entries), whose command
   file must hold ``calc_pg_upmaps``'s plan for the saved map (the
   file's text is held to the reference's in ``tests/test_torch_cli.py``);
   ec_bench for reed_sol_van and cauchy_good (packetsize 2048) k=8 m=3,
   and one object of its size encoded on the card equal to the CPU's;
13. multidevice: a real NCCL process group of one rank (``file://``
   store), its mesh, and every mesh path through it, each bit-equal to
   the single-device path on the card: placement of 1M objects on
   build_simple(1024) (K3) and 65,536 on a general-engine map (K1), the
   rebalance sim, the sharded decode of k=8 m=3 at an odd and an aligned
   width (K4's unaligned and TMA variants, each held to the plain
   version), the mesh executor on config 4's rack failure (K3's
   peering, K4 sharded, K6 bit-level), a mesh scrub (K8), the traffic
   step and the PG-state classifier, the rank guard; then the
   work-stealing dispatcher on 4 virtual chips on the card under
   tests/test_dispatch.py's fault matrix: bytes equal the static
   decode, decisions equal the CPU's.  The group is destroyed after.
14. tooling: the runtime guard and the non-regression archive
   (``analysis/runtime_guard.py``, ``testing/nonregression.py``): no
   library built by a second ``_cuda.build_all()`` (``CompileCounter``),
   the archive's CRUSH and EC digests from ``generate("cuda")`` equal to
   ``tests/golden/archive.json``, every ``launch_budget_cases("cuda")``
   scenario inside its budget (calls, launches, seam reads and
   sync-debug warnings of each second run; every call outside a capture
   a launch), one
   checkpoint save under ``debug_fsync_audit`` (audited, and it loads
   back) and one ``WritepathDriver`` under ``debug_bucket_checks``;
   ``fused_placement``'s second run is one graph replay with no wrapper
   call and no seam read, whose launches are counted, and
   ``epoch_superstep``'s, ``compacted_superstep``'s,
   ``online_write_batch``'s, ``fleet_superstep``'s and
   ``reconcile_round``'s replays make no call, seam read or sync
   warning;
15. pipeline: the fused placement->peering program
   (``recovery/pipeline.py``) as one CUDA graph: the card's torch,
   CUDA runtime and driver; five chaos epochs on config 4's map and a
   CRUSH reweight (the same key, other tables) through one private
   program cache (one miss, five hits, one capture, the graph's nodes,
   conditional nodes, captured, sure and replayed launches, capture ms
   and the device memory the capture reserved), each epoch equal to a
   staged pass on its map; ``PeeringEngine.run`` (the graph) equal to
   ``run_staged`` on every output, bit for bit, on config 4's map and
   failure and on :func:`mixed_hierarchy`'s map (the general tier, K1),
   a host-tier map with no program; one call of each path under the
   runtime guard (wrapper calls, launches, seam reads, sync-debug
   warnings: no call and no read in the replay, and its launches
   counted, those in its WHILE bodies too); both paths timed in turns (wall ms and CUDA-event
   ms, median of PIPELINE_TURNS each after a warm-up); config 7's
   dense ``EpochDriver._peer_hist`` on a dirty state, eager against
   the graph, equal and timed in turns.

Then the launch counts of each main path (phases 4-5: placement; 5a:
general; 5b: rebalance; 6-8: EC; 10: recovery; 10a: supervised,
traffic and scrub_qos; 10b: epoch; 10c: fleet; 10d: divergent; 10e:
checkpoint; 10f: writepath; 11: balancer; 12: cli; 13: multidevice;
15: pipeline; 14: tooling, each from 0; a kernel's launches are those
that ran: its wrapper's outside a capture and those graph replays ran,
each WHILE body's launches as often as its pass counter says),
each phase's wall seconds, the kernels
line (each kernel's
launches summed over the paths; every kernel must launch on its paths,
K1 on the general path, K3 on the rebalance path, K6 on the recovery
path, K3, K4 and K8 on the supervised and scrub_qos paths, K3 and K4
on the traffic path, K3 on the epoch, fleet, divergent and balancer
paths, K3 and K8 on the checkpoint path, K3, K6, K9 and its commit on
the writepath path, K1, K3, K4, K6 and K8 on the multidevice path, K3
and K1 on the pipeline path, K3-K9 and K9's commit on the tooling path),
the card's name and power limit, and
the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no CUDA device is present.

    python3 chip_smoke.py --mesh-world N

runs the mesh paths in an N-rank NCCL world, one card a rank (a box of
N cards): every rank's placement, rebalance sim, sharded decode,
executor (sharded and work-stealing), supervised loop, traffic step,
PG states and scrub against a world of one on the same inputs, the rank
guard and the dispatcher's typed loss on every rank, and
``RankReconciler`` against the in-process ``DivergentDriver``; one JSON
line of gates and walls.

    python3 chip_smoke.py --stripe-probe [ROOT]

measures config 10's stripe step alone (``stripe_probe``) with the
package of the checkout at ROOT (this one by default) and prints one
JSON line: the same code for any checkout, so that two are compared on
one card by running it for each in turns (A B B A).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
REPLICAS = 3
OBJECTS = 1 << 20

# Instructions of one straw2 draw as nvcc compiled the port's first
# csrc/straw2.cu for sm_90a, counted in its K1's SASS: the hash's 5 mixes
# at 3 instructions a line, then crush_ln, the 64x64 high multiply and
# its corrections.  K1-K3's bound_ms divides it by the issue rate and
# stays the kernels' fixed yardstick; the build phase splits each
# kernel's draw as compiled now by pipe (ceph_tpu_torch/testing/sass.py),
# and the kernels phase gives each its pipe floor from that split.
OPS_PER_DRAW = 197
ISSUE_LANES_PER_SM = 128  # 4 schedulers x one 32-lane warp instruction a clock
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)

MIB = 1 << 20
EC_OBJECTS = 64                # objects per encode call
EC_OBJECT_BYTES = 4 * MIB      # RBD/RGW default object size
EC_STRIPE_UNIT = 4096          # Ceph's default EC stripe unit (chunk per stripe)
# name -> (profile, stripe unit); cauchy_good (K5) aligns a stripe to
# k*w*packetsize*4 bytes, so its chunk per stripe is 64 KiB
EC_CODES = {
    "rs_8_3": ({"plugin": "jerasure", "technique": "reed_sol_van", "k": "8", "m": "3"},
               EC_STRIPE_UNIT),
    "rs_4_2": ({"plugin": "jerasure", "technique": "reed_sol_van", "k": "4", "m": "2"},
               EC_STRIPE_UNIT),
    "cauchy_8_3": ({"plugin": "jerasure", "technique": "cauchy_good", "k": "8", "m": "3",
                    "packetsize": "2048"}, 64 * 1024),
}
# nonregression.ec_cases' profiles and object, restated (tests/golden/archive.json "ec")
GOLDEN_EC = {
    "jerasure_rs_4_2": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4", "m": "2"},
    "jerasure_rs_8_3": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "8", "m": "3"},
    "jerasure_r6_4_2": {"plugin": "jerasure", "technique": "reed_sol_r6_op", "k": "4", "m": "2"},
    "jerasure_cauchy_4_2_p8": {"plugin": "jerasure", "technique": "cauchy_good", "k": "4",
                               "m": "2", "packetsize": "8"},
    "lrc_4_2_3": {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
    "shec_4_3_2": {"plugin": "shec", "k": "4", "m": "3", "c": "2"},
    "clay_4_2": {"plugin": "clay", "k": "4", "m": "2"},
    "clay_4_3_d5": {"plugin": "clay", "k": "4", "m": "3", "d": "5"},
    "clay_4_3_d4": {"plugin": "clay", "k": "4", "m": "3", "d": "4"},
    "jerasure_liberation_4_2_w7": {"plugin": "jerasure", "technique": "liberation", "k": "4",
                                   "m": "2", "w": "7", "packetsize": "8"},
    "jerasure_blaum_roth_4_2_w6": {"plugin": "jerasure", "technique": "blaum_roth", "k": "4",
                                   "m": "2", "w": "6", "packetsize": "8"},
    "jerasure_liber8tion_4_2": {"plugin": "jerasure", "technique": "liber8tion", "k": "4",
                                "m": "2", "packetsize": "8"},
    "jerasure_rs_4_2_w16": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4",
                            "m": "2", "w": "16"},
    "jerasure_rs_4_2_w32": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4",
                            "m": "2", "w": "32"},
    "jerasure_cauchy_4_2_w16_p8": {"plugin": "jerasure", "technique": "cauchy_good", "k": "4",
                                   "m": "2", "w": "16", "packetsize": "8"},
}


# phase recovery: a 1024-OSD EC pool and one rack (8 hosts, 32 OSDs) lost
RECOVERY_OSDS = 1024
RECOVERY_PGS = 8192            # Ceph's PG calculator: ~100 PGs per OSD at size 11
RECOVERY_FAILURE = "rack:0:down_out"
RECOVERY_CHUNK = 32 * 1024     # a PG's share cut to one 256 KiB object (k=8)
#: the code whose recover_pool is profiled (one call)
RECOVERY_PROFILED = "rs_8_3_auto"
RECOVERY_REPS = 2               # timed calls a code (the median)
RECOVERY_CODES = {
    "rs_8_3_auto": ({"plugin": "jerasure", "technique": "reed_sol_van", "k": "8", "m": "3"},
                    "auto"),
    "rs_8_3_on": ({"plugin": "jerasure", "technique": "reed_sol_van", "k": "8", "m": "3"}, "on"),
    "cauchy_good_8_3_auto": ({"plugin": "jerasure", "technique": "cauchy_good", "k": "8",
                              "m": "3", "packetsize": "2048"}, "auto"),
}

# phase balancer: BASELINE config 3, the mgr balancer's upmap optimizer on
# a 10k-PG pool of a 1024-OSD map, to convergence
BALANCER_OSDS = 1024
BALANCER_PGS = 10240
BALANCER_MAX_DEVIATION = 1.0
BALANCER_MAX_OPTIMIZATIONS = 2000
BALANCER_REMAPS = 5            # bulk remaps, each after one reweight toggle
SCALAR_SAMPLE = 256            # PGs held against the scalar pipeline


#: wall seconds from the end of the previous phase's line to the end of each
#: phase's own (build: from the start of main)
PHASE_WALLS: dict = {}
T_START = time.perf_counter()
_LAST_EMIT = [T_START]


def emit(obj) -> None:
    if "phase" in obj:
        now = time.perf_counter()
        PHASE_WALLS[obj["phase"]] = now - _LAST_EMIT[0]
        _LAST_EMIT[0] = now
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def int32_ops_per_s() -> float:
    """The card's peak rate for 32-bit integer operations: SMs x 128
    lanes x max SM clock, the instruction issue limit.  It is the
    67 TFLOP/s float32 rate of the H100 data sheet with one FMA counted
    as one operation; integer adds, logic and multiply-adds issue no
    faster (half of them, on Hopper, only through the float pipes)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return sms * ISSUE_LANES_PER_SM * mhz * 1e6


def bound_ms(nbytes: float, ops: float, int_rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_name(mangled: str) -> str:
    """``gf_matrix_kernel<1>`` from ``_ZN<len><namespace><len>gf_matrix_kernelILb1EE...``:
    the last nested name, with its integer and bool template arguments."""
    pos, name = 3, mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:]).group(0)
        name = mangled[pos + len(n):pos + len(n) + int(n)]
        pos += len(n) + int(n)
    args = re.match(r"I((?:L[bi]\d+E)+)E", mangled[pos:])
    if args:
        name += "<" + ",".join(re.findall(r"L[bi](\d+)E", args.group(1))) + ">"
    return name


def ptxas_report(lib: str) -> dict:
    """Registers and spill bytes of every kernel in ``lib``, from the
    ptxas report the build kept."""
    from ceph_tpu_torch import _cuda

    out, name = {}, None
    with open(_cuda.ptxas_path(lib)) as f:
        for ln in f:
            if "Compiling entry function" in ln:
                name = kernel_name(ln.split("'")[1])
            elif name and "spill stores" in ln:
                st, ld = re.findall(r"(\d+) bytes spill", ln)
                out.setdefault(name, {}).update(spill_stores=int(st), spill_loads=int(ld))
            elif name and "Used" in ln and "registers" in ln:
                out.setdefault(name, {})["registers"] = int(
                    re.search(r"Used (\d+) registers", ln).group(1))
                smem = re.search(r"(\d+) bytes smem", ln)
                out[name]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def time_ms(fn, reps: int = 10, setup=None) -> float:
    """Median milliseconds of ``fn`` on the card, by CUDA events.  With
    ``setup`` each call is ``fn(setup())``, its inputs made and the card
    synchronised before the first event, outside the timed window (for a
    function that updates its inputs in place)."""
    def call():
        return fn() if setup is None else fn(setup())

    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup is not None:
            x = setup()
            torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn() if setup is None else fn(x)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, int]:
    """(bit-equal, max abs error) of two integer tensors."""
    equal = got.dtype == want.dtype and got.shape == want.shape and bool(torch.equal(got, want))
    if got.shape != want.shape or got.numel() == 0:
        return equal, 0 if equal else -1
    return equal, int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def kernel_record(name: str, replaces: str, kernel, plain, nbytes: int, ops: int,
                  int_rate: float, library=None, plain_reps: int = 3, fresh=None) -> dict:
    """Run ``kernel`` and ``plain`` on the same card inputs, compare them
    bit for bit, time both (and ``library``, one PyTorch call of the
    same function, where there is one), and bound the kernel by bytes
    and operations.  A slow plain version (``plain_reps=0``) is timed
    over the one call of the comparison, by CUDA events.  With ``fresh``
    (a function making new inputs) ``kernel`` and ``plain`` take them as
    their argument, each call its own, made outside any timed window
    (for functions that update their inputs in place)."""
    def run(fn):
        return fn() if fresh is None else fn(fresh())

    got = run(kernel)
    if plain_reps:
        want = run(plain)
    else:
        x = None if fresh is None else fresh()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        want = plain() if fresh is None else plain(x)
        b.record()
        b.synchronize()
        one_call_ms = a.elapsed_time(b)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    checks = [compare(a, b) for a, b in zip(got, want)]
    bms, by = bound_ms(nbytes, ops, int_rate)
    return {"name": name, "replaces": replaces, "bit_equal": all(c[0] for c in checks),
            "max_abs_err": max(c[1] for c in checks), "ms": time_ms(kernel, setup=fresh),
            "plain_ms": time_ms(plain, plain_reps, fresh) if plain_reps else one_call_ms,
            "bound_ms": bms, "bound_by": by,
            "bytes": nbytes, "ops": ops,
            "library_ms": time_ms(library) if library is not None else None}


def pipe_floor_ms(draws: int, split: dict, int_rate: float) -> float:
    """The floor of a draw-bound kernel's integer pipes: its draws times
    the larger of its ALU and FMA instructions per draw (its SASS split)
    over SMs x 64 lanes x max SM clock (each pipe's rate on sm_90, half
    ``int_rate``)."""
    return draws * max(split["alu"], split["fma"]) / (int_rate / 2) * 1e3


def phase_kernels(n: int, int_rate: float, dev, splits: dict) -> dict:
    """K1-K3 vs their plain versions at the main path's shapes: n lanes
    on build_simple(1024)'s descent tables (root 1x32, racks 32x8,
    hosts 256x4), each with its pipe floor from ``splits`` (the build's
    per-draw SASS split); then K1 and K3 on their edges
    (``testing/straw2_edges.py``), compared only."""
    from ceph_tpu_torch.core import straw2
    from ceph_tpu_torch.crush import interp_batch
    from ceph_tpu_torch.models.clusters import build_simple
    from ceph_tpu_torch.testing import straw2_edges

    dense = build_simple(1024).to_dense()
    stop = interp_batch._stop_buckets(dense, [0], 3)
    pack, _ = interp_batch.build_pack(dense, [0], 3, {b: i for i, b in enumerate(stop)}, dev)
    leaf, _ = interp_batch.build_pack(dense, stop, 0, {}, dev)
    table_bytes = pack.ids.numel() * 20 + pack.size.numel() * 4

    g = torch.Generator(device="cpu").manual_seed(SEED)
    rnd = lambda lo, hi: torch.randint(lo, hi, (n,), generator=g, dtype=torch.int64)
    x = rnd(0, 1 << 32).to(torch.int32).to(dev)  # wraps to the u32 bit pattern
    r = rnd(0, 8).to(torch.int32).to(dev)
    lidx = torch.zeros(n, dtype=torch.int32, device=dev)  # every lane at the root
    active = torch.ones(n, dtype=torch.bool, device=dev)

    # K1 at the draw mode's widest level: the root row for every lane, [n, 32]
    rows = [t.index_select(0, lidx.to(torch.int64)) for t in pack.level(0)[:3]]
    k1 = kernel_record("negdraw", "ceph_tpu/core/pallas_straw2.py:273",
                       lambda: straw2.negdraw(x, r, *rows),
                       lambda: straw2.negdraw_plain(x, r, *rows),
                       n * 8 + rows[0].numel() * (4 + 4 + 8 + 8),
                       int((rows[1] != 0).sum()) * OPS_PER_DRAW, int_rate)
    k1["pipe_floor_ms"] = pipe_floor_ms(rows[0].numel(), splits["straw2_negdraw_kernel"],
                                        int_rate)
    # K2 at the same level: row fetch, draws and argmin in one launch
    fanout = pack.meta[0][1]
    k2 = kernel_record("level_choose", "ceph_tpu/core/pallas_straw2.py:384",
                       lambda: straw2.level_choose(x, r, lidx, pack, 0),
                       lambda: straw2.level_choose_plain(x, r, lidx, pack, 0),
                       n * (3 * 4 + 4 * 4) + table_bytes, n * fanout * OPS_PER_DRAW, int_rate)
    k2["pipe_floor_ms"] = pipe_floor_ms(n * fanout, splits["straw2_level_kernel"], int_rate)
    # K3: the rule's descent root -> rack -> host for every lane
    draws = count_descend_draws(x, r, lidx, active, pack, 3, 1024)
    k3 = kernel_record("descend", "ceph_tpu/core/pallas_straw2.py:603",
                       lambda: straw2.descend_fused(x, r, lidx, active, pack, 3, False, 1024),
                       lambda: straw2.descend_plain(x, r, lidx, active, pack, 3, False, 1024),
                       n * (3 * 4 + 1 + 2 * 4 + 2) + table_bytes, draws * OPS_PER_DRAW,
                       int_rate)
    k3["pipe_floor_ms"] = pipe_floor_ms(draws, splits["straw2_descend_kernel"], int_rate)
    # and the leaf descent host -> osd from the hosts the lanes reached
    item, ok, hard, nl = straw2.descend_fused(x, r, lidx, active, pack, 3, False, 1024)
    k3["bit_equal"] = k3["bit_equal"] and all(
        bool(torch.equal(a, b)) for a, b in zip(
            straw2.descend_fused(x, r, nl, ok, leaf, 0, False, 1024),
            straw2.descend_plain(x, r, nl, ok, leaf, 0, False, 1024)))
    edges = []
    for label, args in straw2_edges.negdraw_edges(dev):
        equal, err = compare(straw2.negdraw(*args), straw2.negdraw_plain(*args))
        edges.append({"case": label, "bit_equal": equal, "max_abs_err": err})
    for label, args in straw2_edges.descend_edges(dev):
        checks = [compare(a, b) for a, b in zip(straw2.descend_fused(*args),
                                                straw2.descend_plain(*args))]
        edges.append({"case": label, "bit_equal": all(c[0] for c in checks),
                      "max_abs_err": max(c[1] for c in checks)})
    torch.cuda.synchronize()
    return {"results": [k1, k2, k3], "edges": edges}


def count_descend_draws(x, r, lidx0, active, tb, target_type, max_devices) -> int:
    """Draws the descent of these inputs needs: for each lane, the live
    slots of every row it visits before it is done (the level loop of
    straw2.descend_levels replayed on the plain version)."""
    from ceph_tpu_torch.core import straw2

    draws = 0
    done = ~active
    lidx = lidx0
    for lv in range(tb.n_levels):
        li = torch.where(done, torch.zeros_like(lidx), lidx)
        chosen, ctype, nlidx, size = straw2.level_choose_plain(x, r, li, tb, lv)
        draws += int(size.clamp(1, tb.meta[lv][1])[~done].sum())
        is_bucket = chosen < 0
        reached = (ctype == target_type) if target_type != 0 else ~is_bucket
        bad = ((~is_bucket & ~reached) | (~is_bucket & (chosen >= max_devices))
               | (is_bucket & (ctype == straw2.CTYPE_DANGLING)))
        # hard or soft, a lane stops on an empty row or a bad child
        new_done = done | (size == 0) | bad | reached
        lidx = torch.where(new_done, lidx, nlidx.to(lidx.dtype))
        done = new_done
    return draws


def card_bytes(shape, seed: int, dev) -> torch.Tensor:
    """Random u8 tensor made on the card from a seed."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)


def phase_ec_kernels(int_rate: float, dev) -> dict:
    """K4, K5 and K7 vs their plain versions at the main path's shapes,
    timed, and on their edge shapes, compared only."""
    from ceph_tpu_torch.ec import gf, gf_kernels, gfw, kernels

    S = EC_OBJECTS * EC_OBJECT_BYTES // 8  # one chunk stream of the k=8 batch
    results, edges = [], []
    for k, m in ((8, 3), (4, 2)):
        M = gf.vandermonde_matrix(k, m)
        tables, nibbles = gf_kernels.mul_tables(M, dev), gf_kernels.nibble_tables(M, dev)
        data = card_bytes((k, S), SEED + k, dev)
        rec = kernel_record(
            "matrix_encode", "ceph_tpu/ec/pallas_gf.py:162",
            lambda: gf_kernels.matrix_encode(tables, data, nibbles),
            lambda: gf_kernels.matrix_encode_plain(tables, data),
            (k + m) * S + m * k * 32, m * k * S + m * (k - 1) * S // 4, int_rate)
        rec["shape"] = f"k={k} m={m} S={S}"
        results.append(rec)
        del data
    bits = gf.matrix_to_bitmatrix(gf.cauchy_good_matrix(8, 3))
    bm = kernels.Bitmatrix(bits, 8, dev)
    data = card_bytes((8, S), SEED + 5, dev)
    rec = kernel_record(
        "bitmatrix_encode", "ceph_tpu/ec/pallas_kernels.py:94",
        lambda: kernels.bitmatrix_encode(bm, data, 2048),
        lambda: kernels.bitmatrix_encode_plain(bm, data, 2048),
        (8 + 3) * S + bm.prog.numel() * 4, int(bits.sum()) * (S // 8 // 4), int_rate)
    rec["shape"] = f"cauchy_good k=8 m=3 w=8 p=2048 S={S}"
    results.append(rec)
    # the decoder of the same code with data chunks 0 and 1 lost, as
    # MatrixCodec builds it: 64 rows, 48 of them copies
    gen = np.vstack([np.eye(8, dtype=np.uint8), gf.cauchy_good_matrix(8, 3)])
    dec_bits = gf.matrix_to_bitmatrix(gf.invert_matrix(gen[2:10]))
    dm = kernels.Bitmatrix(dec_bits, 8, dev)
    rec = kernel_record(
        "bitmatrix_encode", "ceph_tpu/ec/pallas_kernels.py:94",
        lambda: kernels.bitmatrix_encode(dm, data, 2048),
        lambda: kernels.bitmatrix_encode_plain(dm, data, 2048),
        (8 + 8) * S + dm.prog.numel() * 4, int(dec_bits.sum()) * (S // 8 // 4), int_rate)
    rec["shape"] = f"cauchy_good k=8 m=3 decoder, chunks (0, 1) lost, 64 rows, p=2048 S={S}"
    results.append(rec)
    del data
    table = torch.from_numpy(gf.mul_table()[gf.gf_inv(1 ^ gf.gf_mul(2, 2))].copy()).to(dev)
    for label, shape in (("CLAY k=4 m=2 repair transform", (4, 4, 2 * MIB)),
                         ("CLAY k=4 m=2 encode transform", (4, 8, 2 * MIB))):
        x = card_bytes(shape, SEED + 7, dev)
        n = x.numel()
        rec = kernel_record(
            "byte_lut", "ceph_tpu/ec/pallas_gf.py:94",
            lambda: gf_kernels.byte_lut(x, table),
            lambda: gf_kernels.byte_lut_plain(x, table), 2 * n + 256, n, int_rate,
            library=lambda: torch.take(table, x.long()))
        rec["shape"] = f"{label} {list(shape)} ({n} bytes)"
        results.append(rec)
        del x

    def edge(label, got, want):
        equal, err = compare(got, want)
        edges.append({"case": label, "bit_equal": equal, "max_abs_err": err})

    for k, m, size in ((8, 3, 1_000_003), (4, 2, 4100), (5, 1, 131), (128, 8, 1 << 20),
                       (3, 2, 0), (8, 3, -4099)):
        M = gf.vandermonde_matrix(k, m)
        tables, nibbles = gf_kernels.mul_tables(M, dev), gf_kernels.nibble_tables(M, dev)
        data = card_bytes((k, abs(size)), SEED + abs(size), dev)
        label = f"matrix_encode k={k} m={m} S={abs(size)}"
        if size < 0:  # data 1 byte past a 16-byte boundary
            data = card_bytes((k * -size + 1,), SEED, dev)[1:].view(k, -size)
            label += " unaligned data"
        path = "shared" if gf_kernels.tables_staged(m, k) else "global"
        edge(f"{label} tables={path}", gf_kernels.matrix_encode(tables, data, nibbles),
             gf_kernels.matrix_encode_plain(tables, data))
    rs32 = gfw.matrix_to_bitmatrix(gfw.vandermonde_matrix(4, 2, 32), 32)
    gen = np.vstack([np.eye(128, dtype=np.uint8), rs32])
    dec32 = gf.invert_bitmatrix(np.vstack([gen[r * 32:(r + 1) * 32] for r in (1, 3, 4, 5)]))
    cauchy = gf.matrix_to_bitmatrix(gf.cauchy_good_matrix(8, 3))
    w8 = gfw.matrix_to_bitmatrix(gfw.vandermonde_matrix(8, 3, 32), 32)
    # (label, bitmatrix, w, p, data offset past a 16-byte boundary)
    for label, bits, w, p, off in (
            ("liberation k=4 w=7 p=8", gfw.liberation_bitmatrix(4, 7), 7, 8, 0),
            ("liberation k=4 w=7 p=48 (tiles end mid-packet)", gfw.liberation_bitmatrix(4, 7),
             7, 48, 0),
            ("blaum_roth k=4 w=6 p=8", gfw.blaum_roth_bitmatrix(4, 6), 6, 8, 0),
            ("reed_sol_van k=4 m=2 w=32 p=4", rs32, 32, 4, 0),
            ("reed_sol_van k=8 m=3 w=32 p=16 (256 input rows: global)", w8, 32, 16, 0),
            ("w=32 decoder (128 rows) p=4", dec32, 32, 4, 0),
            ("w=32 decoder (128 rows) p=16 (staged)", dec32, 32, 16, 0),
            ("cauchy_good k=8 m=3 w=8 p=3", cauchy, 8, 3, 0),
            ("cauchy_good decoder (64 rows) p=3", dec_bits, 8, 3, 0),
            ("cauchy_good k=8 m=3 w=8 p=2048, data 1 byte past", cauchy, 8, 2048, 1),
            ("cauchy_good k=8 m=3 w=8 p=2048, data 4 bytes past", cauchy, 8, 2048, 4)):
        op = kernels.Bitmatrix(bits, w, dev)
        k, size = bits.shape[1] // w, w * p * 4099
        data = card_bytes((k * size + off,), SEED + w + p, dev)[off:].view(k, size)
        edge(f"bitmatrix_encode {label}", kernels.bitmatrix_encode(op, data, p),
             kernels.bitmatrix_encode_plain(op, data, p))
    for n, off in ((64 * MIB + 3, 0), (7, 0), (16 * 4099 + 3, 1), (16 * 4099 + 3, 4)):
        x = card_bytes((n + off,), SEED + 3, dev)[off:]
        edge(f"byte_lut n={n}" + (f", {off} bytes past a 16-byte boundary" if off else ""),
             gf_kernels.byte_lut(x, table), gf_kernels.byte_lut_plain(x, table))
    torch.cuda.synchronize()
    return {"phase": "ec_kernels", "results": results, "edges": edges}


def repair_bitmatrix(gen_bits: np.ndarray, w: int, k: int, size: int, missing) -> np.ndarray:
    """The planner's repair bitmatrix: the lost chunks' generator rows
    times the inverse of the first k survivors'."""
    from ceph_tpu_torch.ec import gf

    rows = [s for s in range(size) if s not in missing][:k]
    sub = np.vstack([gen_bits[r * w:(r + 1) * w] for r in rows])
    need = np.vstack([gen_bits[s * w:(s + 1) * w] for s in missing])
    return gf.bitmatrix_multiply(need, gf.invert_bitmatrix(sub))


def phase_schedule_kernel(int_rate: float, dev) -> dict:
    """K6 vs its plain version at the main path's shape, timed beside K5
    on the same repair, and on its edges, compared only."""
    from ceph_tpu_torch.ec import gf, gfw, kernels, schedule

    S = EC_OBJECTS * EC_OBJECT_BYTES // 8
    gen = np.vstack([np.eye(64, dtype=np.uint8),
                     gf.matrix_to_bitmatrix(gf.cauchy_good_matrix(8, 3))])
    repair = repair_bitmatrix(gen, 8, 8, 11, (0, 8))
    sched = schedule.compile_schedule(repair)
    table = kernels.StepTable(sched.steps, sched.n_bufs, dev, sched.n_in, sched.n_out)
    prog = table.program(sched.n_in, sched.n_out)
    data = card_bytes((8, S), SEED + 6, dev)
    words = schedule.pack_packet_rows_dev(data, 8, 2048)
    nw = words.shape[1]
    apply = lambda w_: kernels.schedule_apply(table, w_, sched.n_out)
    rec = kernel_record(
        "schedule_apply", "ceph_tpu/ec/pallas_kernels.py:178", lambda: apply(words),
        lambda: kernels.schedule_apply_plain(table, words, sched.n_out),
        (sched.n_in + sched.n_out) * nw * 4, sched.n_steps * nw, int_rate)
    # K5 on the same repair, from the [8, S] chunks: the same bytes out
    bm = kernels.Bitmatrix(repair, 8, dev)
    k5_out = kernels.bitmatrix_encode(bm, data, 2048)
    k6_bytes = schedule.unpack_packet_rows_dev(apply(words), 2, 8, 2048, S)
    rec.update(shape=f"cauchy_good k=8 m=3 w=8 p=2048 lost (0, 8) S={S} NW={nw}",
               n_steps=sched.n_steps, n_bufs=sched.n_bufs, n_in=sched.n_in, n_out=sched.n_out,
               xor_count=sched.xor_count, naive_xor_count=sched.naive_xor_count,
               **program_counts(prog),
               k5_same_repair_ms=time_ms(lambda: kernels.bitmatrix_encode(bm, data, 2048)),
               k5_equal=bool(torch.equal(k5_out, k6_bytes)))
    del data, words, k5_out, k6_bytes
    edges = []

    def edge(label, table_, sched_, w_, encoder=None, host_data=None):
        got = kernels.schedule_apply(table_, w_, sched_.n_out)
        want = kernels.schedule_apply_plain(table_, w_, sched_.n_out)
        equal, err = compare(got, want)
        e = {"case": label, "n_steps": sched_.n_steps, "n_bufs": sched_.n_bufs,
             **program_counts(table_.program(w_.shape[0], sched_.n_out)),
             "words": list(w_.shape), "bit_equal": equal, "max_abs_err": err}
        if encoder is not None:  # the encoder's bytes against the numpy host path
            pack = (schedule.pack_bitplanes(host_data) if encoder.layout == "bitplane"
                    else schedule.pack_packet_rows(host_data, 8, encoder.packetsize))
            out = sched_.execute_host(pack)
            size = host_data.shape[1]
            host = (schedule.unpack_bitplanes(out, encoder.n_chunks_out, size)
                    if encoder.layout == "bitplane" else
                    schedule.unpack_packet_rows(out, encoder.n_chunks_out, 8, encoder.packetsize,
                                                size))
            e["bytes_equal_host"] = bool(np.array_equal(encoder.encode(host_data), host))
            e["bit_equal"] = e["bit_equal"] and e["bytes_equal_host"]
        edges.append(e)

    rng = np.random.default_rng(SEED)
    w32 = gfw.matrix_to_bitmatrix(gfw.vandermonde_matrix(8, 3, 32), 32)
    gen32 = np.vstack([np.eye(256, dtype=np.uint8), w32])
    big = schedule.compile_schedule(repair_bitmatrix(gen32, 32, 8, 11, (0, 8)))
    big_words = torch.from_numpy(rng.integers(0, 2**32, (big.n_in, 40_003), dtype=np.uint32)
                                 .view(np.int32)).to(dev)
    edge("w=32 reed_sol_van k=8 m=3 lost (0, 8): global-memory path",
         kernels.StepTable(big.steps, big.n_bufs, dev), big, big_words)
    ragged = torch.from_numpy(rng.integers(0, 2**32, (sched.n_in, 1_000_003), dtype=np.uint32)
                              .view(np.int32)).to(dev)
    edge("main schedule, NW = 1,000,003", table, sched, ragged)
    edge("main schedule, NW = 100 (below one tile)", table, sched, ragged[:, :100].contiguous())
    sliced = torch.from_numpy(rng.integers(0, 2**32, sched.n_in * 4096 + 1, dtype=np.uint32)
                              .view(np.int32)).to(dev)[1:].view(sched.n_in, 4096)
    edge("main schedule, words 4 bytes past a 16-byte boundary", table, sched, sliced)
    for p in (3, 5):
        enc = schedule.XorScheduleEncoder(repair, "packet", 8, p, device=dev)
        host_data = rng.integers(0, 256, (8, 8 * p * 4099), dtype=np.uint8)
        edge(f"packet layout p={p}", enc.table, enc.schedule,
             schedule.pack_packet_rows_dev(torch.from_numpy(host_data).to(dev), 8, p),
             enc, host_data)
    rs = np.vstack([np.eye(8, dtype=np.uint8), gf.vandermonde_matrix(8, 3)])
    rows = [s for s in range(11) if s not in (0, 8)][:8]
    enc = schedule.XorScheduleEncoder(
        gf.matrix_to_bitmatrix(gf.matrix_encode(rs[[0, 8]], gf.invert_matrix(rs[rows]))),
        "bitplane", device=dev)
    host_data = rng.integers(0, 256, (8, 131), dtype=np.uint8)
    edge("bitplane layout S=131", enc.table, enc.schedule,
         schedule.pack_bitplanes_dev(torch.from_numpy(host_data).to(dev)), enc, host_data)
    before = kernels.LAUNCHES["schedule_apply"]
    edge("S = 0", table, sched, torch.empty((sched.n_in, 0), dtype=torch.int32, device=dev))
    if kernels.LAUNCHES["schedule_apply"] != before:
        raise AssertionError("schedule_apply launched on an empty word range")
    torch.cuda.synchronize()
    return {"phase": "schedule_kernel", "results": [rec], "edges": edges}


def program_counts(prog) -> dict:
    """K6's program for a table: ops, read-after-write levels, groups,
    work slots after reuse by liveness, and the launch shape."""
    from ceph_tpu_torch.ec import kernels

    threads, stages = kernels.schedule_config(prog)
    return {"program_ops": prog.n_ops, "program_levels": prog.n_levels,
            "program_terms": prog.n_terms, "program_groups": len(prog.groups),
            "work_slots": prog.n_work,
            "path": "shared" if threads else "global", "threads": threads, "stages": stages}


def numpy_classify(prev: np.ndarray, up: np.ndarray, acting: np.ndarray, min_size: int):
    """The peering classifier restated in numpy: (flags, survivor_mask)."""
    from ceph_tpu_torch.crush.map import ITEM_NONE
    from ceph_tpu_torch.recovery import peering as P

    size = acting.shape[1]
    alive = acting != ITEM_NONE
    surv = alive & (acting == prev)
    n_alive = alive.sum(1)
    backfill = ((up != ITEM_NONE) & ~(up[:, :, None] == prev[:, None, :]).any(2)).any(1)
    flags = (np.where((up != acting).any(1), P.PG_STATE_REMAPPED, 0)
             | np.where(surv.sum(1) < size, P.PG_STATE_DEGRADED, 0)
             | np.where(n_alive < size, P.PG_STATE_UNDERSIZED, 0)
             | np.where(backfill, P.PG_STATE_BACKFILL, 0)
             | np.where(n_alive < min_size, P.PG_STATE_INACTIVE, 0))
    flags = np.where(flags == 0, P.PG_STATE_CLEAN, flags).astype(np.int32)
    mask = (surv.astype(np.uint64) << np.arange(size, dtype=np.uint64)).sum(1).astype(np.uint32)
    return flags, mask


def recovery_store(codec, pgs: np.ndarray, dev):
    """Seeded data for the degraded PGs, with parity from one batched
    encode on the card; returns ``read_shard(pg, s)`` over one host
    array ``[k + m, n_pgs * chunk]``."""
    k = codec.get_data_chunk_count()
    data = card_bytes((k, len(pgs) * RECOVERY_CHUNK), SEED + 11, dev)
    full = torch.cat([data, codec.codec.encode_async(data)]).cpu().numpy()
    col = {int(pg): i * RECOVERY_CHUNK for i, pg in enumerate(pgs)}
    return full, lambda pg, s: full[s, col[pg]:col[pg] + RECOVERY_CHUNK]


def phase_recovery(dev, launch_counts, reset_launches, n_osds: int = RECOVERY_OSDS,
                   pg_num: int = RECOVERY_PGS) -> dict:
    """``recover_pool`` after a rack failure, for each code of
    RECOVERY_CODES.  ``reset_launches()`` sets the kernels' counters to
    0 just before each code's ``recover_pool`` calls and
    ``launch_counts()`` reads them just after, so the path's counts
    leave out the store's encode and the peering checks."""
    import copy

    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.ec import create
    from ceph_tpu_torch.models.clusters import build_osdmap

    cur = build_osdmap(n_osds, pg_num=pg_num, size=11, pool_kind="erasure")
    prev = copy.deepcopy(cur)
    inc = rec.inject(cur, RECOVERY_FAILURE)
    peered = rec.peer_pool(prev, cur, 1, device=dev)
    flags, mask = numpy_classify(peered.prev_acting, peered.up, peered.acting, peered.min_size)
    if not (np.array_equal(peered.flags, flags) and np.array_equal(peered.survivor_mask, mask)):
        raise AssertionError("peering differs from the numpy classification")
    degraded = peered.pgs_with(rec.PG_STATE_DEGRADED)
    out = {"phase": "recovery", "osds": n_osds, "pgs": pg_num, "failure": RECOVERY_FAILURE,
           "osds_failed": len(inc.new_state), "chunk_bytes": RECOVERY_CHUNK,
           "degraded_pgs": len(degraded), "counts": peered.counts(), "codes": {}}
    pc = rec.recovery_counters()
    path_counts: dict[str, int] = {}
    for name, (profile, mode) in RECOVERY_CODES.items():
        codec = create(profile, device=dev)
        full, read_shard = recovery_store(codec, degraded, dev)
        cfg = Config(env={})
        cfg.set("recovery_xor_schedule", mode)
        call = lambda: rec.recover_pool(prev, cur, 1, codec, read_shard, config=cfg, device=dev)
        before = pc.dump()["recovery"]
        reset_launches()
        runs, secs = [], []
        for _ in range(RECOVERY_REPS):
            t0 = time.perf_counter()
            runs.append(call())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        after = pc.dump()["recovery"]
        prof = profile_call(call) if name == RECOVERY_PROFILED else None
        for kname, v in launch_counts().items():
            path_counts[kname] = path_counts.get(kname, 0) + v
        peering, plan, result = runs[0]
        if not np.array_equal(peering.survivor_mask, peered.survivor_mask):
            raise AssertionError(f"{name}: recover_pool peered differently")
        bit_groups = sum(1 for g in plan.groups if g.repair_matrix is None or mode == "on")
        for _, plan_i, res in runs:
            if res.launches != plan_i.n_patterns or res.schedule_launches != bit_groups:
                raise AssertionError(f"{name}: {res.launches} launches for {plan_i.n_patterns} "
                                     f"patterns, {res.schedule_launches} schedules")
            for g in plan_i.groups:
                for pg in g.pgs:
                    for s in g.missing:
                        if not np.array_equal(res.shards[int(pg)][s], read_shard(int(pg), s)):
                            raise AssertionError(f"{name}: pg {pg} shard {s} rebuilt wrong")
        avg = lambda key: ((after[key]["sum"] - before[key]["sum"])
                           / max(after[key]["avgcount"] - before[key]["avgcount"], 1))
        wall = float(np.median(secs))
        out["codes"][name] = {
            "profile": profile, "mode": mode, "patterns": plan.n_patterns,
            "degraded_pgs": plan.n_pgs, "unrecoverable_pgs": int(len(plan.unrecoverable)),
            "missing_histogram": {str(n): sum(g.n_pgs for g in plan.groups if len(g.missing) == n)
                                  for n in sorted({len(g.missing) for g in plan.groups})},
            "launches": result.launches, "schedule_launches": result.schedule_launches,
            "table_launches": result.launches - result.schedule_launches,
            "bytes_read": plan.bytes_to_read(RECOVERY_CHUNK),
            "bytes_rebuilt": result.bytes_recovered, "shards_rebuilt": result.shards_rebuilt,
            "l_peering_s": avg("l_peering"), "l_plan_s": avg("l_plan"),
            "decode_s": float(np.median([r[2].decode_s for r in runs])),
            "recover_pool_s": wall, "all_recover_pool_s": secs,
            "rebuilt_GBps": result.bytes_recovered / wall / 1e9,
            **({"profile_recover_pool": prof} if prof is not None else {}),
        }
        del full, runs
    out["launches"] = path_counts
    return out


VERIFY_ROWS = 32                # one decode-verify group of host0_0's loss
SCRUB_EDGES = [  # (rows, L, bytes the first row starts past a 16-byte boundary)
    (5, 0, 0), (7, 1, 0), (9, 3, 0), (33, 15, 0), (33, 16, 0), (33, 17, 0), (257, 4097, 0),
    (64, 4096, 1), (31, 4101, 3), (1, 32768, 0), (1, 9, 0),
    # the scrub pass's cut (1 KiB segments) at rows that need no more lanes
    (67584, 1023, 0), (67584, 1024, 0), (67584, 1025, 0), (67584, 2048, 0),
    (2112, 32767, 0), (2112, 32769, 0), (2112, 40960, 0),  # the last: five staged steps
    # the decode-verify cut (a block a row, 64-byte segments)
    (VERIFY_ROWS, 63, 0), (VERIFY_ROWS, 64, 0), (VERIFY_ROWS, 65, 0), (VERIFY_ROWS, 128, 0),
    (VERIFY_ROWS, 32767, 0), (VERIFY_ROWS, 32769, 0), (VERIFY_ROWS, 65536, 0),
    # rows 1-15 bytes past a boundary, 4101 bytes across 512 segments of 16
    *[(VERIFY_ROWS, 4101, off) for off in range(1, 16)],
    (1, 64 * MIB, 0),               # 512 segments of 128 KiB, nine tree levels
    ((1 << 20) * 128 + 5, 1, 0),    # more rows than one grid of K8 covers
]
LONG_ROW = 4096                 # edge rows over twice this are held in pieces of it, combined on the host
SUPERVISED_PASSES = ("mid-repair-loss", "scrub-storm", "flapping-osd")
SUPERVISED_GRACE = 0.5          # heartbeat grace of flapping-osd (the scenario's 0.75 s drops)
SUPERVISED_SEED = 7             # retry-jitter seed
SUPERVISED_SMALL = (128, 128, 1024)  # OSDs, PGs, chunk of the card-vs-CPU replay
#: the scenarios replayed at SUPERVISED_SMALL (mid-repair-loss rides the
#: traffic replay)
SUPERVISED_REPLAY = ("scrub-storm", "flapping-osd")
# config 6's foreground-traffic pass (bench/config6_recovery.py:390-404)
TRAFFIC_SCENARIO = "mid-repair-loss"
TRAFFIC_OPS = 65536
TRAFFIC_OP_BYTES = 64
TRAFFIC_SERVICE_MS = 0.5
TRAFFIC_OSD_CAP_OPS = 6000.0
TRAFFIC_REC_CAP_BPS = 4e6       # repair bandwidth that saturates the fabric
TRAFFIC_ARBITER_CAP_BPS = 8e6
TRAFFIC_SLOW_MS = 10.0
TRAFFIC_SEED = 6
OVERLOAD_FACTOR = 40.0
OVERLOAD_START_S, OVERLOAD_END_S = 3.0, 6.0  # after convergence
POST_STEPS = 10                 # 1 s pure-traffic steps after convergence
TRAFFIC_SLO = {"max_p99_latency_ms": 8.0, "max_slow_op_fraction": 0.02}
# config 6's scrub pass (:573-580, :650-718): the three-class arbiter
SCRUB_QOS_SCENARIO = "scrub-storm"
SCRUB_OPS = 16384
SCRUB_SLO = {"max_inconsistent_seconds": 60.0, "max_scrub_age_s": 120.0,
             "max_p99_latency_ms": 20.0}
TRAFFIC_SMALL_OPS = 2048        # ops a step of the card-vs-CPU traffic replay
# the replay's mean_ms: a float32 sum of 4,096 latencies reduced in
# another order on the card (a tree of about 12 levels, float32 eps 1.2e-7)
TRAFFIC_REPLAY_RTOL = 1e-5


def crc_rows_plain_long(x: torch.Tensor) -> torch.Tensor:
    """The plain K8 of rows too long for its byte loop (a launch or more
    a byte of the row): each row's LONG_ROW-byte pieces (the last one
    shorter) through ``crc_rows_plain`` at once, combined on the host by
    ``crc32c_combine`` (both held to the reference on the CPU)."""
    from ceph_tpu_torch.recovery import scrub

    n, L = x.shape
    whole = L - L % LONG_ROW
    pieces = scrub.crc_rows_plain(x[:, :whole].reshape(-1, LONG_ROW)).view(n, -1).tolist()
    tail = scrub.crc_rows_plain(x[:, whole:]).tolist()
    crcs = []
    for row, last in zip(pieces, tail):
        crc = row[0]
        for c in row[1:]:
            crc = scrub.crc32c_combine(crc, c, LONG_ROW)
        crcs.append(scrub.crc32c_combine(crc, last, L - whole))
    return torch.tensor(crcs, dtype=torch.int64, device=x.device)


def phase_scrub_kernel(int_rate: float, dev, n_pgs: int = RECOVERY_PGS,
                       chunk: int = RECOVERY_CHUNK, edges=SCRUB_EDGES) -> dict:
    """K8 (the scrub's CRC32C of rows) vs its plain version, bit for bit:
    at the supervised store's shape (n_pgs x 11 rows of ``chunk`` bytes:
    a scrub pass) and at one decode-verify group (VERIFY_ROWS rows),
    timed, each with its cut (``scrub.crc_segments``), and on ``edges``
    and the check value, compared only."""
    from ceph_tpu_torch.recovery import scrub

    results = []
    for rows, label in ((n_pgs * 11, f"a scrub pass of {n_pgs} PGs x 11 shards"),
                        (VERIFY_ROWS, "one decode-verify group")):
        data = card_bytes((rows, chunk), SEED + 12, dev)
        rec = kernel_record("crc32c_rows", "ceph_tpu/recovery/scrub.py:120",
                            lambda: scrub.crc_rows(data), lambda: scrub.crc_rows_plain(data),
                            rows * chunk + rows * 8, rows * chunk, int_rate, plain_reps=0)
        log_w, seg = scrub.crc_segments(rows, chunk)
        rec.update(shape=f"[{rows}, {chunk}] u8 ({label})", lanes_a_row=1 << log_w,
                   segment_bytes=seg,
                   bound_note="bytes read at HBM rate; ops = one table lookup a byte")
        results.append(rec)
        del data
    out_edges = []
    for n, length, offset in edges:
        g = torch.Generator(device=dev).manual_seed(SEED + n + length)
        flat = torch.randint(0, 256, (n * length + offset,), generator=g, device=dev,
                             dtype=torch.uint8)
        x = flat[offset:].view(n, length)
        plain = crc_rows_plain_long if length > 2 * LONG_ROW else scrub.crc_rows_plain
        equal, err = compare(scrub.crc_rows(x), plain(x))
        log_w, seg = scrub.crc_segments(n, length)
        out_edges.append({"case": f"{n} rows x {length} bytes, +{offset}", "bit_equal": equal,
                          "max_abs_err": err, "lanes_a_row": 1 << log_w, "segment_bytes": seg})
        del flat, x
    check = torch.tensor(list(b"123456789"), dtype=torch.uint8, device=dev)[None, :]
    out_edges.append({"case": "check value crc32c('123456789') = 0xE3069283",
                      "bit_equal": int(scrub.crc_rows(check)[0]) == 0xE3069283,
                      "max_abs_err": 0})
    torch.cuda.synchronize()
    return {"phase": "scrub_kernel", "results": results, "edges": out_edges}


@contextlib.contextmanager
def k8_launch_shapes(shapes: list):
    """Append the ``(rows, L)`` of every K8 launch in a block to
    ``shapes``: the scrub module's callers look ``crc_rows`` up when they
    call it, so it is wrapped for the block (the wrapper's count is
    untouched)."""
    from ceph_tpu_torch.recovery import scrub

    inner = scrub.crc_rows

    def recording(data):
        if data.is_cuda and data.dim() == 2 and data.shape[0]:
            shapes.append(tuple(data.shape))
        return inner(data)

    scrub.crc_rows = recording
    try:
        yield
    finally:
        scrub.crc_rows = inner


def shape_summary(shapes: list) -> dict:
    """Min, median and max of the rows and of L over K8 launches, and the
    launches of each shape."""
    out: dict = {"launches": len(shapes), "by_shape": {}}
    for i, key in ((0, "rows"), (1, "L")):
        v = [s[i] for s in shapes] or [0]
        out[key] = {"min": min(v), "median": float(np.median(v)), "max": max(v)}
    for s in shapes:
        out["by_shape"][f"[{s[0]}, {s[1]}]"] = out["by_shape"].get(f"[{s[0]}, {s[1]}]", 0) + 1
    return out


@contextlib.contextmanager
def count_syncs(out: dict, driver=None, pieces=None):
    """Count the host syncs of a block: torch's sync-debug mode warns on
    every synchronizing CUDA call (a copy to the host, ``.item()``,
    ``nonzero``), and the warnings are counted into ``out["host_syncs"]``.
    With a ``driver`` and its ``pieces`` (as :func:`piece_launches`
    takes them), also by piece into ``out["host_syncs_by_piece"]``."""
    import warnings

    def syncs(ws):
        return sum(1 for w in ws if "synchroniz" in str(w.message))

    by = {p: 0 for p in pieces} if pieces else None

    def counted(piece, fn):
        def call(*a, **kw):
            n0 = len(seen)
            try:
                return fn(*a, **kw)
            finally:
                by[piece] += syncs(seen[n0:])
        return call

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            if by is None:
                yield
            else:
                with pieces_wrapped(driver, counted, pieces):
                    yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["host_syncs"] = syncs(seen)
    if by is not None:
        out["host_syncs_by_piece"] = by


def supervised_store(codec, pg_num: int, chunk: int, dev):
    """Every shard of every PG: seeded data made on the card, parity from
    one batched encode there, brought to one host array ``[k + m,
    pg_num * chunk]``; returns it with ``read_shard``/``write_shard``."""
    k = codec.get_data_chunk_count()
    data = card_bytes((k, pg_num * chunk), SEED + 13, dev)
    full = torch.cat([data, codec.codec.encode_async(data)]).cpu().numpy()
    del data

    def cols(pg):
        return slice(pg * chunk, (pg + 1) * chunk)

    def write(pg, s, buf):
        full[s, cols(pg)] = buf

    return full, (lambda pg, s: full[s, cols(pg)]), write


def supervised_run(scenario: str, m, codec, read_shard, write_shard, dev, n_pgs: int,
                   scrub: bool = False):
    """One pass of SupervisedRecovery under ``scenario`` on a deepcopy of
    ``m``, with an EventJournal, a HealthTimeline graded by an SLO and
    an OpTracker on the virtual clock (and a Scrubber riding the loop
    when ``scrub``).  Returns (result, chaos, journal, timeline, spec,
    scrubber)."""
    import copy

    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.common.op_tracker import OpTracker
    from ceph_tpu_torch.obs import EventJournal, HealthTimeline, SLOSpec

    cur, prev = copy.deepcopy(m), m
    cfg = Config(env={})
    cfg.set("osd_heartbeat_grace", SUPERVISED_GRACE)
    clock = rec.VirtualClock()
    journal = EventJournal(clock=clock.now, trace_id=f"chip-{scenario}")
    spec = SLOSpec(max_inactive_seconds=10.0, min_availability_fraction=0.99,
                   max_time_to_zero_degraded_s=60.0, max_inconsistent_seconds=10.0)
    health = HealthTimeline(clock.now, k=codec.get_data_chunk_count(),
                            sample_status=spec.sample_status, device=dev)

    def corrupt(pg, s, off, mask):
        rec.apply_bitrot(read_shard(pg, s), off, mask)

    chaos = rec.ChaosEngine(cur, rec.build_scenario(scenario, cur), clock=clock,
                            journal=journal, corrupt=corrupt, config=cfg, device=dev)
    scrubber = (rec.Scrubber(n_pgs, cur.pools[1].size, journal=journal, clock=clock.now,
                             device=dev) if scrub else None)
    sup = rec.SupervisedRecovery(codec, chaos, config=cfg, seed=SUPERVISED_SEED,
                                 journal=journal, health=health,
                                 op_tracker=OpTracker(clock=clock.now, config=cfg),
                                 scrubber=scrubber, write_shard=write_shard if scrub else None,
                                 device=dev)
    res = sup.run(prev, 1, read_shard)
    return res, chaos, journal, health, spec, scrubber


def traffic_arbiter(clock, scrub: bool):
    """Config 6's mclock arbiter over TRAFFIC_ARBITER_CAP_BPS: client
    reservation 1/2 and recovery reservation 1/8, then a recovery limit
    of 1/4 (the traffic pass) or a scrub reservation of 1/16 and a scrub
    limit of 1/4 (the scrub pass's three classes)."""
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.workload import MClockArbiter

    cap = TRAFFIC_ARBITER_CAP_BPS
    cfg = Config(env={})
    cfg.set("osd_mclock_client_res_bps", cap / 2)
    cfg.set("osd_mclock_recovery_res_bps", cap / 8)
    if scrub:
        cfg.set("osd_mclock_scrub_res_bps", cap / 16)
        cfg.set("osd_mclock_scrub_lim_bps", cap / 4)
    else:
        cfg.set("osd_mclock_recovery_lim_bps", cap / 4)
    return MClockArbiter.from_config(cap, cfg, clock=clock.now, sleep=clock.sleep)


def traffic_run(scenario: str, m, codec, read_shard, write_shard, dev, n_pgs: int, ops: int,
                arbiter_on: bool, scrub: bool = False, overload: bool = False) -> dict:
    """One pass of config 6's traffic run (``bench/config6_recovery.py::
    _traffic_pass``) or, with ``scrub``, of its scrub run (``_scrub_pass``)
    on a deepcopy of ``m``: a TrafficEngine of ``ops`` ops a step riding
    every health sample of SupervisedRecovery (with config 6's arbiter
    when ``arbiter_on``), an EventJournal and a HealthTimeline graded by
    TRAFFIC_SLO (SCRUB_SLO).  ``scrub`` adds a Scrubber (admitted through
    the arbiter's scrub class) and the engine's integrity loop;
    ``overload`` adds POST_STEPS one-second steps on the converged map
    with a 40x overload inside them.  Records which rotted PGs had their
    checksum row refreshed by the integrity loop while the rot was in the
    store (``refreshed``), each rotted shard's clean bytes, and the
    engine's latency histogram after every sample."""
    import copy

    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.obs import EventJournal, HealthTimeline, SLOSpec, evaluate
    from ceph_tpu_torch.workload import TrafficEngine

    cur, prev = copy.deepcopy(m), m
    clock = rec.VirtualClock()
    journal = EventJournal(clock=clock.now, trace_id=f"chip-traffic-{scenario}")
    spec = SLOSpec(**(SCRUB_SLO if scrub else TRAFFIC_SLO))
    k, size = codec.get_data_chunk_count(), cur.pools[1].size
    health = HealthTimeline(clock.now, k=k, sample_status=spec.sample_status, device=dev)
    arbiter = traffic_arbiter(clock, scrub) if arbiter_on else None
    rotted: set = set()
    refreshed: set = set()
    clean_bytes: dict = {}

    def corrupt(pg, s, off, mask):
        clean_bytes.setdefault((pg, s), np.array(read_shard(pg, s)))
        rotted.add((pg, s))
        rec.apply_bitrot(read_shard(pg, s), off, mask)

    def write_back(pg, s, buf):
        rotted.discard((int(pg), int(s)))
        write_shard(pg, s, buf)

    chaos = rec.ChaosEngine(cur, rec.build_scenario(scenario, cur), clock=clock,
                            journal=journal, corrupt=corrupt, device=dev)
    scrubber = None
    if scrub:
        scrubber = rec.Scrubber(n_pgs, size, arbiter=arbiter, journal=journal,
                                clock=clock.now, device=dev)
        note_write = scrubber.note_write

        def noting(pg, rs):
            if any(p == pg for p, _ in rotted):
                refreshed.add(int(pg))
            note_write(pg, rs)

        scrubber.note_write = noting
    traffic = TrafficEngine(
        clock.now, cur.max_osd, n_pgs, k, size, k + 1, ops_per_step=ops,
        service_ms=TRAFFIC_SERVICE_MS, osd_capacity_ops_per_s=TRAFFIC_OSD_CAP_OPS,
        recovery_capacity_bps=TRAFFIC_REC_CAP_BPS, op_bytes=TRAFFIC_OP_BYTES,
        slow_ms=TRAFFIC_SLOW_MS, seed=TRAFFIC_SEED, arbiter=arbiter, journal=journal,
        scrubber=scrubber, read_shard=read_shard if scrub else None, device=dev)
    hists = []
    observe = traffic.observe

    def observing(*args, **kwargs):
        sample = observe(*args, **kwargs)
        hists.append(traffic._cum_lat_hist.copy())
        return sample

    traffic.observe = observing
    sup = rec.SupervisedRecovery(codec, chaos, config=Config(env={}), seed=0, journal=journal,
                                 health=health, traffic=traffic, arbiter=arbiter,
                                 scrubber=scrubber, write_shard=write_back if scrub else None,
                                 device=dev)
    res = sup.run(prev, 1, read_shard)
    if overload:
        # an induced overload on the converged cluster: the health grade
        # of these samples is traffic's alone (OK -> WARN -> OK)
        clean = rec.peer_pool(chaos.osdmap, chaos.osdmap, 1, device=dev)
        t0 = clock.now()
        traffic.set_overload(t0 + OVERLOAD_START_S, t0 + OVERLOAD_END_S, OVERLOAD_FACTOR)
        for _ in range(POST_STEPS):
            clock.advance(1.0)
            sample = traffic.observe(clean, epoch=chaos.epoch,
                                     bytes_recovered=res.bytes_recovered)
            health.snapshot(clean, epoch=chaos.epoch, bytes_recovered=res.bytes_recovered,
                            traffic=sample)
    return {"res": res, "traffic": traffic, "health": health, "report": evaluate(health, spec),
            "arbiter": arbiter, "chaos": chaos, "journal": journal, "scrubber": scrubber,
            "refreshed": refreshed, "clean_bytes": clean_bytes, "lat_hists": hists}


def observe_probe(peering, n_osds: int, k: int, size: int, dev) -> dict:
    """One ``TrafficEngine.observe`` at TRAFFIC_OPS on ``peering``'s device
    tensors, after a warm-up: its kernel launches and copies and their
    device ms (torch.profiler), its host syncs, and its ms by CUDA events
    and by the host clock (median of 10 each)."""
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.workload import TrafficEngine

    eng = TrafficEngine(lambda: 0.0, n_osds, peering.pg_num, k, size, k + 1,
                        ops_per_step=TRAFFIC_OPS, service_ms=TRAFFIC_SERVICE_MS,
                        osd_capacity_ops_per_s=TRAFFIC_OSD_CAP_OPS, device=dev)
    eng.observe(peering)
    torch.cuda.synchronize()
    out: dict = {}
    with count_syncs(out):
        eng.observe(peering)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.observe(peering)
        torch.cuda.synchronize()
    kernels = copies = 0
    device_us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.key.startswith("Memcpy") or e.key.startswith("Memset"):
            copies += e.count
        elif not getattr(e, "is_user_annotation", False):
            kernels += e.count
        device_us += getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng.observe(peering)
        walls.append((time.perf_counter() - t0) * 1e3)
    out.update(kernel_launches=kernels, copies=copies, device_ms=device_us / 1e3,
               ms=time_ms(lambda: eng.observe(peering)), wall_ms=float(np.median(walls)),
               ops=TRAFFIC_OPS)
    return out


def traffic_record(runs: dict) -> dict:
    """Config 6's ``traffic_*`` fields (``build_traffic_record``) from the
    no-arbiter and arbiter runs, with the overload steps' health grades."""
    arb, noarb = runs[True], runs[False]

    def recovery_p99(eng) -> float:
        # the pre-overload samples: where QoS policy, not the induced
        # incident, sets the tail
        return max((t.p99_ms for t in eng.samples[:max(len(eng.samples) - POST_STEPS, 0)]),
                   default=0.0)

    s = arb["traffic"].summary()
    report = arb["report"]
    return {
        "traffic_scenario": TRAFFIC_SCENARIO,
        "traffic_ops": s["ops"],
        "traffic_ops_per_sec": s["ops_per_sec_wall"],
        "traffic_p99_ms": round(arb["health"].max_traffic_p99_ms(), 6),
        "traffic_recovery_p99_ms": round(recovery_p99(arb["traffic"]), 6),
        "traffic_recovery_p99_ms_no_arbiter": round(recovery_p99(noarb["traffic"]), 6),
        "traffic_degraded_fraction": s["degraded_fraction"],
        "traffic_blocked_fraction": s["blocked_fraction"],
        "traffic_slow_ops": s["slow_ops"],
        "traffic_slow_fraction": round(s["slow_ops"] / max(s["ops"], 1), 9),
        "traffic_health_status": report.status,
        "traffic_slo_checks": {c.name: c.status for c in report.checks},
        "traffic_time_to_zero_degraded_s": round(arb["res"].time_to_zero_degraded_s, 6),
        "traffic_time_to_zero_degraded_s_no_arbiter": round(
            noarb["res"].time_to_zero_degraded_s, 6),
        "traffic_qos": arb["arbiter"].summary(),
        "traffic_overload_healths": [
            x.health for x in arb["health"].samples if x.traffic is not None][-POST_STEPS:],
    }


def scrub_record(runs: dict) -> dict:
    """Config 6's ``scrub_*`` fields (``build_scrub_record``, less the
    standalone CRC rate: phase ``scrub_kernel`` times K8) from the
    arbiter and no-arbiter runs, with the engine's integrity counters."""
    arb, noarb = runs[True], runs[False]
    res, report = arb["res"], arb["report"]
    s = arb["traffic"].summary()
    return {
        "scrub_scenario": SCRUB_QOS_SCENARIO,
        "scrub_converged": res.converged,
        "scrub_passes": int(res.scrub_passes),
        "scrub_scrubbed_bytes": int(res.scrubbed_bytes),
        "scrub_inconsistencies_found": int(res.inconsistencies_found),
        "scrub_verify_retries": int(res.verify_retries),
        "scrub_unrecoverable": int(len(res.inconsistent_unrecoverable)),
        "scrub_time_to_zero_inconsistent_s": round(res.time_to_zero_inconsistent_s, 6),
        "scrub_time_to_zero_inconsistent_s_no_arbiter": round(
            noarb["res"].time_to_zero_inconsistent_s, 6),
        "scrub_p99_ms": round(arb["health"].max_traffic_p99_ms(), 6),
        "scrub_p99_ms_no_arbiter": round(noarb["health"].max_traffic_p99_ms(), 6),
        "scrub_health_status": report.status,
        "scrub_slo_checks": {c.name: c.status for c in report.checks},
        "scrub_qos": arb["arbiter"].summary(),
        "traffic_ops": s["ops"],
        "traffic_ops_per_sec": s["ops_per_sec_wall"],
        "writes_checksummed": s["writes_checksummed"],
        "degraded_reads_verified": s["degraded_reads_verified"],
        "read_verify_failures": s["read_verify_failures"],
    }


def phase_traffic(dev, launch_counts, reset_launches, m, codec, read_shard, write_shard,
                  pg_num: int) -> dict:
    """Config 6's traffic pass (TRAFFIC_SCENARIO, TRAFFIC_OPS a step, the
    overload after convergence) and its scrub pass (SCRUB_QOS_SCENARIO,
    SCRUB_OPS a step, the three-class arbiter, the integrity loop), each
    without and with the arbiter, on the supervised phase's map and
    store; each pass is one main path, its runs counted from 0 (launches,
    host syncs, wall seconds) and gated after the counts are read.  The
    scrub runs' rot is undone in the store before the next run."""
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.obs import HEALTH_OK, HEALTH_WARN

    k = codec.get_data_chunk_count()
    out = {}
    for name, scenario, ops, scrub in (("traffic", TRAFFIC_SCENARIO, TRAFFIC_OPS, False),
                                       ("scrub_qos", SCRUB_QOS_SCENARIO, SCRUB_OPS, True)):
        path: dict = {}
        runs, info = {}, {"runs": {}}
        gates: dict = {}
        for arb in (False, True):
            run_info: dict = {}
            reset_launches()
            t0 = time.perf_counter()
            with count_syncs(run_info):
                r = traffic_run(scenario, m, codec, read_shard, write_shard, dev, pg_num, ops,
                                arb, scrub=scrub, overload=not scrub)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for kname, v in launch_counts().items():
                path[kname] = path.get(kname, 0) + v
            runs[arb] = r
            res, eng = r["res"], r["traffic"]
            s = res.summary()
            final = rec.peer_pool(m, r["chaos"].osdmap, 1, device=dev)
            surv = final.n_survivors()
            below_k = {int(p) for p in final.pgs_with(rec.PG_STATE_DEGRADED) if surv[p] < k}
            wrong = [(pg, sh) for pg, shards in res.shards.items() for sh, buf in shards.items()
                     if not np.array_equal(buf, read_shard(pg, sh))]
            tag = "arbiter" if arb else "no_arbiter"
            run_info.update(wall_s=wall, samples=len(eng.samples), engine=eng.summary(),
                            bytes_recovered=int(res.bytes_recovered),
                            stale_launches=s["stale_launches"], salvaged_pgs=s["salvaged_pgs"],
                            time_to_zero_degraded_s=res.time_to_zero_degraded_s,
                            unrecoverable_pgs=s["unrecoverable_pgs"], below_k_pgs=sorted(below_k),
                            shards_wrong=len(wrong), slo=r["report"].status)
            gates[f"converged_{tag}"] = bool(res.converged)
            gates[f"shards_equal_store_{tag}"] = not wrong
            gates[f"unrecoverable_is_below_k_{tag}"] = set(s["unrecoverable_pgs"]) == below_k
            gates[f"no_failed_pgs_{tag}"] = not s["failed_pgs"]
            gates[f"every_sample_completes_ops_{tag}"] = all(
                x.completed > 0 and x.served + x.degraded + x.blocked == x.ops
                for x in eng.samples)
            if scrub:
                chaos, journal, scrubber = r["chaos"], r["journal"], r["scrubber"]
                rotted = {c.event.pg for c in chaos.corruptions}
                found = {p for j in journal.by_name("scrub.inconsistent") for p in j["attrs"]["pgs"]}
                after = scrubber.scrub(read_shard).n_inconsistent  # a check pass, after the counts
                run_info.update(corrupted_pgs=sorted(rotted), refreshed_while_rotted=sorted(
                    r["refreshed"]), inconsistent_unrecoverable=sorted(
                    res.inconsistent_unrecoverable), closing_check_inconsistent=after,
                    p99_ms=r["health"].max_traffic_p99_ms())
                gates[f"every_corruption_found_{tag}"] = rotted <= found
                gates[f"scrubbed_clean_{tag}"] = after == 0
                # the integrity loop refreshes a written PG's checksum row
                # from the store's bytes, rot included (the reference's
                # Scrubber.note_write); such a PG ends inconsistent-
                # unrecoverable, and no other one may
                gates[f"inconsistent_unrecoverable_is_refreshed_rot_{tag}"] = (
                    set(res.inconsistent_unrecoverable) == r["refreshed"])
                gates[f"client_p99_within_slo_{tag}"] = (
                    r["health"].max_traffic_p99_ms() <= SCRUB_SLO["max_p99_latency_ms"])
                gates[f"writes_checksummed_{tag}"] = eng.writes_checksummed > 0
                gates[f"degraded_reads_verified_{tag}"] = eng.degraded_reads_verified > 0
                for (pg, sh), clean in r["clean_bytes"].items():  # undo the rot
                    write_shard(pg, sh, clean)
            info["runs"][tag] = run_info
            print(json.dumps({"traffic_pass": name, "arbiter": arb, "wall_s": wall,
                              "host_syncs": run_info["host_syncs"], "samples": len(eng.samples)}),
                  flush=True)
        arb_run, noarb_run = runs[True], runs[False]
        # the two runs need not rebuild the same bytes: where the arbiter
        # slows recovery, an epoch can land on a launch in flight and its
        # salvage commits fewer shards (the reference does the same:
        # tests/test_torch_traffic.py::test_traffic_pass_matches_reference)
        gates["bytes_recovered_in_both"] = (
            arb_run["res"].bytes_recovered > 0 and noarb_run["res"].bytes_recovered > 0)
        gates["same_unrecoverable_pgs"] = (
            arb_run["res"].summary()["unrecoverable_pgs"]
            == noarb_run["res"].summary()["unrecoverable_pgs"])
        if scrub:
            info.update(scrub_record(runs))
            gates["scrub_class_admitted"] = arb_run["arbiter"].granted("scrub") > 0
        else:
            info.update(traffic_record(runs))
            healths = info["traffic_overload_healths"]
            gates["recovery_p99_below_no_arbiter"] = (
                info["traffic_recovery_p99_ms"] < info["traffic_recovery_p99_ms_no_arbiter"])
            gates["client_granted_is_ops_bytes"] = arb_run["arbiter"].granted("client") == (
                TRAFFIC_OP_BYTES * sum(x.ops for x in arb_run["traffic"].samples))
            gates["recovery_granted_covers_bytes"] = (
                arb_run["arbiter"].granted("recovery") >= arb_run["res"].bytes_recovered)
            gates["overload_ok_warn_ok"] = (
                len(healths) == POST_STEPS and healths[0] == HEALTH_OK
                and HEALTH_WARN in healths and healths[-1] == HEALTH_OK)
            peering = rec.peer_pool(m, arb_run["chaos"].osdmap, 1, device=dev)
            info["observe"] = observe_probe(peering, m.max_osd, k, m.pools[1].size, dev)
        info["launches"] = path
        info["gates"] = gates
        out[name] = info
    return out


def traffic_replay(profile: dict, m_small, pgs_small: int, chunk_small: int, dev) -> dict:
    """The traffic pass (with the arbiter and the overload) at the small
    size on the card and on the CPU: the engine's ``summary()`` but the
    wall rate, every sample's fields but the wall rate (``mean_ms`` within
    TRAFFIC_REPLAY_RTOL), its latency histogram after every sample, the
    supervised summary, the health series and the SLO report equal."""
    from ceph_tpu_torch.ec import create

    got = []
    for d in (dev, torch.device("cpu")):
        c = create(profile, device=d)
        _, rd, wr = supervised_store(c, pgs_small, chunk_small, d)
        r = traffic_run(TRAFFIC_SCENARIO, m_small, c, rd, wr, d, pgs_small, TRAFFIC_SMALL_OPS,
                        True, overload=True)
        got.append(r)
    card, cpu = got

    def samples(r):
        return [{key: v for key, v in vars(x).items() if key != "ops_per_sec_wall"}
                for x in r["traffic"].samples]

    def summary(r):
        return {key: v for key, v in r["traffic"].summary().items() if key != "ops_per_sec_wall"}

    sc, sp = samples(card), samples(cpu)
    means = all(np.isclose(a.pop("mean_ms"), b.pop("mean_ms"), rtol=TRAFFIC_REPLAY_RTOL, atol=0)
                for a, b in zip(sc, sp))
    checks = {
        "summary": summary(card) == summary(cpu),
        "samples": len(sc) == len(sp) and sc == sp,
        "mean_ms": len(sc) == len(sp) and means,
        "lat_hists": len(card["lat_hists"]) == len(cpu["lat_hists"]) and all(
            np.array_equal(a, b) for a, b in zip(card["lat_hists"], cpu["lat_hists"])),
        "supervised_summary": card["res"].summary() == cpu["res"].summary(),
        "health_series": card["health"].series() == cpu["health"].series(),
        "slo": card["report"].to_dict() == cpu["report"].to_dict(),
    }
    return {"equal": all(checks.values()), "checks": checks, "card": summary(card),
            "samples": len(sc)}


def phase_supervised(dev, launch_counts, reset_launches, n_osds: int = RECOVERY_OSDS,
                     pg_num: int = RECOVERY_PGS, chunk: int = RECOVERY_CHUNK,
                     small=SUPERVISED_SMALL) -> dict:
    """SupervisedRecovery on the recovery phase's map and code (RS k=8
    m=3, one ``chunk`` a PG shard), three passes in SUPERVISED_PASSES,
    each counted from 0 (its launches, host syncs and wall seconds), with
    its gates; then config 6's traffic and scrub passes, and the
    SUPERVISED_REPLAY scenarios and the traffic pass at the ``small``
    size on the card and on the CPU, whose summaries must be equal
    (those runs are checks: outside the counts)."""
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.crush import interp_batch
    from ceph_tpu_torch.ec import create
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.obs import evaluate

    profile = RECOVERY_CODES["rs_8_3_auto"][0]
    m = build_osdmap(n_osds, pg_num=pg_num, size=11, pool_kind="erasure")
    codec = create(profile, device=dev)
    k = codec.get_data_chunk_count()
    full, read_shard, write_shard = supervised_store(codec, pg_num, chunk, dev)
    out = {"phase": "supervised", "osds": n_osds, "pgs": pg_num, "chunk_bytes": chunk,
           "store_bytes": int(full.nbytes), "profile": profile, "passes": {}}
    path: dict[str, int] = {}
    k8_shapes: list = []
    for scenario in SUPERVISED_PASSES:
        scrub = scenario == "scrub-storm"
        info: dict = {}
        syncs = interp_batch.HOST_SYNCS
        reset_launches()
        t0 = time.perf_counter()
        with count_syncs(info), k8_launch_shapes(k8_shapes):
            res, chaos, journal, health, spec, scrubber = supervised_run(
                scenario, m, codec, read_shard, write_shard, dev, pg_num, scrub)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        crush_syncs = interp_batch.HOST_SYNCS - syncs
        for kname, v in launches.items():
            path[kname] = path.get(kname, 0) + v
        s = res.summary()
        final = rec.peer_pool(m, chaos.osdmap, 1, device=dev)
        surv = final.n_survivors()
        below_k = {int(p) for p in final.pgs_with(rec.PG_STATE_DEGRADED) if surv[p] < k}
        wrong = [(pg, sh) for pg, shards in res.shards.items() for sh, buf in shards.items()
                 if not np.array_equal(buf, read_shard(pg, sh))]
        info.update(
            wall_s=wall, launches=launches, crush_host_syncs=crush_syncs,
            summary={key: s[key] for key in (
                "converged", "launches", "retries", "stale_launches", "salvaged_pgs",
                "plan_revisions", "time_to_zero_degraded_s", "epochs_observed",
                "completed_pgs", "schedule_launches", "bytes_recovered", "scrub_passes",
                "scrubbed_bytes", "inconsistencies_found", "verify_retries",
                "time_to_zero_inconsistent_s")},
            unrecoverable_pgs=s["unrecoverable_pgs"], below_k_pgs=sorted(below_k),
            failed_pgs=s["failed_pgs"], shards_checked=sum(len(v) for v in res.shards.values()),
            shards_wrong=len(wrong), slo=evaluate(health, spec).to_dict()["status"],
            health_samples=len(health), journal_records=len(journal.records))
        gates = {"converged": s["converged"], "shards_equal_store": not wrong,
                 "unrecoverable_is_below_k": set(s["unrecoverable_pgs"]) == below_k,
                 "no_failed_pgs": not s["failed_pgs"]}
        if scrub:
            rotted = {c.event.pg for c in chaos.corruptions}
            found = {p for r in journal.by_name("scrub.inconsistent") for p in r["attrs"]["pgs"]}
            after = scrubber.scrub(read_shard).n_inconsistent  # a check pass, after the counts
            info.update(corruptions=len(chaos.corruptions), corrupted_pgs=len(rotted),
                        found_pgs=len(found & rotted), closing_check_inconsistent=after,
                        scrub_GBps=s["scrubbed_bytes"] / wall / 1e9)
            gates.update(every_corruption_found=rotted <= found, scrubbed_clean=after == 0,
                         none_inconsistent_unrecoverable=not s["inconsistent_unrecoverable_pgs"])
        if scenario == "flapping-osd":
            det = chaos.liveness.summary()
            info.update(liveness=det, detector_epochs=[r["attrs"]["epoch"] for r in
                                                       journal.by_name("chaos.detected")])
            gates["detected"] = det["downs"] >= 1
        info["gates"] = gates
        out["passes"][scenario] = info
        print(json.dumps({"supervised_pass": scenario, "wall_s": wall,
                          "host_syncs": info["host_syncs"], "gates": gates}), flush=True)
    out["launches"] = path
    out["k8_launch_shapes"] = shape_summary(k8_shapes)
    out.update(phase_traffic(dev, launch_counts, reset_launches, m, codec, read_shard,
                             write_shard, pg_num))
    del full
    # the same seeded runs at a small size on the card and on the CPU
    n_small, pgs_small, chunk_small = small
    m_small = build_osdmap(n_small, pg_num=pgs_small, size=11, pool_kind="erasure")
    replay = {}
    for scenario in SUPERVISED_REPLAY:
        sums = []
        t0 = time.perf_counter()
        for d in (dev, torch.device("cpu")):
            c = create(profile, device=d)
            _, rd, wr = supervised_store(c, pgs_small, chunk_small, d)
            sums.append(supervised_run(scenario, m_small, c, rd, wr, d, pgs_small,
                                       scenario == "scrub-storm")[0].summary())
        replay[scenario] = {"equal": sums[0] == sums[1], "card": sums[0],
                            "check_wall_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    replay["traffic"] = traffic_replay(profile, m_small, pgs_small, chunk_small, dev)
    replay["traffic"]["check_wall_s"] = time.perf_counter() - t0
    out["card_equals_cpu"] = replay
    return out

EPOCH_OSDS = 1024               # BASELINE config 7's acceptance geometry
EPOCH_PGS = 8192
EPOCH_OPS = 64                  # ops a traffic step (config 7's)
EPOCH_EPOCHS = 512              # superstep epochs timed, after a warm-up chunk
EPOCH_CHUNK = 256               # epochs a chunk (a snapshot, one copy back)
EPOCH_STAGED = 128              # staged epochs timed, after EPOCH_STAGED_WARM
EPOCH_STAGED_WARM = 8
EPOCH_PROFILED = 8              # config 7 epochs under torch.profiler for the split
EPOCH_TURN = 64                 # epochs a run of the in-turns rates and the host split
EPOCH_WALK = "rack-cascade"     # the dirty walk's zoo scenario
EPOCH_SMALL = (64, 128)         # OSDs, PGs of the card-vs-CPU replay
EPOCH_SMALL_OPS = 256
#: the epoch body's pieces, each a span for the launch split
EPOCH_PIECES = {"tape": ("_tape_apply",), "liveness": ("_live",),
                "peering": ("_peer_hist", "_peer_hist_compact"),
                "traffic": ("_traffic_apply",), "scrub": ("_scrub_due",), "row": ("_row",)}


def series_head(series, n: int):
    """The first ``n`` epochs of an EpochSeries."""
    return type(series)(**{f.name: getattr(series, f.name)[:n]
                           for f in dataclasses.fields(series)})


@contextlib.contextmanager
def pieces_wrapped(driver, wrap, pieces=None):
    """Each piece method of ``driver`` (``pieces``, EPOCH_PIECES by
    default: names of ``driver``'s methods, or ``(object, name)`` pairs
    such as a module's function) replaced by ``wrap(piece, method)`` for
    the block, on the instance or the module."""
    pieces = EPOCH_PIECES if pieces is None else pieces
    saved = []
    for piece, methods in pieces.items():
        for meth in methods:
            obj, name = meth if isinstance(meth, tuple) else (driver, meth)
            saved.append((obj, name, vars(obj).get(name)))
            setattr(obj, name, wrap(piece, getattr(obj, name)))
    try:
        yield
    finally:
        for obj, name, before in reversed(saved):
            if before is None:
                delattr(obj, name)
            else:
                setattr(obj, name, before)


def piece_host_ms(driver, run, n_epochs: int, pieces=None) -> dict:
    """Host milliseconds an epoch in each piece of ``run()`` (``pieces``
    as ``pieces_wrapped`` takes them; host clock, no profiler; a piece
    called inside itself is timed once)."""
    pieces = EPOCH_PIECES if pieces is None else pieces
    acc = {p: 0.0 for p in pieces}
    active: set = set()

    def timed(piece, fn):
        def call(*a, **kw):
            if piece in active:
                return fn(*a, **kw)
            active.add(piece)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[piece] += time.perf_counter() - t0
                active.discard(piece)
        return call

    with pieces_wrapped(driver, timed, pieces):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    return {"by_piece": {p: v / n_epochs * 1e3 for p, v in acc.items()},
            "epoch_ms": total / n_epochs * 1e3, "epochs": n_epochs}


def piece_launches(driver, run, pieces=None) -> dict:
    """Kernel launches, copies and memsets of ``run()`` split by the epoch
    body's pieces (``pieces``, EPOCH_PIECES by default): each piece of
    ``driver`` runs inside a ``torch.profiler.record_function`` span, and
    every runtime launch call the profiler saw is given to the innermost
    span around it.  Also the device's busy share of the run."""
    from torch.profiler import ProfilerActivity, profile, record_function

    pieces = EPOCH_PIECES if pieces is None else pieces

    def spanned(name, fn):
        def call(*a, **kw):
            with record_function("epoch:" + name):
                return fn(*a, **kw)
        return call

    with pieces_wrapped(driver, spanned, pieces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end, e.name[len("epoch:"):])
                   for e in events if e.name.startswith("epoch:"))
    calls = []
    for e in events:
        kind = ("kernels" if "LaunchKernel" in e.name else
                "copies" if e.name.startswith("cudaMemcpy") else
                "memsets" if e.name.startswith("cudaMemset") else None)
        if kind is not None and e.device_type == torch.autograd.DeviceType.CPU:
            calls.append((e.time_range.start, kind))
    split = {p: {"kernels": 0, "copies": 0, "memsets": 0} for p in (*pieces, "other")}
    # one sweep in time order: the open spans form a stack (a dense
    # re-peer nests inside the compacted one), its top the innermost
    stack: list = []
    nxt = 0
    for t, kind in sorted(calls):
        while nxt < len(spans) and spans[nxt][0] <= t:
            stack.append(spans[nxt])
            nxt += 1
        stack = [sp for sp in stack if sp[1] >= t]
        split[stack[-1][2] if stack else "other"][kind] += 1
    device_us = sum(
        getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("epoch:"))
    return {"split": split, "wall_ms": wall_ms, "device_ms": device_us / 1e3,
            "device_busy": device_us / 1e3 / wall_ms if wall_ms else None}


def phase_epoch(dev, launch_counts, reset_launches, n_osds: int = EPOCH_OSDS,
                pg_num: int = EPOCH_PGS, epochs: int = EPOCH_EPOCHS, chunk: int = EPOCH_CHUNK,
                staged: int = EPOCH_STAGED, small=EPOCH_SMALL) -> dict:
    """The epoch loop (``recovery/superstep.py``): (a) BASELINE config 7 as
    ``bench/config7_epoch_loop.py`` runs it — ``build_osdmap(n_osds,
    pg_num, size=6, erasure)``, ``slow:5`` and ``slow:17`` at t=0.1,
    EPOCH_OPS ops a step; ``epochs`` superstep epochs in chunks of
    ``chunk`` after a warm-up chunk, ``staged`` staged epochs after
    EPOCH_STAGED_WARM: epochs/s, host syncs an epoch; on the card a
    superstep chunk is one replay of the compiled superstep's CUDA graph
    (its capture ms, nodes, conditional nodes and bodies, the memory it
    reserves); (b) a dirty walk (EPOCH_WALK over enough epochs that every
    event lands) with compaction ``auto`` and ``off``, each through the
    graph, the same body run eagerly and the staged path; these runs are
    the path's launch counts (K3 inside the graph by its bodies' pass
    counters).  Then the checks, outside the counts: the staged series
    over one chunk and the eager body's equal to the graph's; the
    launches an epoch by piece (torch.profiler) of the host-decided loop
    over EPOCH_PROFILED config-7 epochs and over the auto walk, and the
    graph's busy share; a replayed chunk's wrapper calls, seam reads and
    sync warnings; the graph, the eager body, the host-decided loop and
    the staged path in turns; a capture with a host read in the body
    raising; the walk at ``small`` size on the card and on the CPU,
    every lane equal."""
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.analysis import runtime_guard
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.core import graphs
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.recovery.failure import parse_spec

    m = build_osdmap(n_osds, pg_num=pg_num, size=6, pool_kind="erasure")

    def config7():
        return rec.ChaosTimeline([rec.ChaosEvent(0.1, (parse_spec("slow:5"),
                                                       parse_spec("slow:17")))])

    out: dict = {"phase": "epoch", "osds": n_osds, "pgs": pg_num, "size": 6,
                 "n_ops": EPOCH_OPS, "chunk": chunk}
    path: dict[str, int] = {}

    def add(counts):
        for kname, v in counts.items():
            path[kname] = path.get(kname, 0) + v

    def timed(run, n: int) -> tuple:
        info: dict = {}
        with count_syncs(info):
            t0 = time.perf_counter()
            series = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        info.update(epochs=n, wall_s=wall, epochs_per_s=n / wall,
                    host_syncs_per_epoch=info["host_syncs"] / n,
                    dirty_epochs=int(series.dirty.sum()))
        return series, info

    walls: dict[str, float] = {}
    t_last = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        walls[name] = now - t_last[0]
        t_last[0] = now

    # (a) config 7: a chunk is one replay of the compiled superstep's graph
    t0 = time.perf_counter()
    driver = rec.EpochDriver(m, config7(), n_ops=EPOCH_OPS, device=dev)
    build_s = time.perf_counter() - t0
    reset_launches()
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    driver.run_superstep(chunk, snapshot_every=chunk)  # warm-up, capture, one replay
    torch.cuda.synchronize()
    first_chunk_s = time.perf_counter() - t0
    reserved_delta = torch.cuda.memory_reserved() - reserved0
    prog = driver.compile_superstep()
    sup, sup_info = timed(lambda: driver.run_superstep(epochs, snapshot_every=chunk), epochs)
    pulls = -(-epochs // chunk)
    # the chunk pulls are a chunk's, not an epoch's: one copy back each
    sup_info.update(chunk_pulls=pulls,
                    host_syncs_per_epoch_less_pulls=(sup_info["host_syncs"] - pulls) / epochs)
    driver.run_staged(EPOCH_STAGED_WARM)
    torch.cuda.synchronize()
    stg, stg_info = timed(lambda: driver.run_staged(staged), staged)
    add(launch_counts())
    out["config7"] = {"build_s": build_s, "superstep": sup_info, "staged": stg_info,
                      "ratio": sup_info["epochs_per_s"] / stg_info["epochs_per_s"],
                      "graph": {**program_info(prog), "first_chunk_s": first_chunk_s,
                                "reserved_delta_bytes": reserved_delta}}
    lap("config7")

    # (b) the dirty walk, compaction auto and off, each through the graph,
    # the body run eagerly and the staged path
    tape = rec.compile_event_tape(rec.build_scenario(EPOCH_WALK, m), m)
    n_walk = int(np.ceil(float(tape.t.max()) / driver.dt)) + 8
    walks, walk_info, rungs, drivers, walk_graphs = {}, {}, {}, {}, {}
    for mode in ("auto", "off"):
        cfg = Config(env={})
        cfg.set("sparse_dirty_compaction", mode)
        d = rec.EpochDriver(m, rec.build_scenario(EPOCH_WALK, m), n_ops=EPOCH_OPS, config=cfg,
                            device=dev)
        runs = {"superstep": lambda d=d: d.run_superstep(n_walk),
                "eager": lambda d=d: d.compile_superstep().run_eager(n_walk),
                "staged": lambda d=d: d.run_staged(n_walk)}
        for how in ("superstep", "eager", "staged"):
            reset_launches()
            series, info = timed(runs[how], n_walk)
            info["launches"] = launch_counts()
            add(info["launches"])
            walks[(mode, how)] = series
            walk_info[f"{mode}/{how}"] = info
            if how != "staged":
                rungs[f"{mode}/{how}"] = d.rungs_taken
        rungs[mode] = {"compaction_enabled": d.compaction_enabled, "ladder": d._dirty_ladder,
                       "rungs_taken": d.rungs_taken}
        walk_graphs[mode] = program_info(d.compile_superstep())
        drivers[mode] = d
    ref = walks[("off", "staged")]
    diffs = {f"{mode}/{how}": s.diff(ref) for (mode, how), s in walks.items()}
    walk_k3 = sum(i["launches"].get("descend", 0) for i in walk_info.values())
    out["walk"] = {"scenario": EPOCH_WALK, "epochs": n_walk, "tape_rows": len(tape),
                   "dirty_epochs": int(ref.dirty.sum()),
                   "dirty_at": np.nonzero(ref.dirty)[0].tolist(), "runs": walk_info,
                   "ladder": rungs, "diffs": diffs, "k3_launches": walk_k3,
                   "graph": walk_graphs}
    out["launches"] = path
    lap("walk")

    # the checks, outside the counts
    one_chunk = driver.run_staged(chunk).diff(series_head(sup, chunk))
    out["config7"]["staged_vs_superstep_one_chunk"] = one_chunk
    out["config7"]["eager_vs_graph"] = prog.run_eager(EPOCH_TURN).diff(series_head(sup, EPOCH_TURN))
    lap("staged_check")

    def host_decided(n):  # the host-decided loop (the CPU's, and the card's before the graph)
        return driver._run_chunks(driver._advance_host, None, n)

    out["launch_split_config7"] = piece_launches(driver, lambda: host_decided(EPOCH_PROFILED))
    out["launch_split_config7"]["epochs"] = EPOCH_PROFILED
    out["host_ms_config7"] = piece_host_ms(driver, lambda: host_decided(EPOCH_TURN), EPOCH_TURN)
    # the graph's replays under the profiler: the card's busy share
    out["graph_profile_config7"] = piece_launches(driver,
                                                  lambda: driver.run_superstep(EPOCH_TURN))
    out["graph_profile_config7"]["epochs"] = EPOCH_TURN
    # a replayed chunk: no wrapper call, no read, no sync warning, no build
    with runtime_guard.track(sync_debug=True, check_launches=True) as g:
        driver.run_superstep(EPOCH_TURN, pull=False)
        torch.cuda.synchronize()
    out["config7"]["replay"] = {"calls": g.launch_counter.calls,
                                "host_reads": g.host_transfers,
                                "sync_warnings": g.transfer_counter.sync_warnings,
                                "builds": g.n_compiles}
    # the paths in turns, to read the rate's spread
    runs = {"graph": lambda n: driver.run_superstep(n), "eager": prog.run_eager,
            "host": host_decided, "staged": driver.run_staged}
    turns = []
    for how in ("graph", "eager", "host", "staged", "staged", "host", "eager", "graph"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[how](EPOCH_TURN)
        torch.cuda.synchronize()
        turns.append([how, EPOCH_TURN / (time.perf_counter() - t0)])
    out["config7"]["epochs_per_s_in_turns"] = turns
    out["config7"]["graph"].update(captures=prog.captures, replays=prog.replays)
    # each walk through its graph (captured by now), its eager body and
    # the staged path, in turns
    for mode, d in drivers.items():
        runs = {"graph": d.run_superstep, "eager": d.compile_superstep().run_eager,
                "staged": d.run_staged}
        turns = []
        for how in ("graph", "eager", "staged", "staged", "eager", "graph"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[how](n_walk)
            torch.cuda.synchronize()
            turns.append([how, n_walk / (time.perf_counter() - t0)])
        out["walk"]["graph"][mode]["epochs_per_s_in_turns"] = turns
    # the auto walk's first epochs, through its first dirty one
    d = drivers["auto"]
    n_prof = int(np.nonzero(ref.dirty)[0][0]) + 1
    out["launch_split_walk"] = piece_launches(
        d, lambda: d._run_chunks(d._advance_host, None, n_prof))
    out["launch_split_walk"].update(epochs=n_prof, dirty_epochs=int(ref.dirty[:n_prof].sum()))
    lap("profiles")

    # a host read in the epoch body stops the capture with an error
    n_small, pgs_small = small
    m_small = build_osdmap(n_small, pg_num=pgs_small, size=6, pool_kind="erasure")
    faulty = rec.EpochDriver(m_small, config7(), n_ops=EPOCH_SMALL_OPS, device=dev)
    core = faulty._traffic_core

    def reads(state, salt, cap):
        bool(state.pg_hist.any())
        return core(state, salt, cap)

    faulty._traffic_core = reads
    try:
        faulty.run_superstep(8)
        fault = "no error"
    except graphs.HostReadInCapture as e:
        fault = f"{type(e).__name__}: {e}"
    out["capture_fault"] = fault

    small_runs = [rec.EpochDriver(m_small, rec.build_scenario(EPOCH_WALK, m_small),
                                  n_ops=EPOCH_SMALL_OPS, device=d_).run_superstep(n_walk)
                  for d_ in (dev, torch.device("cpu"))]
    out["card_equals_cpu"] = {"osds": n_small, "pgs": pgs_small, "epochs": n_walk,
                              "dirty_epochs": int(small_runs[1].dirty.sum()),
                              "diff": small_runs[0].diff(small_runs[1])}
    lap("card_equals_cpu")
    out["walls_s"] = walls
    quiet = sup_info["dirty_epochs"] == 0
    replay = out["config7"]["replay"]
    out["gates"] = {
        "config7_quiet": quiet,
        "config7_one_sync_a_quiet_epoch": quiet and sup_info["host_syncs_per_epoch_less_pulls"] <= 1,
        "config7_staged_equals_superstep": one_chunk == [],
        "config7_eager_equals_graph": out["config7"]["eager_vs_graph"] == [],
        "config7_one_capture": prog.captures == 1 and prog.replays > pulls,
        "config7_replay_no_call_read_or_warning": (replay["calls"] == {}
                                                   and replay["host_reads"] == 0
                                                   and replay["sync_warnings"] == 0
                                                   and replay["builds"] == 0),
        "walk_graphs_one_capture": all(v["captures"] == 1 for v in walk_graphs.values()),
        "walk_rungs_equal": rungs["auto/superstep"] == rungs["auto/eager"] != [],
        "capture_fault_raises": fault.startswith("HostReadInCapture"),
        "walk_six_series_equal": all(v == [] for v in diffs.values()),
        "walk_dirty": int(ref.dirty.sum()) > 0,
        "walk_k3_launched": walk_k3 > 0,
        "walk_compacted": rungs["auto"]["compaction_enabled"],
        "card_equals_cpu": out["card_equals_cpu"]["diff"] == []
        and out["card_equals_cpu"]["dirty_epochs"] > 0,
    }
    return out


# phase fleet: BASELINE config 8 at bench/config8_fleet.py's settings
# (256 ssd-burst timelines over 256 epochs on a 32-OSD EC k=4 m=2 map),
# then the same fleet shape at config 7's full width
FLEET_OSDS, FLEET_PGS, FLEET_OPS = 32, 16, 32
FLEET_CLUSTERS, FLEET_EPOCHS = 256, 256
FLEET_SCENARIO = "ssd-burst"
FLEET_PANEL = ("ssd-steady", "ssd-burst", "ssd-skew")
FLEET_SEED = 0
FLEET_BOOT = 256
FLEET_SEQ = 2                   # lanes held against their own sequential runs
FLEET_PROFILED = 3              # config-8 epochs under torch.profiler for the split
FLEET_WIDE = (1024, 8192, 64)   # OSDs, PGs, ops a step: config 7's geometry
FLEET_WIDE_RUN = (32, 32)       # clusters, epochs
FLEET_SMALL = (4, 16)           # clusters, epochs of the card-vs-CPU replay
FLEET_RING = (64, 32)           # clusters, epochs of the recorder's graph-vs-host check
#: the host-decided fleet epoch's pieces (FleetDriver methods), each a span for the split
FLEET_PIECES = {"tape": ("_tape_apply",), "liveness": ("_live",),
                "peering": ("_peer_dirty",), "traffic": ("_traffic_apply",),
                "scrub": ("_scrub_due",), "row": ("_row",)}
#: DurabilityEstimate's bootstrap fields (f64 means reduced in another
#: order on the card); every other field is held exactly
DURABILITY_CI = ("mttdl_ci_lo_s", "mttdl_ci_hi_s", "availability_ci_lo", "availability_ci_hi",
                 "ttzd_ci_lo_s", "ttzd_ci_hi_s")

# phase divergent: config 6's --divergent pass (bench/config6_recovery.py)
# on config 4's map, as the port's other config-6 passes run
DIVERGENT_SCENARIO = "flap"
DIVERGENT_N_RANKS = 2
DIVERGENT_EPOCHS = 48
DIVERGENT_DELAY_MS = 2500
DIVERGENT_SEED = 6
DIVERGENT_SMALL = (64, 128)     # OSDs, PGs of the card-vs-CPU replay


def fleet_record(sizes: dict, rate: float, seq_cold: float, seq_warm: float, bitequal: bool,
                 same_bucket: bool, ftape, est, panel: list, host_reads: int) -> dict:
    """One JSON line of the reference's ``build_fleet_record`` schema
    (bench/config8_fleet.py), which ``python -m ceph_tpu_torch.cli.status
    fleet --bench-log FILE`` renders.  ``vs_baseline`` divides by the
    sequential rate of new ``EpochDriver``s, their build included (the
    port compiles nothing, so ``fleet_seq_includes_compile`` is false);
    ``fleet_same_bucket_zero_recompile`` holds the port's same-bucket
    check (a fleet of 255 equals the first 255 lanes of 256);
    ``host_transfers`` counts the host reads of a run of the cell's size
    (the runtime guard's)."""
    rec = {
        "metric": "fleet_epoch_rate_per_sec", "status": "ok", "value": round(rate),
        "unit": "cluster-epochs/s",
        "vs_baseline": round(rate / seq_cold, 2) if seq_cold else 0.0,
        "platform": "gpu", "fleet_scenario": FLEET_SCENARIO,
        "fleet_n_clusters": sizes["clusters"], "fleet_n_epochs": sizes["epochs"],
        "fleet_n_osds": sizes["osds"], "fleet_pg_num": sizes["pgs"],
        "fleet_n_ops": sizes["n_ops"],
        "fleet_pad": int(ftape.fleet_pad), "fleet_rows_pad": int(ftape.rows_pad),
        "fleet_seq_clusters_measured": FLEET_SEQ,
        "fleet_epoch_rate_per_sec": round(rate, 1),
        "fleet_seq_epoch_rate_per_sec": round(seq_cold, 2),
        "fleet_seq_epoch_rate_warm_per_sec": round(seq_warm, 1),
        "fleet_seq_includes_compile": False,
        "fleet_aggregate_speedup": round(rate / seq_cold, 2) if seq_cold else 0.0,
        "fleet_aggregate_speedup_warm": round(rate / seq_warm, 2) if seq_warm else 0.0,
        "fleet_bitequal": bool(bitequal), "fleet_same_bucket_zero_recompile": bool(same_bucket),
        "fleet_scenario_panel": panel, "n_compiles": 0, "n_compiles_first": 0,
        "host_transfers": int(host_reads),
    }
    rec.update(est.to_dict())
    return rec


def panel_entry(est) -> dict:
    """The per-scenario slice of a DurabilityEstimate the fleet panel
    renders (bench/config8_fleet.py's ``_panel_entry``)."""
    return {
        "scenario": est.scenario, "n_clusters": est.n_clusters,
        "survival_fraction": round(est.survival_fraction, 9), "n_lost": est.n_lost,
        "mttdl_s": round(est.mttdl_s, 3), "mttdl_ci_lo_s": round(est.mttdl_ci_lo_s, 3),
        "mttdl_ci_hi_s": round(est.mttdl_ci_hi_s, 3), "mttdl_censored": est.mttdl_censored,
        "availability_mean": round(est.availability_mean, 9),
        "ttzd_mean_s": round(est.ttzd_mean_s, 6), "worst_cluster": est.worst_cluster,
        "worst_availability": round(est.worst_availability, 9),
    }


def fleet_lanes_equal(fs, seqs) -> list:
    """The lanes of a FleetSeries that differ from their sequential runs."""
    return [[k, fs.cluster(k).diff(s)] for k, s in enumerate(seqs) if fs.cluster(k).diff(s)]


def fleet_program_info(fd) -> dict:
    """A fleet's compiled window: its captures and replays, and its
    graph's figures where it has one (the CPU runs the body eagerly)."""
    prog = fd.compile_fleet()
    g = prog.graph
    info = {"captures": prog.captures, "replays": prog.replays}
    if g is not None:
        info.update(capture_ms=g.capture_ms, nodes=g.nodes, conditional_nodes=g.cond_nodes,
                    conditional_bodies=len(g.bodies), pool_bytes=g.pool_bytes)
    return info


def fleet_rings_equal(a, b) -> bool:
    return (a is None) == (b is None) and (a is None or (
        torch.equal(a.ring.cpu(), b.ring.cpu()) and int(a.head) == int(b.head)))


def phase_fleet(dev, launch_counts, reset_launches, osds: int = FLEET_OSDS,
                pgs: int = FLEET_PGS, clusters: int = FLEET_CLUSTERS,
                epochs: int = FLEET_EPOCHS, wide=FLEET_WIDE, wide_run=FLEET_WIDE_RUN,
                small=FLEET_SMALL, profiled: int = FLEET_PROFILED,
                ring_run=FLEET_RING) -> dict:
    """Scenario fleets (``recovery/fleet.py::FleetDriver``) and Monte Carlo
    durability (``recovery/durability.py``): (a) BASELINE config 8 as
    ``bench/config8_fleet.py`` runs it — ``build_osdmap(osds, pgs, size=6,
    erasure)``, ``FleetDriver(m, seed=0, n_ops=32)``, ``clusters``
    ssd-burst timelines over ``epochs`` epochs — a run one replay of the
    compiled fleet's CUDA graph (captured by a warm run: its capture ms,
    nodes, conditional nodes and bodies, the memory it reserved), then a
    run timed with ``pull=False`` (cluster-epochs/s; its launches are the
    path's, K3 by the bodies' pass counters; the memo's peerings); (b)
    the same at config 7's width (``wide``, ``wide_run``).  Then the
    checks, outside the counts: a run of each size under the runtime
    guard (no wrapper call, host read, sync warning or build: config 8's
    host reads are its record's ``host_transfers``); the timed run's
    lanes and final state equal to the host-decided loop's
    (``path="host"``), the rates in turns; the first FLEET_SEQ lanes
    equal to new ``EpochDriver``s, to ``run_sequential`` through the
    tape program and to the host-decided sequential loop (timed: the
    sequential rates); a fleet of ``clusters - 1`` replayed in the same
    graph under the guard, equal to the first lanes; with the recorder on
    (``ring_run``: lanes, epochs) the per-lane ring and every lane of the
    graph equal to the host-decided loop's; durability for the headline
    and the panel's scenarios (the panel's fleets through the graph);
    launches an epoch by piece of the host-decided loop (torch.profiler
    over ``profiled`` epochs); and a fleet of ``small`` on the card and
    the CPU with the recorder on, every lane and the ring equal.  Returns
    the phase line and the fleet record."""
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.analysis import runtime_guard
    from ceph_tpu_torch.common.config import Config, global_config
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.recovery.checkpoint import diff_states

    out: dict = {"phase": "fleet", "osds": osds, "pgs": pgs, "size": 6, "n_ops": FLEET_OPS,
                 "clusters": clusters, "epochs": epochs, "scenario": FLEET_SCENARIO}
    walls: dict[str, float] = {}
    t_last = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        walls[name] = now - t_last[0]
        t_last[0] = now

    def timed_fleet(fd, tls, n, syncs=True):
        # the host syncs are counted in a run of their own (the sync-debug
        # mode costs host time); the launch counts start from 0 just
        # before the timed run, which runs with no instrumentation
        info: dict = {}
        if syncs:
            t0 = time.perf_counter()
            with count_syncs(info):
                fd.run_fleet(n, tls, pull=False)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            info.update(host_syncs_per_epoch=info["host_syncs"] / n,
                        counted_cluster_epochs_per_s=len(tls) * n / wall)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, rows = fd.run_fleet(n, tls, pull=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        info.update(wall_s=wall, cluster_epochs_per_s=len(tls) * n / wall,
                    epochs_per_s=n / wall, **{k: v for k, v in fd.stats.items()})
        return rows, info

    def against_host(fd, tls, n, fs, info):
        # the graph's series and final state (of the timed run) held
        # against the host-decided loop's, then both again in turns
        # (rates read within this run); the memo's counts beside the
        # host loop's
        info.update(fd.compile_fleet().peer_counts())
        state = fd.final_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = fd.run_fleet(n, tls, path="host")
        torch.cuda.synchronize()
        host_rate = len(tls) * n / (time.perf_counter() - t0)
        info["host_stats"] = dict(fd.stats)
        info["differ_host"] = fleet_lanes_equal(fs, [host.cluster(k) for k in range(len(tls))])
        info["state_differ_host"] = diff_states(state, fd.final_state)
        info["memo_equals_host"] = all(info[k] == fd.stats[k] for k in
                                       ("dirty_lane_epochs", "peered", "peer_reused"))
        info["cluster_epochs_per_s_in_turns"] = [["graph", info["cluster_epochs_per_s"]],
                                                 ["host", host_rate]]
        for how in ("host", "graph", "host", "graph"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fd.run_fleet(n, tls, pull=False, path=None if how == "graph" else how)
            torch.cuda.synchronize()
            info["cluster_epochs_per_s_in_turns"].append(
                [how, len(tls) * n / (time.perf_counter() - t0)])

    def replayed(fd, tls, n):
        # a replayed run: no wrapper call, no read, no sync warning, no build
        with runtime_guard.track(sync_debug=True, check_launches=dev.type == "cuda") as g:
            state, rows = fd.run_fleet(n, tls, pull=False)
            torch.cuda.synchronize()
        lc = g.launch_counter
        return {"calls": lc.calls, "host_reads": g.host_transfers,
                "sync_warnings": g.transfer_counter.sync_warnings, "builds": g.n_compiles,
                "launches_equal_replayed": lc.launches == lc.replays}, rows

    m = build_osdmap(osds, pg_num=pgs, size=6, pool_kind="erasure")
    fd = rec.FleetDriver(m, seed=FLEET_SEED, n_ops=FLEET_OPS, device=dev)
    tls = fd.sample(clusters, FLEET_SCENARIO)
    ftape = rec.stack_tapes([rec.compile_event_tape(tl, m) for tl in tls])
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    fd.run_fleet(epochs, tls, pull=False)  # warm: the warm-up, the capture, one replay
    torch.cuda.synchronize()
    graph = {**fleet_program_info(fd), "first_run_s": time.perf_counter() - t0,
             "reserved_over_first_run": torch.cuda.memory_reserved() - reserved0}
    lap("warm")
    rows, head = timed_fleet(fd, tls, epochs, syncs=False)
    path = launch_counts()
    head["k3_launches"] = path.get("descend", 0)
    head["graph"] = graph
    fs = rec.FleetSeries.from_device(rows, clusters)
    out["config8"] = head
    lap("config8")

    # (b) full width
    n_w, pg_w, ops_w = wide
    c_w, e_w = wide_run
    m_w = build_osdmap(n_w, pg_num=pg_w, size=6, pool_kind="erasure")
    fd_w = rec.FleetDriver(m_w, seed=FLEET_SEED, n_ops=ops_w, device=dev)
    tls_w = fd_w.sample(c_w, FLEET_SCENARIO)
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    fd_w.run_fleet(e_w, tls_w, pull=False)
    torch.cuda.synchronize()
    graph_w = {**fleet_program_info(fd_w), "first_run_s": time.perf_counter() - t0,
               "reserved_over_first_run": torch.cuda.memory_reserved() - reserved0}
    rows_w, wide_info = timed_fleet(fd_w, tls_w, e_w)
    wide_launches = launch_counts()
    for kname, v in wide_launches.items():
        path[kname] = path.get(kname, 0) + v
    wide_info.update(osds=n_w, pgs=pg_w, n_ops=ops_w, clusters=c_w, epochs=e_w,
                     k3_launches=wide_launches.get("descend", 0), graph=graph_w)
    fs_w = rec.FleetSeries.from_device(rows_w, c_w)
    out["wide"] = wide_info
    out["launches"] = path
    lap("wide")

    # the checks, outside the counts: a run of each size under the guard
    # (config 8's host reads are its record's host_transfers), then each
    # against the host-decided loop
    head["replay"] = replayed(fd, tls, epochs)[0]
    head["host_reads"] = head["replay"]["host_reads"]
    wide_info["replay"] = replayed(fd_w, tls_w, e_w)[0]
    against_host(fd, tls, epochs, fs, head)
    against_host(fd_w, tls_w, e_w, fs_w, wide_info)
    head["graph"].update(captures=fd.compile_fleet().captures,
                         replays=fd.compile_fleet().replays)
    wide_info["graph"].update(captures=fd_w.compile_fleet().captures,
                              replays=fd_w.compile_fleet().replays)
    lap("against_host")
    t0 = time.perf_counter()
    cold = [rec.EpochDriver(m, tls[k], seed=FLEET_SEED + k, n_ops=FLEET_OPS,
                            device=dev).run_superstep(epochs) for k in range(FLEET_SEQ)]
    torch.cuda.synchronize()
    seq_cold = FLEET_SEQ * epochs / (time.perf_counter() - t0)
    fd.run_sequential(epochs, tls[:FLEET_SEQ])  # the tape program's capture
    t0 = time.perf_counter()
    warm = fd.run_sequential(epochs, tls[:FLEET_SEQ])
    torch.cuda.synchronize()
    seq_warm = FLEET_SEQ * epochs / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    seq_host = fd.run_sequential(epochs, tls[:FLEET_SEQ], path="host")
    torch.cuda.synchronize()
    seq_host_rate = FLEET_SEQ * epochs / (time.perf_counter() - t0)
    tape_prog = fd.driver.compile_tape_program()
    bad = fleet_lanes_equal(fs, cold) + fleet_lanes_equal(fs, warm)
    seq_bad = [[k, warm[k].diff(seq_host[k])] for k in range(FLEET_SEQ)
               if warm[k].diff(seq_host[k])]
    out["sequential"] = {"lanes": FLEET_SEQ, "cold_epochs_per_s": seq_cold,
                         "warm_epochs_per_s": seq_warm, "host_decided_epochs_per_s": seq_host_rate,
                         "differ": bad, "program_differ_host": seq_bad,
                         "tape_program": program_info(tape_prog)}
    lap("sequential")
    # the fleet of 255 replayed in the same graph under the guard
    out["one_less"], rows_less = replayed(fd, tls[:clusters - 1], epochs)
    fs_less = rec.FleetSeries.from_device(rows_less, clusters - 1)
    less_bad = [k for k in range(clusters - 1) if fs_less.cluster(k).diff(fs.cluster(k))]
    out["one_less"].update(clusters=clusters - 1, epochs=epochs, fleet_pad=rec.stack_tapes(
        [rec.compile_event_tape(tl, m) for tl in tls[:clusters - 1]]).fleet_pad,
        differ=less_bad, captures=fd.compile_fleet().captures)
    lap("one_less")
    wide_cold = [rec.EpochDriver(m_w, tls_w[k], seed=FLEET_SEED + k, n_ops=ops_w,
                                 device=dev).run_superstep(e_w) for k in range(FLEET_SEQ)]
    out["wide"]["differ"] = fleet_lanes_equal(fs_w, wide_cold)
    lap("wide_sequential")

    # the per-lane ring: the graph against the host-decided loop
    c_r, e_r = ring_run
    cfg_r = Config(env={})
    cfg_r.set("flight_recorder", "on")
    fd_r = rec.FleetDriver(m, seed=FLEET_SEED, n_ops=FLEET_OPS, config=cfg_r, device=dev)
    tls_r = tls[:c_r]
    g_r = fd_r.run_fleet(e_r, tls_r)
    ring_g, state_g = fd_r.flight, fd_r.final_state
    h_r = fd_r.run_fleet(e_r, tls_r, path="host")
    out["ring"] = {"clusters": c_r, "epochs": e_r,
                   "differ": [k for k in range(c_r) if g_r.cluster(k).diff(h_r.cluster(k))],
                   # the recorder changes no lane: the first lanes and epochs of config 8's
                   "differ_unrecorded": [k for k in range(c_r) if g_r.cluster(k).diff(
                       series_head(fs.cluster(k), e_r))],
                   "ring_equal": fleet_rings_equal(ring_g, fd_r.flight),
                   "state_differ": diff_states(state_g, fd_r.final_state),
                   "head": int(ring_g.head), "graph": fleet_program_info(fd_r)}
    lap("ring")

    down_out = float(global_config().get("mon_osd_down_out_interval"))

    def estimate(series, scenario, device=dev, indices=None):
        return rec.estimate_durability(
            series, dt=fd.driver.dt, scenario=scenario, seed=FLEET_SEED, n_boot=FLEET_BOOT,
            codec="reed-solomon", ec_k=4, ec_m=2, placement="crush",
            down_out_interval_s=down_out, indices=indices, device=device)

    def against_cpu(series, scenario, est) -> list:
        # the card's reduction held against the CPU's on the CPU
        # generator's resample indices: the point fields exact (integer
        # sums, one f64 divide, the host's means), the CI at rtol 1e-12
        # (f64 means that reduce in another order)
        idx = rec.durability.bootstrap_indices(FLEET_SEED, FLEET_BOOT, series.n_clusters, "cpu")
        card, cpu = estimate(series, scenario, dev, idx), estimate(series, scenario, "cpu", idx)
        bad = [f.name for f in dataclasses.fields(cpu)
               if f.name not in DURABILITY_CI and getattr(card, f.name) != getattr(cpu, f.name)]
        bad += [f.name for f in dataclasses.fields(est)
                if f.name not in DURABILITY_CI and getattr(est, f.name) != getattr(cpu, f.name)]
        return bad + [f for f in DURABILITY_CI
                      if not np.isclose(getattr(card, f), getattr(cpu, f), rtol=1e-12, atol=0)]

    t0 = time.perf_counter()
    est = estimate(fs, FLEET_SCENARIO)
    est_ms = (time.perf_counter() - t0) * 1e3
    panel, panel_info = [], {}
    dur_cpu = {FLEET_SCENARIO: against_cpu(fs, FLEET_SCENARIO, est)}
    for sc in FLEET_PANEL:
        if sc == FLEET_SCENARIO:
            panel.append(panel_entry(est))
            continue
        p_rows, p_info = timed_fleet(fd, fd.sample(clusters, sc), epochs, syncs=False)
        panel_info[sc] = p_info
        p_fs = rec.FleetSeries.from_device(p_rows, clusters)
        p_est = estimate(p_fs, sc)
        dur_cpu[sc] = against_cpu(p_fs, sc, p_est)
        panel.append(panel_entry(p_est))
    out["durability"] = {"estimate_ms": est_ms, **est.to_dict()}
    out["durability_card_vs_cpu_differ"] = dur_cpu
    out["panel"] = {"runs": panel_info, "rows": panel,
                    "captures": fd.compile_fleet().captures}
    lap("durability")

    # the host-decided loop's pieces (the graph's body has no host spans)
    split = piece_launches(fd, lambda: fd.run_fleet(profiled, tls, pull=False, path="host"),
                           FLEET_PIECES)
    split["stats"] = dict(fd.stats)
    split["epochs"] = profiled
    split["per_epoch"] = {p: {k: v / profiled for k, v in c.items()}
                          for p, c in split["split"].items()}
    out["launch_split"] = split
    lap("profile")

    c_s, e_s = small
    small_runs, small_rings = [], []
    for d_ in (dev, torch.device("cpu")):
        fd_s = rec.FleetDriver(m, seed=FLEET_SEED, n_ops=FLEET_OPS, config=cfg_r, device=d_)
        small_runs.append(fd_s.run_fleet(e_s, tls[:c_s]))
        small_rings.append(fd_s.flight)
    out["card_equals_cpu"] = {
        "clusters": c_s, "epochs": e_s, "dirty_lane_epochs": int(small_runs[1].dirty.sum()),
        "differ": [k for k in range(c_s)
                   if small_runs[0].cluster(k).diff(small_runs[1].cluster(k))],
        "ring_equal": fleet_rings_equal(*small_rings)}
    lap("card_equals_cpu")
    out["walls_s"] = walls
    record = fleet_record(out, head["cluster_epochs_per_s"], seq_cold, seq_warm, not bad,
                          not less_bad and out["one_less"]["fleet_pad"] == ftape.fleet_pad,
                          ftape, est, panel, head["host_reads"])
    zero = {"calls": {}, "host_reads": 0, "sync_warnings": 0, "builds": 0,
            "launches_equal_replayed": True}
    out["gates"] = {
        "lanes_equal_sequential": not bad,
        "sequential_program_equals_host_decided": not seq_bad,
        "one_less_equal": not less_bad,
        "one_less_same_bucket": out["one_less"]["fleet_pad"] == ftape.fleet_pad,
        "one_less_reads_nothing": {k: out["one_less"][k] for k in zero} == zero,
        "config8_dirty": int(fs.dirty.sum()) > 0,
        "config8_k3_launched": head["k3_launches"] > 0,
        "config8_graph_equals_host_decided": not head["differ_host"]
        and not head["state_differ_host"] and head["memo_equals_host"],
        "config8_replay_reads_nothing": head["replay"] == zero,
        "config8_one_capture": graph.get("captures") == 1
        and head["graph"]["captures"] == 1 and out["one_less"]["captures"] == 1,
        "wide_lanes_equal_sequential": not out["wide"]["differ"],
        "wide_k3_launched": wide_info["k3_launches"] > 0,
        "wide_graph_equals_host_decided": not wide_info["differ_host"]
        and not wide_info["state_differ_host"] and wide_info["memo_equals_host"],
        "wide_replay_reads_nothing": wide_info["replay"] == zero,
        "ring_graph_equals_host_decided": not out["ring"]["differ"]
        and out["ring"]["ring_equal"] and not out["ring"]["state_differ"]
        and not out["ring"]["differ_unrecorded"],
        "durability_finite": all(np.isfinite([est.mttdl_s, est.mttdl_ci_lo_s,
                                              est.mttdl_ci_hi_s])),
        "durability_card_equals_cpu": not any(dur_cpu.values()),
        "card_equals_cpu": not out["card_equals_cpu"]["differ"]
        and out["card_equals_cpu"]["ring_equal"]
        and out["card_equals_cpu"]["dirty_lane_epochs"] > 0,
    }
    return out, record


def divergent_record(res, health, report, rate: float, host_syncs: int, states) -> dict:
    """One JSON line of the reference's ``build_divergent_record`` schema
    (bench/config6_recovery.py), which ``python -m
    ceph_tpu_torch.cli.status ranks --bench-log FILE`` renders."""
    from ceph_tpu_torch.recovery import view_fingerprint

    d2c = res.detection_to_convergence_rounds()
    return {
        "metric": "divergent_detect_to_converge_rounds",
        "value": 0 if d2c is None else int(d2c), "unit": "rounds", "platform": "gpu",
        "n_compiles": 0, "n_compiles_first": 0, "host_transfers": int(host_syncs),
        "divergent_scenario": DIVERGENT_SCENARIO, "divergent_n_ranks": len(states),
        "divergent_n_epochs": int(res.total_steps), "divergent_rounds": len(res.rounds),
        "divergent_converged": bool(res.converged),
        "divergent_laggy_ranks": [int(r) for r in res.laggy],
        "divergent_stalled": bool(res.laggy), "divergent_round_rate_per_sec": round(rate, 3),
        "divergent_retries_total": int(sum(r.retries for r in res.rounds)),
        "divergent_backoff_epochs_total": int(sum(r.backoff_epochs for r in res.rounds)),
        "divergent_rank_panel": [
            {"rank": r, "step": int(res.rounds[-1].steps[r]), "epoch": int(s.epoch),
             "fingerprint": int(view_fingerprint(s))} for r, s in enumerate(states)],
        "divergent_health_status": report.status,
        "divergent_slo_checks": {c.name: c.status for c in report.checks},
        "divergent_rank_series": health.rank_series(),
    }


def divergent_driver(m, dev, health=None, path=None):
    """Config 6's --divergent pass's driver on ``m``: the flap scenario,
    rank 1 seeing every event 2.5 s late from t = 0.05; ``path`` picks
    how each rank's epochs run (``superstep.PATHS``)."""
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.recovery.failure import parse_spec

    base = rec.build_scenario(DIVERGENT_SCENARIO, m)
    skew = parse_spec(f"rankdelay:1.{DIVERGENT_DELAY_MS}")
    tl = rec.ChaosTimeline(list(base.events()) + [rec.ChaosEvent(0.05, (skew,))])
    return rec.DivergentDriver(m, tl, DIVERGENT_N_RANKS, config=Config(env={}),
                               seed=DIVERGENT_SEED, health=health, device=dev, path=path)


def divergent_run(m, dev, n_epochs: int = DIVERGENT_EPOCHS, path=None):
    """Config 6's --divergent pass on ``m`` (its size, k = 8 m = 3):
    ``(driver, result, health, report, seconds)``."""
    from ceph_tpu_torch.obs import HealthTimeline, SLOSpec, evaluate

    health = HealthTimeline(lambda: 0.0, k=8, device=dev)
    d = divergent_driver(m, dev, health=health, path=path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = d.run(n_epochs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return d, res, health, evaluate(health, SLOSpec(max_rank_stall_rounds=1)), seconds


def divergent_differ(r0, r1) -> list:
    """The rounds, and the lanes of the views and the merged view, where
    two divergent results differ."""
    def lanes(state):
        flat = {}
        for f in dataclasses.fields(state):
            v = getattr(state, f.name)
            if f.name == "pool":
                flat.update({"pool." + g.name: getattr(v, g.name).cpu()
                             for g in dataclasses.fields(v)})
            elif v is not None:
                flat[f.name] = v.cpu()
        return flat

    differ = [r.round for r, q in zip(r0.rounds, r1.rounds)
              if (r.steps, r.epochs, r.fingerprints, r.converged, r.retries) != (
                  q.steps, q.epochs, q.fingerprints, q.converged, q.retries)]
    if len(r0.rounds) != len(r1.rounds):
        differ.append("rounds")
    for k, (a, b) in enumerate(zip(r0.states + [r0.merged], r1.states + [r1.merged])):
        la, lb = lanes(a), lanes(b)
        differ += [f"view{k}:{n}" for n in la if not torch.equal(la[n], lb[n])]
    return differ


def phase_divergent(dev, launch_counts, reset_launches, n_osds: int = RECOVERY_OSDS,
                    pg_num: int = RECOVERY_PGS, small=DIVERGENT_SMALL) -> dict:
    """Config 6's ``--divergent`` pass (``recovery/reconcile.py::
    DivergentDriver``): two rank views of the flap scenario, rank 1 seeing
    every event 2.5 s late from t = 0.05, 48 epochs, seed 6, a
    HealthTimeline graded by ``SLOSpec(max_rank_stall_rounds=1)``, on
    ``build_osdmap(n_osds, pg_num, size=11, erasure)``, each rank's
    advance one ``load`` of its tape and one replay a chunk of the
    template's tape program (its capture ms, nodes and memory); the run
    is the path's launch counts.  Gates: converged, a
    detection-to-convergence latency, the rank views' fingerprints equal
    at the end and equal to the unskewed reference's, the run equal to
    the host-decided one (every round, view and the merged view, the
    detection-to-convergence rounds; the two in turns: rounds/s).  Then
    the pass at ``small`` size on the card and the CPU: every round and
    every lane of every view equal.  Returns the phase line and the
    divergent record."""
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.recovery import view_fingerprint

    m = build_osdmap(n_osds, pg_num=pg_num, size=11, pool_kind="erasure")
    info: dict = {}
    reset_launches()
    reserved0 = torch.cuda.memory_reserved()
    with count_syncs(info):
        d, res, health, report, seconds = divergent_run(m, dev)
    launches = launch_counts()
    graph = {**program_info(d.driver.compile_tape_program()),
             "reserved_over_run": torch.cuda.memory_reserved() - reserved0}
    dh, res_h, _h, _r, seconds_h = divergent_run(m, dev, path="host")
    host_differ = divergent_differ(res, res_h)
    host_d2c = res_h.detection_to_convergence_rounds()
    turns = [["graph", len(res.rounds) / seconds], ["host", len(res_h.rounds) / seconds_h]]
    turns.append(["host", len(res_h.rounds) / divergent_run(m, dev, path="host")[-1]])
    turns.append(["graph", len(res.rounds) / divergent_run(m, dev)[-1]])
    fps = [view_fingerprint(s) for s in res.states]
    ref_fp = view_fingerprint(d.reference_state(res.total_steps))
    rate = len(res.rounds) / seconds
    d2c = res.detection_to_convergence_rounds()
    out = {"phase": "divergent", "osds": n_osds, "pgs": pg_num, "size": 11,
           "scenario": DIVERGENT_SCENARIO, "ranks": DIVERGENT_N_RANKS,
           "epochs": DIVERGENT_EPOCHS, "seconds": seconds, "rounds": len(res.rounds),
           "rounds_per_s": rate, "epochs_per_s": res.total_steps * DIVERGENT_N_RANKS / seconds,
           "host_syncs": info["host_syncs"], "total_steps": res.total_steps,
           "detect_to_converge_rounds": d2c, "converged": res.converged,
           "round_verdicts": [[r.round, r.target_step, list(r.steps), list(r.epochs),
                               r.converged, r.retries] for r in res.rounds],
           "fingerprints": fps, "reference_fingerprint": ref_fp,
           "slo": report.status, "launches": launches,
           "k3_launches": launches.get("descend", 0), "graph": graph,
           "host_decided": {"seconds": seconds_h, "rounds": len(res_h.rounds),
                            "detect_to_converge_rounds": host_d2c, "differ": host_differ},
           "rounds_per_s_in_turns": turns}
    n_s, pg_s = small
    m_s = build_osdmap(n_s, pg_num=pg_s, size=11, pool_kind="erasure")
    runs = [divergent_run(m_s, d_) for d_ in (dev, torch.device("cpu"))]
    (_d0, r0, *_), (_d1, r1, *_) = runs
    differ = divergent_differ(r0, r1)
    out["card_equals_cpu"] = {"osds": n_s, "pgs": pg_s, "rounds": len(r1.rounds),
                              "detect_to_converge_rounds": r1.detection_to_convergence_rounds(),
                              "differ": differ}
    out["gates"] = {
        "converged": bool(res.converged),
        "detected": d2c is not None,
        "fingerprints_agree": len(set(fps)) == 1 and fps[0] == ref_fp,
        "k3_launched": out["k3_launches"] > 0,
        "graph_equals_host_decided": not host_differ and host_d2c == d2c
        and (d.path, dh.path) == ("graph", "host"),
        "tape_program_replayed": graph.get("captures") == 1 and graph["replays"] > 0,
        "card_equals_cpu": not differ and len(r0.rounds) == len(r1.rounds),
    }
    return out, divergent_record(res, health, report, rate, info["host_syncs"], res.states)


# phase online_kernel: K9 (the stripe buffer's write loop) at BASELINE
# config 10's full width; phase writepath: config 10 itself
WP_OSDS, WP_PGS, WP_OPS = 1024, 8192, 256   # config 7's map, 256 ops a step
WP_SETS, WP_WAYS, WP_GROUPS, WP_STRIPES = 1024, 4, 64, 4
# the write path's codec on that pool: k = min_size = 5, m = 1, so
# default_bitmatrix picks cauchy-good w=8; 8-byte packets and 64 groups
# make 4,096-byte chunks, Ceph's default stripe unit
WP_K, WP_M, WP_W = 5, 1, 8
WP_EPOCHS = 128
WP_SCENARIO = "flap"
WP_MIXES = ("ssd-steady", "ssd-burst", "ssd-skew")
WP_SEED = 0
WP_GATE_UPDATES = 64             # delta updates a family of the writepath_bitequal gate
WP_SHORT = 32                    # epochs of the bare, second-cap and flight-on comparisons
WP_TURN = 32                     # epochs a run of the in-turns rates and the graph's profile
WP_PROFILED = 4                  # epochs under torch.profiler for the split
WP_SMALL = (64, 128, 64, 4, 8)   # OSDs, PGs, sets, ways, groups: bench/config10_online_ec.py's
WP_BATCH = 256                   # K9's timed batch: config 10's power-of-two bucket of 256 ops
WP_WARM = 8                      # random batches absorbed before K9 is timed
HASH_OPS = 110                   # 32-bit operations of one crush_hash32_2 (3 mixes of 36, 2 xors)

# phase checkpoint: BASELINE config 9 (bench/config9_checkpoint.py) on
# config 7's map
CKPT_OPS, CKPT_EPOCHS, CKPT_EVERY = 256, 256, 16
CKPT_GRID = (16, 64)             # the overhead panel's snapshot intervals
CKPT_SCENARIO = "flap"
CKPT_HOST_CRC_BYTES = 64 * 1024  # lanes the host crc32c is timed over: whole lanes past this
CKPT_CRASHBOX = (32, 16, 8, 2)  # OSDs, PGs, epochs, interval of the SIGKILL'd child
CKPT_FLEET = (256, 64, 16)       # lanes, epochs, interval at config 8's settings
CKPT_CARD_CPU = (64, 128, 32, 8)  # OSDs, PGs, epochs, interval of the card-to-CPU restore
#: more keys of the crash child's config (none: it runs on the card)
CRASHBOX_CFG: dict = {}


def online_buffer(dev, n_sets: int, ways: int, words: int, warm: int, seed: int):
    """A stripe buffer of ``n_sets`` x ``ways`` slots (the write path's
    codec, WP_K + WP_M, ``words`` u32 words a row) on ``dev`` with
    ``warm`` random batches of
    WP_BATCH absorbed through the write path's step (K9, K6, the commit), and the
    codec's full encoder."""
    from ceph_tpu_torch.ec import online
    from ceph_tpu_torch.testing import online_edges
    from ceph_tpu_torch.workload.writepath import default_bitmatrix

    bits, w = default_bitmatrix(WP_K, WP_M)
    enc = online.ParityDeltaEngine(bits, w=w, device=dev).full_encoder()
    buf = online.empty_stripe_buffer(n_sets, ways, WP_K * w, WP_M * w, words, device=dev)
    for i in range(warm):
        b = online_edges.random_batch(n_sets, ways, WP_K, WP_BATCH, seed + i)
        buf, _ = online.stripe_buffer_step(buf, enc.table, enc.schedule.n_out, WP_K, WP_W,
                                           *online_edges.to_device(b, dev))
    return buf, enc


def absorb_writes(buf, batch: dict) -> list[tuple[int, bool, bool, int]]:
    """A host replay of K9's lookups on ``buf`` before the call (its keys
    and LRU ticks alone: the first equal key hits, else the first least
    tick is the victim): ``(slot, install, full, chunk)`` for each valid
    write of ``batch`` in order."""
    from ceph_tpu_torch.ec import online

    n_sets, ways = (int(v) for v in buf.keys.shape)
    keys, lru, tick = buf.keys.tolist(), buf.lru.tolist(), int(buf.tick)
    sets = online.set_index(torch.from_numpy(batch["keys"]), n_sets).tolist()
    out = []
    for s, key, chunk, full, valid in zip(sets, batch["keys"].tolist(),
                                          batch["chunks"].tolist(), batch["fulls"].tolist(),
                                          batch["valid"].tolist()):
        if not valid:
            continue
        install = key not in keys[s]
        way = lru[s].index(min(lru[s])) if install else keys[s].index(key)
        keys[s][way], lru[s][way] = key, tick
        tick += 1
        out.append((s * ways + way, install, bool(full), int(chunk)))
    return out


def absorb_bytes_ops(buf, batch: dict, row: dict) -> tuple[int, int, int]:
    """What one K9 call must move and compute on this run's data under
    its contract (Δdata only for the touched slots), from a replay of its
    lookups (``absorb_writes``; held against the kernel's ``row``).
    Bytes: the compact Δdata and ``slot_of`` written (every batch lane's
    entry); a slot that takes an install or a full write has its data
    and parity written (nothing of it read); a slot that takes only
    small hits has each chunk's rows read and written once; the batch
    read; the touched sets' keys, ticks and masks read and written.
    Operations: one set hash a lane; one content hash a word of a write's
    payload (a full write's k chunks, a small write's one) and of an
    install's base rows, unless that install's write is a full one,
    which overwrites them.  Returns ``(bytes, ops, longest per-set
    chain of dependent writes)``."""
    n_sets, ways, kw, words = (int(v) for v in buf.data.shape)
    mw = int(buf.parity.shape[2])
    w = WP_W
    writes = absorb_writes(buf, batch)
    replay = {"hits": sum(not i for _, i, _, _ in writes),
              "misses": sum(i for _, i, _, _ in writes),
              "full_writes": sum(f for _, _, f, _ in writes)}
    if any(replay[k] != row[k] for k in replay):
        raise AssertionError(f"K9's bound: the replay {replay} disagrees with its row {row}")
    whole, chunks = set(), {}
    for slot, install, full, chunk in writes:
        if install or full:
            whole.add(slot)
        else:
            chunks.setdefault(slot, set()).add(chunk)
    small_rows = sum(len(c) for slot, c in chunks.items() if slot not in whole)
    n_sets_t = len({slot // ways for slot, _, _, _ in writes})
    B = len(batch["keys"])
    nbytes = (4 * kw * words * B + 4 * B + 4 * (kw + mw) * words * len(whole)
              + 2 * 4 * w * words * small_rows + 14 * B + 2 * 12 * ways * n_sets_t)
    hashes = B + sum((kw if full else w) * words + (kw * words if install and not full else 0)
                     for _, install, full, _ in writes)
    sets = [slot // ways for slot, _, _, _ in writes]
    chain = int(np.bincount(sets, minlength=n_sets).max()) if sets else 0
    return nbytes, hashes * HASH_OPS, chain


def kernel_device_ms(fn, setup, kernel: str = "", reps: int = 5) -> float | None:
    """Device milliseconds a call of the kernels whose name holds
    ``kernel`` (every kernel by default), over ``reps`` calls of ``fn``
    in one torch.profiler session, each on its own inputs from
    ``setup()``, all made before the session: the kernels alone, without
    the wrappers' host work that a CUDA-event time holds.  A session
    that comes back without the kernels' device events (seen on the
    card's machine) is taken again, at most twice; None (not measured)
    if none of the three had them."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        xs = [setup() for _ in range(reps)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for x in xs:
                fn(x)
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key)
        if us > 0:
            return us / reps / 1e3
    return None


def absorb_call(fn, lanes):
    """``fn`` (K9 or a plain version) on a buffer's lanes and a batch."""
    return lambda b: fn(b.keys, b.data, b.parity, b.dirty, b.lru, b.tick, *lanes, WP_K, WP_W)


def phase_online_kernel(int_rate: float, dev, n_sets: int = WP_SETS, ways: int = WP_WAYS,
                        words: int = WP_GROUPS * 2, warm: int = WP_WARM) -> dict:
    """K9 (``stripe_absorb``, ``csrc/online.cu``) against its plain
    version (``stripe_absorb_plain``) on the card at config 10's full
    width (1024 sets x 4 ways, 4,096-byte chunks of cauchy-good k=5 m=1
    w=8: 128 words a row), a buffer warmed by WP_WARM random batches and
    one random batch of WP_BATCH writes: the buffer lanes (both update
    them in place, so each side and each timed call gets its own clone,
    made before the call and outside its timed window), the compact
    Δdata, ``slot_of``, the tick and the counter row bit for bit, both
    timed, the bound (bytes over HBM rate or hash operations over the
    int32 rate, the larger), the longest per-set chain; K9's commit
    (``stripe_commit``) against ``stripe_commit_plain`` on phase 2's
    output the same way; then K9's edges (``testing/online_edges.py``:
    an eviction chain in one set, all full, all misses on a cold buffer,
    invalid lanes between valid ones, a key evicted and hit again,
    batches of 1 and 512, two cancelling writes to a resident slot) at
    the same width; and phase 2's K6 launch at the compact shape ([kw,
    batch x words]) and at the full-width shape it had before ([kw, sets
    x ways x words], the same Δdata expanded)."""
    from ceph_tpu_torch.ec import kernels as ec_kernels, online
    from ceph_tpu_torch.testing import online_edges

    buf, enc = online_buffer(dev, n_sets, ways, words, warm, SEED)
    batch = online_edges.random_batch(n_sets, ways, WP_K, WP_BATCH, SEED + 100)
    lanes = online_edges.to_device(batch, dev)
    kernel, plain = (absorb_call(f, lanes) for f in (online.stripe_absorb,
                                                      online.stripe_absorb_plain))
    got = kernel(buf.clone())
    row = dict(zip(online.WP_LANES, got[-1].tolist()))
    nbytes, ops, chain = absorb_bytes_ops(buf, batch, row)
    rec = kernel_record("stripe_absorb",
                        "ceph_tpu/ec/online.py:199 stripe_buffer_step phase 1 (an XLA "
                        "fori_loop, :277-282; not a pl.pallas_call site)",
                        kernel, plain, nbytes, ops, int_rate, plain_reps=0, fresh=buf.clone)
    rec.update(shape=f"{n_sets} sets x {ways} ways x [{WP_K * WP_W}, {words}] words, "
               f"batch {WP_BATCH}", longest_set_chain=chain, row=row,
               touched_entries=int((got[7] >= 0).sum()),
               device_ms=kernel_device_ms(kernel, buf.clone, "stripe_absorb_kernel"))
    # the commit on phase 2's output, on K9's parity, totals and tick: each
    # owned entry's Δparity into its slot's parity, the row into the
    # totals, the new tick; each call on its own clones
    tick, ddata, slot_of, wrow = got[5:]
    mw = int(buf.parity.shape[2])
    dpar = ec_kernels.schedule_apply(enc.table, ddata, mw)
    n_own = int((slot_of >= 0).sum())
    commit_bytes = (3 * 4 * mw * words * n_own + 4 * WP_BATCH + 3 * 8 * len(online.WP_LANES)
                    + 2 * 4)
    commit_in = lambda: (got[2].clone(), buf.totals.clone(), buf.tick.clone())

    def committed(fn):
        def call(x):
            parity, totals, old_tick = x
            fn(parity, dpar, slot_of, wrow, totals, old_tick, tick)
            return x
        return call

    commit = kernel_record(
        "stripe_commit", "ceph_tpu/ec/online.py:291 stripe_buffer_step phase 2's XOR into "
        "parity and :299's totals add (XLA ops; not a pl.pallas_call site)",
        committed(online.stripe_commit), committed(online.stripe_commit_plain),
        commit_bytes, mw * words * n_own, int_rate, fresh=commit_in)
    commit.update(shape=f"{n_own} owned entries of {WP_BATCH} x [{mw}, {words}] words",
                  device_ms=kernel_device_ms(committed(online.stripe_commit), commit_in,
                                             "stripe_commit_kernel"))
    edges = []
    resident = online_edges.resident_key(buf.keys)
    for name, b, cold in online_edges.edge_batches(n_sets, ways, WP_K, seed=SEED,
                                                   resident=resident):
        base = (online.empty_stripe_buffer(n_sets, ways, WP_K * WP_W, WP_M * WP_W, words,
                                           device=dev) if cold else buf)
        elanes = online_edges.to_device(b, dev)
        g = absorb_call(online.stripe_absorb, elanes)(base.clone())
        p = absorb_call(online.stripe_absorb_plain, elanes)(base.clone())
        edges.append({"case": name, "writes": int(b["valid"].sum()), "cold": cold,
                      "bit_equal": all(compare(x, y)[0] for x, y in zip(g, p)),
                      "row": g[-1].tolist()})
    wide = online.expand_ddata(ddata, slot_of, n_sets * ways, words)
    k6 = {}
    for key, dd in (("compact", ddata), ("full_width", wide)):
        k6_bytes = dd.numel() * 4 + mw * dd.shape[1] * 4
        k6[key] = {"shape": list(dd.shape), "ms": time_ms(
            lambda: ec_kernels.schedule_apply(enc.table, dd, mw)),
            "device_ms": kernel_device_ms(lambda _x: ec_kernels.schedule_apply(enc.table, dd, mw),
                                          lambda: None, "xor_program"),
            "bound_ms": bound_ms(k6_bytes, enc.schedule.n_steps * dd.shape[1], int_rate)[0]}
    return {"phase": "online_kernel", "results": [rec, commit], "edges": edges,
            "k6_phase2": k6}


def checkpoint_record(epochs, bandwidth, write_s, snap_bytes, n_snaps, load_s, replay_s,
                      bitequal, torn_ok, overhead_panel, headline_overhead) -> dict:
    """The reference's config-9 record (``bench/config9_checkpoint.py``'s
    ``build_checkpoint_record``), for ``cli/status.py checkpoint``."""
    return {
        "metric": "checkpoint_write_bandwidth_bps", "status": "ok",
        "value": round(bandwidth), "unit": "B/s", "platform": "gpu",
        "checkpoint_scenario": CKPT_SCENARIO, "checkpoint_n_epochs": int(epochs),
        "checkpoint_snapshot_every": CKPT_EVERY, "checkpoint_snapshot_bytes": int(snap_bytes),
        "checkpoint_n_snapshots": int(n_snaps),
        "checkpoint_write_bandwidth_bps": round(bandwidth, 1),
        "checkpoint_write_s": round(write_s, 6),
        "checkpoint_restore_s": round(load_s + replay_s, 6),
        "checkpoint_load_s": round(load_s, 6), "checkpoint_replay_s": round(replay_s, 6),
        "checkpoint_overhead_fraction": round(headline_overhead, 6),
        "checkpoint_bitequal": bool(bitequal), "checkpoint_torn_fallback_ok": bool(torn_ok),
        "checkpoint_overhead_panel": overhead_panel,
    }


def series_equal(a, b) -> bool:
    """Two series of the same dataclass equal in every field, exactly."""
    return all(np.array_equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def lanes_equal(a, b) -> bool:
    """Two states (or tuples of them) equal lane for lane, in the
    reference's dtypes."""
    from ceph_tpu_torch.convert import state_lanes

    la, lb = state_lanes(a), state_lanes(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
                                      for x, y in zip(la, lb))


def crashbox_gate(dev, work: str) -> dict:
    """A checkpointed superstep SIGKILL'd mid-write in a
    ``python -m ceph_tpu_torch.recovery._crashbox`` child on the card
    (its config names no device), then rerun to completion: its series
    equal to an uninterrupted run in this process."""
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.models.clusters import build_osdmap

    n_osds, pg_num, epochs, every = CKPT_CRASHBOX
    cfg = {"mode": "superstep", "store": os.path.join(work, "crashbox"),
           "out": os.path.join(work, "crashbox.npz"), "n_osds": n_osds, "pg_num": pg_num,
           "size": 6, "pool_kind": "erasure", "scenario": CKPT_SCENARIO, "n_epochs": epochs,
           "snapshot_every": every, "n_ops": 64, "seed": 0,
           "kill": {"epoch": epochs // 2 - 1, "phase": "during"}, **CRASHBOX_CFG}
    # the kill fires mid-write at the first boundary at or past its epoch
    path = os.path.join(work, "crashbox.json")

    def child():
        with open(path, "w") as f:
            json.dump(cfg, f)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ceph_tpu_torch.recovery._crashbox", path],
                              cwd=HERE, capture_output=True, text=True, timeout=300)
        return proc, time.perf_counter() - t0

    killed, killed_s = child()
    torn = any(f.startswith(".tmp-") for f in os.listdir(cfg["store"]))
    cfg["kill"] = None
    resumed, resumed_s = child()
    m = build_osdmap(n_osds, pg_num=pg_num, size=6, pool_kind="erasure")
    want = rec.EpochDriver(m, rec.build_scenario(CKPT_SCENARIO, m), n_ops=64, seed=0,
                           device=dev).run_superstep(epochs)
    equal = False
    if resumed.returncode == 0:
        out = np.load(cfg["out"])
        equal = all(np.array_equal(out[f.name], getattr(want, f.name))
                    for f in dataclasses.fields(want))
    return {"osds": n_osds, "pgs": pg_num, "epochs": epochs, "killed_rc": killed.returncode,
            "torn_tmp": torn, "resumed_rc": resumed.returncode, "killed_s": killed_s,
            "resumed_s": resumed_s, "stderr_tail": resumed.stderr[-400:],
            "ok": killed.returncode == -9 and torn and resumed.returncode == 0 and equal}


def phase_checkpoint(dev, launch_counts, reset_launches, n_osds: int = EPOCH_OSDS,
                     pg_num: int = EPOCH_PGS, epochs: int = CKPT_EPOCHS) -> dict:
    """BASELINE config 9 (``recovery/checkpoint.py``) as
    ``bench/config9_checkpoint.py`` runs it, at config 7's width:
    ``build_osdmap(n_osds, pg_num, size=6, erasure)``, flap, CKPT_OPS ops
    a step, ``epochs`` epochs.  A run without checkpoints (the baseline);
    the checkpointed run with a snapshot every CKPT_EVERY epochs (the
    path's launch counts; the lanes' CRCs through K8): durable write
    bytes/s and bytes a snapshot; a kill mid-write at the midpoint, then
    the restore, load and replay seconds; the overhead panel at
    CKPT_GRID; one snapshot's lane CRCs on the card (K8 launches, ms)
    against the host ``crc32c`` (timed over CKPT_HOST_CRC_BYTES of the
    same lanes).  Gates: the checkpointed and resumed series bit-equal to
    the baseline; a corrupted newest snapshot falls back to the one
    before with a ``checkpoint.torn`` journal event; a SIGKILL'd
    ``_crashbox`` child on the card resumes bit-equal (CKPT_CRASHBOX); a
    fleet at config 8's settings (CKPT_FLEET) and the divergent pass at
    DIVERGENT_SMALL killed mid-write and restored land bit-equal; a
    snapshot the card wrote mid-run at CKPT_CARD_CPU restores on the CPU
    and the rest of the run there equals the card's.  Returns the phase
    line and the config-9 record."""
    import shutil
    import tempfile

    from ceph_tpu_torch import _cuda
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.convert import lane_bytes
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.obs.journal import EventJournal
    from ceph_tpu_torch.recovery import checkpoint as ck
    from ceph_tpu_torch.recovery import scrub

    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=_cuda.BUILD_DIR, prefix="ckpt-")
    m = build_osdmap(n_osds, pg_num=pg_num, size=6, pool_kind="erasure")
    d = rec.EpochDriver(m, rec.build_scenario(CKPT_SCENARIO, m), n_ops=CKPT_OPS, seed=0,
                        device=dev)
    d.run_superstep(4)  # the card's first calls, outside every timing

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    base, baseline_s = timed(lambda: d.run_superstep(epochs))
    store = ck.CheckpointStore(os.path.join(work, "headline"), device=dev)
    reset_launches()
    series, headline_s = timed(lambda: ck.checkpointed_superstep(
        d, epochs, store=store, snapshot_every=CKPT_EVERY))
    launches = launch_counts()
    n_snaps = len(store.entries())
    snap_bytes = store.bytes_written // max(n_snaps, 1)
    write_s = max(headline_s - baseline_s, 1e-9)
    bandwidth = store.bytes_written / write_s
    panel = [{"snapshot_every": CKPT_EVERY, "n_snapshots": n_snaps, "run_s": headline_s,
              "baseline_s": baseline_s, "overhead_fraction": headline_s / baseline_s - 1.0}]
    equal = {"checkpointed": series_equal(series, base)}
    for every in CKPT_GRID[1:]:
        pstore = ck.CheckpointStore(os.path.join(work, f"panel-{every}"), device=dev)
        pseries, run_s = timed(lambda: ck.checkpointed_superstep(
            d, epochs, store=pstore, snapshot_every=every))
        equal[f"every_{every}"] = series_equal(pseries, base)
        panel.append({"snapshot_every": every, "n_snapshots": len(pstore.entries()),
                      "run_s": run_s, "baseline_s": baseline_s,
                      "overhead_fraction": run_s / baseline_s - 1.0})
    kroot = os.path.join(work, "restore")
    try:
        ck.checkpointed_superstep(d, epochs, store=ck.CheckpointStore(kroot, device=dev),
                                  snapshot_every=CKPT_EVERY,
                                  crashes=(ck.CrashPoint(epochs // 2, "during"),))
        killed = False
    except ck.SimulatedCrash:
        killed = True
    torn_tmp = any(f.startswith(".tmp-") for f in os.listdir(kroot))
    resumed, load_s = timed(lambda: ck.CheckpointStore(kroot, device=dev).load_latest(
        d._init_state, with_series=True))
    series2, resume_s = timed(lambda: ck.checkpointed_superstep(
        d, epochs, store=ck.CheckpointStore(kroot, device=dev), snapshot_every=CKPT_EVERY))
    replay_s = max(resume_s - load_s, 0.0)
    equal["resumed"] = series_equal(series2, base) and killed and torn_tmp
    journal = EventJournal()
    tstore = ck.CheckpointStore(kroot, journal=journal, device=dev)
    newest = os.path.join(kroot, tstore.entries()[-1]["file"])
    with open(newest, "rb") as f:
        blob = f.read()
    with open(newest, "wb") as f:
        f.write(blob[: len(blob) // 2])
    fallback = tstore.load_latest(d._init_state)
    torn_ok = (fallback is not None and fallback[0]["next_epoch"] == epochs - CKPT_EVERY
               and len(journal.by_name("checkpoint.torn")) == 1
               and len(journal.by_name("checkpoint.restore")) == 1)

    # one snapshot's lane CRCs: K8 on the card against the host crc32c
    state_lanes = lane_bytes(d.final_state)
    host_series = [torch.from_numpy(np.ascontiguousarray(getattr(series, f.name))
                                    .reshape(-1).view(np.uint8).copy())
                   for f in dataclasses.fields(series)]
    lanes = state_lanes + [b.to(dev) for b in host_series]
    total = sum(int(b.numel()) for b in lanes)
    reset_launches()
    card_crcs = ck.lane_crcs(lanes, dev)
    crc_launches = launch_counts().get("crc32c_rows", 0)
    card_ms = time_ms(lambda: ck.lane_crcs(lanes, dev), 5)
    timed_bytes, host_ok, host_s = 0, True, 0.0
    for b, c in zip(lanes, card_crcs):
        if timed_bytes >= CKPT_HOST_CRC_BYTES:
            break
        host = b.cpu().numpy()
        t0 = time.perf_counter()
        h = scrub.crc32c(host)
        host_s += time.perf_counter() - t0
        host_ok &= h == c
        timed_bytes += host.size
    host_ms_per_mib = host_s * 1e3 / max(timed_bytes, 1) * MIB
    crc = {"lanes": len(lanes), "bytes": total, "k8_launches": crc_launches,
           "card_ms": card_ms, "host_timed_bytes": timed_bytes, "host_ms": host_s * 1e3,
           "host_ms_per_mib": host_ms_per_mib,
           "host_ms_all_lanes_at_that_rate": host_ms_per_mib * total / MIB,
           "host_equal": bool(host_ok)}

    gates_extra = {"crashbox": crashbox_gate(dev, work)}
    # a fleet at config 8's settings, killed mid-write and restored
    n_lanes, f_epochs, f_every = CKPT_FLEET
    fm = build_osdmap(FLEET_OSDS, pg_num=FLEET_PGS, size=6, pool_kind="erasure")
    fd = rec.FleetDriver(fm, seed=FLEET_SEED, n_ops=FLEET_OPS, device=dev)
    tls = fd.sample(n_lanes, FLEET_SCENARIO)
    (fwant, fstate_want), fleet_s = timed(lambda: (fd.run_fleet(f_epochs, tls), fd.final_state))
    froot = os.path.join(work, "fleet")
    try:
        ck.checkpointed_fleet(fd, f_epochs, tls, store=ck.CheckpointStore(froot, device=dev),
                              snapshot_every=f_every,
                              crashes=(ck.CrashPoint(f_epochs // 2, "during"),))
        fkilled = False
    except ck.SimulatedCrash:
        fkilled = True
    fgot = ck.checkpointed_fleet(fd, f_epochs, tls, store=ck.CheckpointStore(froot, device=dev),
                                 snapshot_every=f_every)
    gates_extra["fleet"] = {"lanes": n_lanes, "epochs": f_epochs, "run_s": fleet_s,
                            "ok": fkilled and series_equal(fgot, fwant)
                            and lanes_equal(fd.final_state, fstate_want)}
    # the divergent pass at DIVERGENT_SMALL, killed mid-write and restored
    dm = build_osdmap(DIVERGENT_SMALL[0], pg_num=DIVERGENT_SMALL[1], size=11,
                      pool_kind="erasure")
    dres = divergent_driver(dm, dev).run(DIVERGENT_EPOCHS)
    droot = os.path.join(work, "divergent")
    try:
        divergent_driver(dm, dev).run(DIVERGENT_EPOCHS, store=ck.CheckpointStore(droot,
                                                                                 device=dev),
                                      crashes=(ck.CrashPoint(DIVERGENT_EPOCHS // 2, "during"),))
        dkilled = False
    except ck.SimulatedCrash:
        dkilled = True
    revived = divergent_driver(dm, dev)
    dgot = revived.run(DIVERGENT_EPOCHS, store=ck.CheckpointStore(droot, device=dev))
    gates_extra["divergent"] = {
        "osds": DIVERGENT_SMALL[0], "pgs": DIVERGENT_SMALL[1], "rounds": len(dgot.rounds),
        "ok": dkilled and dgot.converged == dres.converged
        and [(r.steps, r.epochs, r.fingerprints) for r in dgot.rounds]
        == [(r.steps, r.epochs, r.fingerprints) for r in dres.rounds]
        and all(lanes_equal(a, b) for a, b in zip(dgot.states, dres.states))}
    # a snapshot the card wrote mid-run restores on the CPU
    c_osds, c_pgs, c_epochs, c_every = CKPT_CARD_CPU
    cm = build_osdmap(c_osds, pg_num=c_pgs, size=6, pool_kind="erasure")
    cpu = torch.device("cpu")

    def small_driver(dv):
        return rec.EpochDriver(cm, rec.build_scenario(CKPT_SCENARIO, cm), n_ops=CKPT_OPS,
                               seed=0, device=dv)

    card_d = small_driver(dev)
    cwant = card_d.run_superstep(c_epochs)
    croot = os.path.join(work, "card-cpu")
    try:
        ck.checkpointed_superstep(card_d, c_epochs, store=ck.CheckpointStore(croot, device=dev),
                                  snapshot_every=c_every,
                                  crashes=(ck.CrashPoint(c_epochs // 2, "after"),))
    except ck.SimulatedCrash:
        pass
    cpu_d = small_driver(cpu)
    cgot = ck.checkpointed_superstep(cpu_d, c_epochs,
                                     store=ck.CheckpointStore(croot, device=cpu),
                                     snapshot_every=c_every)
    gates_extra["card_to_cpu"] = {"osds": c_osds, "pgs": c_pgs, "epochs": c_epochs,
                                  "restored_at": c_epochs // 2,
                                  "ok": series_equal(cgot, cwant)
                                  and lanes_equal(cpu_d.final_state, card_d.final_state)}
    shutil.rmtree(work, ignore_errors=True)
    out = {"phase": "checkpoint", "osds": n_osds, "pgs": pg_num, "ops": CKPT_OPS,
           "epochs": epochs, "scenario": CKPT_SCENARIO, "snapshot_every": CKPT_EVERY,
           "baseline_s": baseline_s, "headline_s": headline_s, "n_snapshots": n_snaps,
           "snapshot_bytes": snap_bytes, "write_s": write_s, "write_bytes_per_s": bandwidth,
           "load_s": load_s, "replay_s": replay_s, "overhead_panel": panel,
           "lane_crcs": crc, "launches": launches,
           "checks": {k: {kk: vv for kk, vv in v.items() if kk != "ok"}
                      for k, v in gates_extra.items()}}
    out["gates"] = {
        "checkpointed_bitequal": all(v for k, v in equal.items() if k != "resumed"),
        "resumed_bitequal": equal["resumed"], "torn_falls_back": torn_ok,
        "lane_crcs_equal_host": crc["host_equal"] and crc_launches == 1,
        **{f"{k}_bitequal" if k != "crashbox" else "crashbox_sigkill_bitequal": v["ok"]
           for k, v in gates_extra.items()},
        "k8_launched": launches.get("crc32c_rows", 0) > 0,
    }
    record = checkpoint_record(epochs, bandwidth, write_s, snap_bytes, n_snaps, load_s, replay_s,
                               all(out["gates"].values()), torn_ok,
                               [{k: round(v, 6) if isinstance(v, float) else v
                                 for k, v in row.items()} for row in panel],
                               headline_s / baseline_s - 1.0)
    return out, record


def writepath_record(epochs, sets, ways, value, hit_rate, bitequal, families, totals,
                     sched_entries, mix_panel, batch) -> dict:
    """The reference's config-10 record (``bench/config10_online_ec.py``'s
    ``build_writepath_record``), for ``cli/status.py writepath``."""
    return {
        "metric": "writepath_encoded_bytes_per_sec", "status": "ok", "value": round(value),
        "unit": "B/s", "platform": "gpu", "writepath_scenario": WP_SCENARIO,
        "writepath_n_epochs": int(epochs), "writepath_batch": int(batch),
        "writepath_n_sets": int(sets), "writepath_ways": int(ways),
        "writepath_hit_rate": round(hit_rate, 6), "writepath_bitequal": bool(bitequal),
        "writepath_families": ",".join(families),
        "writepath_stripe_hits": int(totals["hits"]),
        "writepath_stripe_misses": int(totals["misses"]),
        "writepath_stripe_evictions": int(totals["evictions"]),
        "writepath_delta_bytes": 4 * int(totals["delta_words"]),
        "writepath_full_bytes": 4 * int(totals["full_words"]),
        "writepath_schedule_entries": int(sched_entries),
        "writepath_mix_panel": mix_panel,
    }


def writepath_driver(m, dev, mix, n_sets=WP_SETS, ways=WP_WAYS, groups=WP_GROUPS, config=None):
    """Config 10's write path on ``m``: flap, WP_OPS ops a step of ``mix``,
    liberation k=4 m=2 w=7 over ``n_sets`` x ``ways`` slots."""
    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.workload import WritepathDriver

    d = rec.EpochDriver(m, rec.build_scenario(WP_SCENARIO, m), seed=WP_SEED, n_ops=WP_OPS,
                        mix=mix, config=config, device=dev)
    return WritepathDriver(d, n_sets=n_sets, ways=ways, groups=groups,
                           stripes_per_pg=WP_STRIPES, name=f"writepath-{mix}")


PROBE_REPS = 20      # CUDA-event calls a measure of stripe_probe
PROBE_RUNS = 3       # runs of WP_EPOCHS epochs behind stripe_probe's epochs/s


def stripe_probe(dev) -> dict:
    """Config 10's stripe step alone on the card, with calls that older
    checkouts of the port have too: K9 at ``phase_online_kernel``'s
    width on its random batch; then config 10's first mix over WP_EPOCHS
    epochs and, on its final buffer and the next epoch's batch, K9 and
    the whole step (``stripe_buffer_step``): ms by CUDA events (median of
    PROBE_REPS calls, each on a fresh clone of the buffer made outside
    its window: the wrappers' host work is inside), device ms of the
    kernels alone (``kernel_device_ms``) and the step's launches, copies
    and memsets in one call; then the first mix's epochs/s over
    PROBE_RUNS runs, each on a new driver, and one more run's host ms an
    epoch in the epoch body, the write batch and the stripe step
    (``piece_host_ms``).  Every run is the host-decided loop
    (:func:`host_decided`), which every checkout has."""
    from ceph_tpu_torch.ec import online
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.testing import online_edges
    from ceph_tpu_torch.workload import writepath as wp_mod

    def fresh(b):
        return lambda: type(b)(*(getattr(b, f.name).clone() for f in dataclasses.fields(b)))

    def measured(k9, step, buf) -> dict:
        out = {"k9_ms": time_ms(k9, PROBE_REPS, fresh(buf)),
               "k9_device_ms": kernel_device_ms(k9, fresh(buf), "stripe_absorb_kernel")}
        if step is not None:
            clone = fresh(buf)
            out.update(step_ms=time_ms(step, PROBE_REPS, clone),
                       step_device_ms=kernel_device_ms(step, clone),
                       step_launches=piece_launches(
                           None, lambda: step(clone()),
                           {"step": ((online, "stripe_buffer_step"),)})["split"]["step"])
        return out

    buf, _enc = online_buffer(dev, WP_SETS, WP_WAYS, WP_GROUPS * 2, WP_WARM, SEED)
    batch = online_edges.random_batch(WP_SETS, WP_WAYS, WP_K, WP_BATCH, SEED + 100)
    out = {"card": nvidia_smi("name,power.limit"), "random_batch": {
        "writes": int(batch["valid"].sum()),
        **measured(absorb_call(online.stripe_absorb, online_edges.to_device(batch, dev)),
                   None, buf)}}
    m = build_osdmap(WP_OSDS, pg_num=WP_PGS, size=6, pool_kind="erasure")
    wd = writepath_driver(m, dev, WP_MIXES[0])
    state, buf, _fs, _rows, _wrows = host_decided(wd, WP_EPOCHS)
    lanes = wd._write_batch(state, WP_EPOCHS, wd.max_writes)
    k9 = lambda b: online.stripe_absorb(b.keys, b.data, b.parity, b.dirty, b.lru, b.tick,
                                        *lanes, wd.k, wd.w)
    step = lambda b: online.stripe_buffer_step(b, wd.table, wd.schedule.n_out, wd.k, wd.w,
                                               *lanes)
    out["epoch_batch"] = {"writes": int(lanes[4].sum()), **measured(k9, step, buf)}
    rates = []
    for _ in range(PROBE_RUNS):
        wd = writepath_driver(m, dev, WP_MIXES[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_decided(wd, WP_EPOCHS)
        torch.cuda.synchronize()
        rates.append(WP_EPOCHS / (time.perf_counter() - t0))
    out["epochs_per_s"] = rates
    wd = writepath_driver(m, dev, WP_MIXES[0])
    pieces = {"epoch_body": ((wd.driver, "_epoch_step"),), "write_batch": ((wd, "_write_batch"),),
              "stripe_step": ((wp_mod, "stripe_buffer_step"),)}
    out["host_ms_per_epoch"] = piece_host_ms(None, lambda: host_decided(wd, WP_EPOCHS),
                                             WP_EPOCHS, pieces)
    return out


def host_decided(wd, n: int, start: int = 0, state=None, host=None, buf=None,
                 cap: int | None = None, fs=None):
    """Epochs ``start .. start + n - 1`` of the write path decided on the
    host, one epoch at a time (``WritepathDriver._advance_host``; an
    older checkout's ``advance`` is that loop), from the driver's initial
    state and a clone of its cold buffer unless given: ``(state, buf, fs,
    rows, wrows)``, the rows on the card."""
    drv = wd.driver
    advance = getattr(wd, "_advance_host", wd.advance)
    return advance(drv._init_state if state is None else state,
                   drv._init_host.copy() if host is None else host,
                   wd._init_buf.clone() if buf is None else buf, start, start + n,
                   wd.max_writes if cap is None else cap, fs)


def phase_writepath(dev, launch_counts, reset_launches, n_osds: int = WP_OSDS,
                    pg_num: int = WP_PGS, epochs: int = WP_EPOCHS,
                    buffer=(WP_SETS, WP_WAYS, WP_GROUPS), small=WP_SMALL) -> dict:
    """BASELINE config 10 (``workload/writepath.py::WritepathDriver`` over
    ``ec/online.py``: K9, K6 and K9's commit each epoch) at full width:
    config 7's map, WP_OPS ops a step, ``epochs`` epochs of flap for each
    of WP_MIXES, a 1024 x 4 stripe buffer of 4,096-byte chunks.  On the
    card a chunk is one replay of the compiled write path's CUDA graph
    (``WritepathDriver.compile_writepath``: the epoch superstep's body,
    the write batch, the stripe step and the write row, K3, K9, K6 and
    the commit inside it): each mix's driver captures on a first run of
    ``epochs`` epochs, then its timed run is one replay (these runs are
    the path's launch counts): encoded bytes/s, hit rate, delta and full
    bytes, epochs/s a mix; the graph's capture ms, nodes, conditional
    nodes, bodies and the memory it reserves; a replayed chunk's wrapper
    calls, seam reads, sync warnings and builds; the graph, the same body
    eagerly, the host-decided loop (``_advance_host``) and the staged
    path in turns over WP_TURN epochs; the card's busy share
    (torch.profiler) through the graph over WP_TURN epochs and through
    the host-decided loop over WP_PROFILED quiet epochs past the run's
    end, on a clone of its final buffer, with the launches an epoch by
    piece of the host-decided loop (epoch body, write batch, the stripe
    step's own and, inside it, K9's, K6's and the commit's) and the
    stripe step's launches an epoch (the sum of those four); K9's, K6's
    and the commit's ms and the whole stripe step's card ms
    (``stripe_buffer_step`` between CUDA events, and the device time of
    its kernels and of K9's alone by torch.profiler) on the last epoch's
    batch, each call on a fresh clone of the final buffer made outside
    its window.  Gates: ``writepath_bitequal`` (each codec family of
    bench/config10_online_ec.py: parity after WP_GATE_UPDATES delta
    updates equal to a dense re-encode, on the card); the graph's series
    and final buffer equal to the eager body's, the host-decided loop's
    and the staged path's over ``epochs``; the bare epoch loop's epoch
    rows equal to the write path's (WP_SHORT epochs); K9, K6 and the
    commit among every mix's replayed launches (the bodies' pass
    counters); one capture a driver, and a second run at another cap
    inside the bucket with no new capture, equal to the host-decided run
    at that cap; a replayed chunk with no call, read, sync warning or
    build; a capture with a host read in the write stage raising; a
    wrong delta injected into a slot caught by ``scrub_stripe_buffer``
    (both lanes, then the re-encode lane alone); ``flight_recorder=on``
    through the graph's flight twin bit-invisible over WP_SHORT epochs,
    its ring equal to the host-decided loop's, the ring's stripe lanes
    equal to the write rows, its dump written, read and validated and the
    trace exported and validated; the bench's own settings (``small``)
    over WP_SHORT epochs equal on the card and the CPU.  Returns the
    phase line and the config-10 record."""
    import tempfile
    from dataclasses import replace

    from ceph_tpu_torch import _cuda
    from ceph_tpu_torch.analysis import runtime_guard
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.core import graphs
    from ceph_tpu_torch.ec import online
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.obs import flight, traceexport
    from ceph_tpu_torch.obs.journal import EventJournal
    from ceph_tpu_torch.recovery.scrub import Scrubber
    from ceph_tpu_torch.testing import online_edges

    verdicts = online_edges.bitequal_gate(WP_GATE_UPDATES, SEED, dev)
    m = build_osdmap(n_osds, pg_num=pg_num, size=6, pool_kind="erasure")
    sets, ways, groups = buffer
    drivers, panel, agg, best, best_wd, graph_rows = {}, [], None, 0.0, None, {}
    reset_launches()
    for mix in WP_MIXES:
        wd = drivers[mix] = writepath_driver(m, dev, mix, sets, ways, groups)
        torch.cuda.synchronize()
        reserved0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        wd.run_superstep(epochs, pull=False)  # the warm-up, the capture, one replay
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        reserved = torch.cuda.memory_reserved() - reserved0
        t0 = time.perf_counter()
        sup, wsup = wd.run_superstep(epochs)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        tot = wsup.totals()
        agg = tot if agg is None else {k: agg[k] + v for k, v in tot.items()}
        bps = 4 * (tot["delta_words"] + tot["full_words"]) / run_s
        if bps > best:
            best, best_wd = bps, wd
        wd.series = (sup, wsup, wd.final_state, wd.final_buf)
        graph_rows[mix] = {**program_info(wd.compile_writepath()), "first_run_s": first_s,
                           "reserved_delta_bytes": reserved}
        panel.append({"mix": mix, "hit_rate": round(tot["hits"] / max(
            tot["hits"] + tot["misses"], 1), 6), "encoded_bytes_per_sec": round(bps, 1),
            "delta_bytes": 4 * tot["delta_words"], "full_bytes": 4 * tot["full_words"],
            "delta_writes": tot["delta_writes"], "full_writes": tot["full_writes"],
            "run_s": round(run_s, 6), "epochs_per_s": epochs / run_s})
    launches = launch_counts()
    for mix, wd in drivers.items():  # collected by launch_counts: the bodies' passes
        g = wd.compile_writepath().graph
        graph_rows[mix]["replayed"] = dict(g.launched) if g is not None else {}
    lookups = agg["hits"] + agg["misses"]
    hit_rate = agg["hits"] / max(lookups, 1)
    out = {"phase": "writepath", "osds": n_osds, "pgs": pg_num, "ops": WP_OPS,
           "epochs": epochs, "scenario": WP_SCENARIO, "sets": sets, "ways": ways,
           "chunk_bytes": best_wd.chunk_bytes, "batch": best_wd.batch_size,
           "buffer_bytes": 4 * (best_wd._init_buf.data.numel()
                                + best_wd._init_buf.parity.numel()),
           "mix_panel": panel, "encoded_bytes_per_s": best, "hit_rate": hit_rate,
           "totals": agg, "launches": launches, "families": verdicts, "graph": graph_rows}
    walls: dict[str, float] = {}
    t_last = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        walls[name] = now - t_last[0]
        t_last[0] = now

    wd = drivers[WP_MIXES[0]]
    sup, wsup, final_state, buf = wd.series
    drv = wd.driver
    prog = wd.compile_writepath()

    def runner(how):
        if how == "graph":
            return lambda n: wd.run_superstep(n)
        if how == "eager":
            return prog.run_eager
        if how == "host":
            return lambda n: wd._run_chunks(wd._advance_host, None, n)
        return wd.run_staged

    # the graph against the eager body, the host-decided loop and the
    # staged path over the whole run: both series and the final buffer
    paths_equal = {}
    for how in ("eager", "host", "staged"):
        s_, ws_ = runner(how)(epochs)
        paths_equal[how] = (series_equal(s_, sup) and np.array_equal(ws_.lanes, wsup.lanes)
                            and lanes_equal(wd.final_buf, buf))
    lap("paths")
    # in turns, to read the rates' spread
    turns = []
    for how in ("graph", "eager", "host", "staged", "staged", "host", "eager", "graph"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner(how)(WP_TURN)
        torch.cuda.synchronize()
        turns.append([how, WP_TURN / (time.perf_counter() - t0)])
    out["epochs_per_s_in_turns"] = turns
    lap("turns")
    # a replayed chunk: no wrapper call, no read, no sync warning, no build
    with runtime_guard.track(sync_debug=True, check_launches=dev.type == "cuda") as g:
        wd.run_superstep(WP_TURN, pull=False)
        torch.cuda.synchronize()
    out["replay"] = {"calls": g.launch_counter.calls, "host_reads": g.host_transfers,
                     "sync_warnings": g.transfer_counter.sync_warnings,
                     "builds": g.n_compiles, "launches": g.launch_counter.launches,
                     "replayed": g.launch_counter.replays}
    # another cap inside the bucket: the same capture
    cap = wd.batch_size * 5 // 8
    captures = prog.captures
    c_sup, c_wsup = wd.run_superstep(WP_SHORT, cap=cap)
    h_sup, h_wsup = wd._run_chunks(wd._advance_host, None, WP_SHORT, cap=cap)
    out["second_cap"] = {"cap": cap, "new_captures": prog.captures - captures,
                         "writes": int((c_wsup.lane("delta_writes")
                                        + c_wsup.lane("full_writes")).sum())}
    second_cap_ok = bool(prog.captures == captures and series_equal(c_sup, h_sup)
                         and np.array_equal(c_wsup.lanes, h_wsup.lanes)
                         and (c_wsup.lane("delta_writes") + c_wsup.lane("full_writes")
                              <= cap).all())
    lap("replay_and_cap")

    # launches an epoch by piece of the host-decided loop over quiet
    # epochs past the run's end (flap's events all land in its first 3 s),
    # on a clone of the final buffer (the step consumes its buffer); the
    # graph's busy share over WP_TURN epochs; then the step and its
    # kernels alone on the last batch, each call on a fresh clone
    from ceph_tpu_torch.workload import writepath as wp_mod

    step_pieces = ("stripe_step", "k9", "k6", "k9_commit")
    pieces = {"epoch_body": ((drv, "_epoch_step"),), "write_batch": ((wd, "_write_batch"),),
              "stripe_step": ((wp_mod, "stripe_buffer_step"),),
              "k9": ((online, "stripe_absorb"),), "k6": ((online, "schedule_apply"),),
              "k9_commit": ((online, "stripe_commit"),)}
    start_buf, start_host = buf.clone(), drv.host_view(final_state)
    prof = piece_launches(None, lambda: host_decided(
        wd, WP_PROFILED, epochs, final_state, start_host, start_buf), pieces)
    out["launches_per_epoch"] = {p: {k: v / WP_PROFILED for k, v in c.items()}
                                 for p, c in prof["split"].items()}
    out["stripe_step_launches_per_epoch"] = sum(
        v for p in step_pieces for v in out["launches_per_epoch"][p].values())
    out["profiled"] = {k: prof[k] for k in ("wall_ms", "device_ms", "device_busy")}
    gprof = piece_launches(None, lambda: wd.run_superstep(WP_TURN), {})
    out["graph_profiled"] = {"epochs": WP_TURN, **{k: gprof[k] for k in (
        "wall_ms", "device_ms", "device_busy")}, "launch_calls": gprof["split"]["other"]}
    lap("profiles")
    lanes = wd._write_batch(final_state, epochs, wd.max_writes)
    k9_call = lambda b: online.stripe_absorb(b.keys, b.data, b.parity, b.dirty, b.lru, b.tick,
                                             *lanes, wd.k, wd.w)
    absorbed = k9_call(buf.clone())
    dpar = online.schedule_apply(wd.table, absorbed[6], wd.schedule.n_out)
    out["epoch_kernels_ms"] = {
        "k9": time_ms(k9_call, setup=buf.clone),
        "k6": time_ms(lambda: online.schedule_apply(wd.table, absorbed[6], wd.schedule.n_out)),
        "k9_commit": time_ms(lambda x: online.stripe_commit(x[0], dpar, absorbed[7],
                                                            absorbed[8], *x[1:], absorbed[5]),
                             setup=lambda: (absorbed[2].clone(), buf.totals.clone(),
                                            buf.tick.clone())),
        "writes": int(lanes[4].sum())}
    step = lambda b: online.stripe_buffer_step(b, wd.table, wd.schedule.n_out, wd.k, wd.w,
                                               *lanes)
    out["stripe_step_ms"] = time_ms(step, setup=buf.clone)
    # the kernels alone (torch.profiler), without the wrappers' host work
    out["stripe_step_device_ms"] = {"k9": kernel_device_ms(k9_call, buf.clone,
                                                           "stripe_absorb_kernel"),
                                    "step": kernel_device_ms(step, buf.clone, "")}
    lap("kernels")

    # the bare epoch loop over WP_SHORT epochs
    bare = drv.run_superstep(WP_SHORT)
    head = series_head(sup, WP_SHORT)
    replay = out["replay"]
    replayed = [graph_rows[mix]["replayed"] for mix in WP_MIXES]
    gates = {"writepath_bitequal": all(verdicts.values()),
             "staged_equals_superstep": paths_equal["staged"],
             "graph_equals_eager_host_staged": all(paths_equal.values()),
             "epoch_lanes_unchanged": series_equal(bare, head),
             "one_capture_a_driver": all(
                 w_.compile_writepath().captures == 1 for w_ in drivers.values()),
             "second_cap_no_capture_equals_host": second_cap_ok,
             "replay_no_call_read_warning_or_build": (
                 replay["calls"] == {} and replay["host_reads"] == 0
                 and replay["sync_warnings"] == 0 and replay["builds"] == 0),
             "k9_k6_commit_replayed": all(
                 r.get(k, 0) >= epochs for r in replayed
                 for k in ("stripe_absorb", "schedule_apply", "stripe_commit"))}
    # a wrong delta injected into a resident slot
    bm = wd.engine.bitmatrix
    sc = Scrubber(n_pgs=pg_num, n_shards=6, device=dev)
    sc.note_stripe_writes(buf)
    clean = sc.scrub_stripe_buffer(buf, bm)
    keys = buf.keys.cpu().numpy()
    si, wi = (int(v[0]) for v in np.nonzero(keys >= 0))
    parity = buf.parity.clone()
    parity[si, wi, 0, 0] ^= 1
    bad = replace(buf, parity=parity)
    caught = sc.scrub_stripe_buffer(bad, bm)
    slot = (si, wi, int(keys[si, wi]))
    sc.note_stripe_writes(bad)
    reencode = sc.scrub_stripe_buffer(bad, bm)
    gates["scrub_catches_wrong_delta"] = (
        clean.status == "ok" and slot in caught.crc_bad and slot in caught.reencode_bad
        and reencode.crc_bad == [] and reencode.reencode_bad == [slot])
    out["scrub"] = {"slots": clean.checked_slots, "bytes": clean.scrubbed_bytes}
    # the flight recorder riding the write path: the graph's flight twin
    # against the host-decided loop's ring
    cfg = Config(env={})
    cfg.set("flight_recorder", "on")
    wf = writepath_driver(m, dev, WP_MIXES[0], sets, ways, groups, config=cfg)
    journal = EventJournal()
    fsup, fwsup = wf.run_superstep(WP_SHORT, journal=journal)
    fring = wf.flight
    drain = flight.drain_flight(fring)
    rows = drain["rows"]
    wf._run_chunks(wf._advance_host, wf.driver._init_flight, WP_SHORT)
    host_ring = flight.drain_flight(wf.flight)["rows"]
    stripe_ok = all(np.array_equal(rows[:, flight.FLIGHT_LANES.index(f"stripe_{n}")],
                                   fwsup.lanes[:, online.WP_LANES.index(n)])
                    for n in ("hits", "misses", "evictions", "delta_words"))
    work = tempfile.mkdtemp(dir=_cuda.BUILD_DIR, prefix="flight-")
    dump = flight.write_flight_dump(work, fring, reason="writepath", journal=journal,
                                    state={"epochs": WP_SHORT})
    doc = flight.read_flight_dump(dump)
    trace = traceexport.export_trace(os.path.join(work, "trace.json"), journal.records, drain,
                                     dt=wf.driver.dt)
    gates["flight_bit_invisible"] = (series_equal(fsup, head)
                                     and np.array_equal(fwsup.lanes, wsup.lanes[:WP_SHORT]))
    gates["flight_ring_equals_host_loop"] = (wf.compile_writepath_flight().captures == 1
                                             and np.array_equal(rows, host_ring))
    gates["flight_stripe_lanes_equal_wrows"] = stripe_ok and len(rows) == WP_SHORT
    gates["flight_dump_and_trace_valid"] = (flight.validate_flight_dump(doc) == []
                                            and traceexport.validate_trace(trace) == []
                                            and len(journal.by_name("flight.drain")) == 1)
    out["flight"] = {"ring_epochs": drain["ring_epochs"], "rows": len(rows),
                     "trace_events": len(trace["traceEvents"])}
    lap("scrub_and_flight")
    # the bench's own settings on the card and the CPU
    s_osds, s_pgs, s_sets, s_ways, s_groups = small
    sm = build_osdmap(s_osds, pg_num=s_pgs, size=6, pool_kind="erasure")
    runs = []
    for dv in (dev, torch.device("cpu")):
        w_ = writepath_driver(sm, dv, WP_MIXES[1], n_sets=s_sets, ways=s_ways, groups=s_groups)
        runs.append((w_.run_superstep(WP_SHORT), w_.final_buf))
    ((c_sup, c_w), c_buf), ((p_sup, p_w), p_buf) = runs
    gates["card_equals_cpu"] = (series_equal(c_sup, p_sup)
                                and np.array_equal(c_w.lanes, p_w.lanes)
                                and lanes_equal(c_buf, p_buf)
                                and int(c_w.lanes[:, 0].sum()) > 0)
    # a host read in the write stage stops the capture with an error
    faulty = writepath_driver(sm, dev, WP_MIXES[1], n_sets=s_sets, ways=s_ways, groups=s_groups)
    batch = faulty._write_batch

    def reads(state, step, cap, **kw):
        bool(state.n_alive.any())
        return batch(state, step, cap, **kw)

    faulty._write_batch = reads
    try:
        faulty.run_superstep(8)
        fault = "no error"
    except graphs.HostReadInCapture as e:
        fault = f"{type(e).__name__}: {e}"
    out["capture_fault"] = fault
    gates["capture_fault_raises"] = (fault.startswith("HostReadInCapture")
                                     and faulty.compile_writepath().graph is None)
    gates["k9_launched"] = launches.get("stripe_absorb", 0) > 0
    gates["k9_commit_launched"] = launches.get("stripe_commit", 0) > 0
    gates["k6_launched"] = launches.get("schedule_apply", 0) > 0
    out["card_equals_cpu"] = {"osds": s_osds, "pgs": s_pgs, "sets": s_sets, "ways": s_ways,
                              "groups": s_groups, "epochs": WP_SHORT}
    lap("card_equals_cpu")
    out["walls_s"] = walls
    out["gates"] = gates
    families = [n for n, _b, _w in online_edges.gate_families()]
    record = writepath_record(epochs, sets, ways, best, hit_rate, all(gates.values()), families,
                              agg,
                              len(best_wd.engine.cache.dump().get("entries", [])), panel,
                              best_wd.batch_size)
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    return out, record


def program_info(prog) -> dict:
    """A compiled superstep's or write path's graph figures (its captures
    and replays alone where it has none: the CPU runs the body eagerly)."""
    g = prog.graph
    if g is None:
        return {"captures": prog.captures, "replays": prog.replays}
    return {"captures": prog.captures, "replays": prog.replays, "capture_ms": g.capture_ms,
            "nodes": g.nodes, "conditional_nodes": g.cond_nodes,
            "conditional_bodies": len(g.bodies), "pool_bytes": g.pool_bytes,
            "buffer_epochs": prog._carry.capacity}


def ec_batch(name: str, dev):
    """A codec on the card and one encode call's data: EC_OBJECTS objects
    of EC_OBJECT_BYTES striped with EC_STRIPE_UNIT-byte chunks, as the
    k shard streams ``[k, EC_OBJECTS * EC_OBJECT_BYTES / k]`` (byte-local
    codes encode the concatenated streams as the objects one by one)."""
    from ceph_tpu_torch.ec import create

    profile, unit = EC_CODES[name]
    ec = create(profile, device=dev)
    k = ec.get_data_chunk_count()
    if ec.get_chunk_size(k * unit) != unit:
        raise AssertionError(f"{name}: a {k * unit}-byte stripe is not {k} chunks")
    data = card_bytes((k, EC_OBJECTS * EC_OBJECT_BYTES // k), SEED + k, dev)
    return ec, data, unit


def host_seconds(fn, reps: int) -> list[float]:
    """Host-clock seconds of ``fn`` followed by a device synchronize."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def phase_ec_encode(dev, batches: dict) -> dict:
    from ceph_tpu_torch.ec import stripe
    from ceph_tpu_torch.testing import cppref

    out = {}
    for name in EC_CODES:
        ec, data, unit = ec_batch(name, dev)
        k, m = ec.get_data_chunk_count(), ec.get_coding_chunk_count()
        parity = ec.codec.encode_async(data)
        cols = -(-4 * MIB // k)  # >= 4 MiB of data columns against the C++ tier
        sample = data[:, :cols].cpu().numpy()
        if hasattr(ec.codec, "bitmatrix"):  # the packet layout (K5)
            want = cppref.bitmatrix_encode(ec.codec.bitmatrix, sample, ec.codec.packetsize)
        else:
            want = cppref.matrix_encode(ec.codec.matrix, sample)
        if not np.array_equal(parity[:, :cols].cpu().numpy(), want):
            raise AssertionError(f"{name}: parity differs from the C++ tier")
        ms = time_ms(lambda: ec.codec.encode_async(data))
        obj = np.random.default_rng(SEED).integers(0, 256, EC_OBJECT_BYTES, dtype=np.uint8)
        sw = k * unit
        iface = host_seconds(lambda: stripe.encode_object(ec, obj, sw), 10)
        sinfo, shards = stripe.encode_object(ec, obj, sw)
        if stripe.decode_object(ec, sinfo, shards, len(obj), failed=set(range(m))) != obj.tobytes():
            raise AssertionError(f"{name}: encode_object / decode_object round trip failed")
        batches[name] = (ec, data, parity)
        out[name] = {
            "k": k, "m": m, "chunk_bytes": data.shape[1], "data_bytes": data.numel(),
            "cpp_sample_bytes": k * cols,
            "device_ms": ms, "device_GBps": data.numel() / ms / 1e6,
            "object_bytes": EC_OBJECT_BYTES, "stripe_width": sw,
            "encode_object_s": float(np.median(iface)), "all_encode_object_s": iface,
            "encode_object_GBps": EC_OBJECT_BYTES / float(np.median(iface)) / 1e9,
            "profile_device": profile_call(lambda: ec.codec.encode_async(data)),
            "profile_encode_object": profile_call(lambda: stripe.encode_object(ec, obj, sw)),
        }
    return {"phase": "ec_encode", "objects": EC_OBJECTS, "codes": out}


def phase_ec_decode(dev, batches: dict) -> dict:
    out = {}
    for name, (ec, data, parity) in batches.items():
        k, m = ec.get_data_chunk_count(), ec.get_coding_chunk_count()
        lost = set(range(m))  # data chunks first
        rows = {i: data[i] for i in range(k)} | {k + j: parity[j] for j in range(m)}
        avail_dev = {i: t for i, t in rows.items() if i not in lost}
        got = ec.codec.decode_async(avail_dev, lost)
        if not all(torch.equal(got[i], data[i]) for i in lost):
            raise AssertionError(f"{name}: device-resident decode differs from the data")
        ms = time_ms(lambda: ec.codec.decode_async(avail_dev, lost), 5)
        avail = {i: t.cpu().numpy() for i, t in avail_dev.items()}
        size = data.shape[1]
        secs = host_seconds(lambda: ec.decode(lost, avail, size), 3)
        dec = ec.decode(lost, avail, size)
        for i in lost:
            if not np.array_equal(dec[i], data[i].cpu().numpy()):
                raise AssertionError(f"{name}: decode of chunk {i} differs from the data")
        out[name] = {"lost": sorted(lost), "data_bytes": data.numel(),
                     "device_ms": ms, "device_GBps": data.numel() / ms / 1e6,
                     "decode_s": float(np.median(secs)), "all_decode_s": secs,
                     "decode_GBps": data.numel() / float(np.median(secs)) / 1e9}
    return {"phase": "ec_decode", "codes": out}


def phase_ec_plugins(dev) -> dict:
    import hashlib

    from ceph_tpu_torch.ec import create

    with open(os.path.join(HERE, "tests", "golden", "archive.json")) as f:
        golden = json.load(f)["ec"]
    obj = np.random.default_rng(0xCE9).integers(0, 256, 40_000, dtype=np.uint8)
    bad = []
    for name, profile in GOLDEN_EC.items():
        ec = create(profile, device=dev)
        enc = ec.encode(set(range(ec.get_chunk_count())), obj)
        got = {str(i): hashlib.sha256(np.ascontiguousarray(enc[i]).tobytes()).hexdigest()
               for i in sorted(enc)}
        if got != golden[name]["chunks_sha256"] or len(enc[0]) != golden[name]["chunk_size"]:
            bad.append(name)
    if bad:
        raise AssertionError(f"EC digests differ from tests/golden/archive.json: {bad}")

    # CLAY k=4 m=2 (d=5): repair chunk 0 of a 64 MiB object from 5 helpers
    clay = create(GOLDEN_EC["clay_4_2"], device=dev)
    big = np.random.default_rng(SEED).integers(0, 256, 64 * MIB, dtype=np.uint8)
    t0 = time.perf_counter()
    enc = clay.encode(set(range(clay.get_chunk_count())), big)
    encode_s = time.perf_counter() - t0
    lost = 0
    helpers, planes = clay.minimum_to_decode_subchunks(lost, set(range(1, 6)))
    sub = len(enc[0]) // clay.get_sub_chunk_count()
    helper_subchunks = {i: {int(z): enc[i][z * sub:(z + 1) * sub] for z in planes}
                        for i in helpers}
    if not np.array_equal(clay.repair(lost, helper_subchunks), enc[lost]):
        raise AssertionError("CLAY repair differs from the lost chunk")
    secs = host_seconds(lambda: clay.repair(lost, helper_subchunks), 3)
    read = sum(len(v) for h in helper_subchunks.values() for v in h.values())

    # LRC k=4 m=2 l=3: one lost data chunk, repaired from its local group
    lrc = create(GOLDEN_EC["lrc_4_2_3"], device=dev)
    lenc = lrc.encode(set(range(lrc.get_chunk_count())), big[:4 * MIB])
    gone = lrc.chunk_mapping[0]
    avail = {i: c for i, c in lenc.items() if i != gone}
    t0 = time.perf_counter()
    dec = lrc.decode({gone}, avail, len(lenc[0]))
    lrc_s = time.perf_counter() - t0
    if not np.array_equal(dec[gone], lenc[gone]):
        raise AssertionError("LRC decode differs from the lost chunk")
    return {"phase": "ec_plugins", "golden_profiles": len(GOLDEN_EC), "golden_ok": True,
            "clay": {"object_bytes": big.size, "chunk_bytes": len(enc[0]), "encode_s": encode_s,
                     "lost": lost, "helpers": sorted(helpers), "helper_bytes_read": read,
                     "repair_s": float(np.median(secs)), "all_repair_s": secs,
                     "repair_GBps": len(enc[0]) / float(np.median(secs)) / 1e9,
                     "profile_repair": profile_call(lambda: clay.repair(lost, helper_subchunks))},
            "lrc": {"chunk_bytes": len(lenc[0]), "lost": gone,
                    "read": sorted(lrc.minimum_to_decode({gone}, set(avail))), "decode_s": lrc_s}}


def profile_call(fn) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler),
    and the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        # a record_function span shows on the device timeline too; it is
        # no device work of its own
        span = getattr(e, "is_user_annotation", False) or e.key.startswith("recovery:")
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA and not span:
            rows.append({"kernel": e.key[:80], "ms": us / 1e3, "count": e.count})
    rows.sort(key=lambda r: -r["ms"])
    device_ms = sum(r["ms"] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_busy": device_ms / wall_ms,
            "top": rows[:10]}


@contextlib.contextmanager
def masked_rounds():
    """Run the general engine's retry rounds masked over the whole batch,
    whatever its size: the comparison for its compacted-straggler rounds,
    which it runs from ``interp.COMPACT_MIN_BATCH`` lanes up."""
    from ceph_tpu_torch.crush import interp

    keep = interp.COMPACT_MIN_BATCH
    interp.COMPACT_MIN_BATCH = 1 << 62
    try:
        yield
    finally:
        interp.COMPACT_MIN_BATCH = keep


def masked(fn):
    """``fn`` with its retry rounds masked (:func:`masked_rounds`)."""
    def run():
        with masked_rounds():
            return fn()
    return run


def in_turns(runners: dict, reps: int) -> dict:
    """Host seconds of ``reps`` calls of each runner, in turns, the order
    reversed every other turn (A B, B A, ...), so that drift on the host
    hits them alike."""
    labels = list(runners)
    times = {label: [] for label in labels}
    for i in range(reps):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            t0 = time.perf_counter()
            runners[label]()
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    return times


def phase_crush(n: int, dev, modes) -> dict:
    """Every mode of the fast engine on config 1."""
    from ceph_tpu_torch.core import straw2
    from ceph_tpu_torch.crush import interp_batch
    from ceph_tpu_torch.crush.engine import make_batch_runner
    from ceph_tpu_torch.models.clusters import build_simple
    from ceph_tpu_torch.testing import cppref

    m = build_simple(1024)
    rule = m.rule_by_name("replicated_rule")
    dense = m.to_dense()
    w = np.full(dense.max_devices, 0x10000, np.uint32)
    xs = torch.arange(n, dtype=torch.int64, device=dev)
    labels = list(modes)
    out, first, runners = {}, None, {}
    for label in labels:
        crush_arg, fn = make_batch_runner(dense, rule, REPLICAS, mode=label, device=dev)
        runners[label] = lambda fn=fn, crush_arg=crush_arg: fn(crush_arg, w, xs)
        before = dict(straw2.LAUNCHES)
        syncs = interp_batch.HOST_SYNCS
        res, lens = runners[label]()
        torch.cuda.synchronize()
        out[label] = {"launches": {k: straw2.LAUNCHES[k] - before[k] for k in before},
                      "host_syncs": interp_batch.HOST_SYNCS - syncs}
        if first is None:
            first = (res, lens)
        elif not (torch.equal(res, first[0]) and torch.equal(lens, first[1])):
            raise AssertionError(f"{label} disagrees with mode {labels[0]}")
    times = in_turns(runners, 6)
    for label in labels:
        sec = float(np.median(times[label]))
        out[label].update(placements_per_s=n / sec, seconds=sec, all_seconds=times[label],
                          profile=profile_call(runners[label]))
    res, lens = first
    placed = res[:, :REPLICAS].to(torch.int64)
    if (res.shape != (n, REPLICAS) or not bool((lens == REPLICAS).all())
            or bool(((placed < 0) | (placed >= dense.max_devices)).any())
            or bool((placed.sort(dim=1).values.diff(dim=1) == 0).any())):
        raise AssertionError("placements are not 3 distinct in-range OSDs per object")
    k = min(n, 50_000)
    steps = [(s.op, s.arg1, s.arg2) for s in rule.steps]
    rr, ll = cppref.do_rule_batch(dense, steps, np.arange(k, dtype=np.uint32), w, REPLICAS)
    if not (np.array_equal(first[0][:k].cpu().numpy(), rr)
            and np.array_equal(first[1][:k].cpu().numpy(), ll)):
        raise AssertionError("device placements differ from the C++ tier")
    return {"phase": "crush", "objects": n, "modes": out, "cpp_sample": k}


def emptying_rule_edges(dev, n: int = 4096) -> list[dict]:
    """A choose step whose effective numrep (arg1 + result_max) is <= 0
    empties the working vector, so the emit writes nothing
    (``mapper.c``, the C++ tier): on ``build_flat(4)`` take, choose
    firstn -1 type 0, emit, result_max 1; and on ``build_simple(16)``
    take, choose firstn 2 host, choose firstn -3 osd, emit, result_max
    3.  Each runs in ``descend`` mode on the card against the C++ tier."""
    from ceph_tpu_torch.crush.engine import make_batch_runner
    from ceph_tpu_torch.crush.map import OP_CHOOSE_FIRSTN, OP_EMIT, OP_TAKE, Step
    from ceph_tpu_torch.models.clusters import build_flat, build_simple
    from ceph_tpu_torch.testing import cppref

    flat, simple = build_flat(4), build_simple(16)
    host = simple.type_id("host")
    cases = {
        "flat(4): choose firstn -1 type 0, result_max 1": (flat, [
            Step(OP_TAKE, flat.bucket_by_name("default").id), Step(OP_CHOOSE_FIRSTN, -1, 0),
            Step(OP_EMIT)], 1),
        "simple(16): choose firstn 2 host, choose firstn -3 osd, result_max 3": (simple, [
            Step(OP_TAKE, simple.bucket_by_name("default").id), Step(OP_CHOOSE_FIRSTN, 2, host),
            Step(OP_CHOOSE_FIRSTN, -3, 0), Step(OP_EMIT)], 3),
    }
    xs = np.arange(n, dtype=np.uint32)
    out = []
    for label, (m, steps, rm) in cases.items():
        rule = m.add_rule(f"emptying_{len(out)}", steps)
        dense = m.to_dense()
        w = np.full(dense.max_devices, 0x10000, np.uint32)
        crush_arg, fn = make_batch_runner(dense, rule, rm, mode="descend", device=dev)
        res, lens = fn(crush_arg, w, xs)
        cres, clens = cppref.do_rule_batch(dense, [(s.op, s.arg1, s.arg2) for s in steps], xs,
                                           w, rm)
        out.append({"case": label, "mode": "descend", "xs": n,
                    "max_len": int(lens.max()), "cpp_max_len": int(clens.max()),
                    "equal_cpp": bool(np.array_equal(res.cpu().numpy(), cres)
                                      and np.array_equal(lens.cpu().numpy(), clens))})
    return out


def phase_osdmap(dev) -> dict:
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.osdmap import OSDMapMapping, PGId

    rng = np.random.default_rng(SEED)
    m = build_osdmap(1024, pg_num=32768)
    pg_num = 32768
    # upmap items that move a replica the PG really has
    moved = [int(v) for v in rng.choice(pg_num, 64, replace=False)]
    for ps, raw in m.pg_to_raw_osds_batch(1, moved).items():
        to = int(rng.integers(1024))
        if to not in raw:
            m.pg_upmap_items[PGId(1, ps)] = ((raw[0], to),)
    m.pg_upmap[PGId(1, 5)] = (1, 100, 200)
    m.pg_temp[PGId(1, 7)] = (3, 300, 600)
    m.primary_temp[PGId(1, 9)] = 42
    for o in rng.choice(1024, 32, replace=False):
        m.osd_primary_affinity[int(o)] = int(rng.integers(0, 0x10000))
    m.mark_down(17)
    t0 = time.perf_counter()
    mp = OSDMapMapping(m, device=dev)
    mp.update()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp.update()
    again = time.perf_counter() - t0
    special = [5, 7, 9] + [pg.ps for pg in m.pg_upmap_items][:16]
    sample = sorted(set(special) | set(int(v) for v in rng.choice(pg_num, 300, replace=False)))
    for ps in sample:
        pg = PGId(1, ps)
        if mp.get(pg) != m.pg_to_up_acting_osds(pg):
            raise AssertionError(f"pg {pg}: {mp.get(pg)} != {m.pg_to_up_acting_osds(pg)}")
    up = mp._results[1][0]
    if up.shape != (pg_num, 3) or (up[up != 0x7FFFFFFF] >= 1024).any():
        raise AssertionError("mapping has the wrong shape or an out-of-range OSD")
    return {"phase": "osdmap", "pgs": pg_num, "sample_checked": len(sample),
            "first_update_s": first, "update_s": again, "pgs_per_s": pg_num / again}


def mixed_hierarchy(racks: int, hosts: int, osds: int):
    """straw2 root and racks over uniform hosts of ``osds`` OSDs each (the
    shape of build_hierarchy([("rack", racks), ("host", hosts)], osds)),
    with its replicated rule (chooseleaf firstn host) and an EC rule
    (set_chooseleaf_tries 5, chooseleaf indep 0 type host)."""
    from ceph_tpu_torch.crush.map import ALG_STRAW2, ALG_UNIFORM, CrushMap

    m = CrushMap()
    for tid, name in ((1, "root"), (2, "rack"), (3, "host")):
        m.add_type(tid, name)
    root = m.add_bucket("default", "root", alg=ALG_STRAW2)
    osd = 0
    for r in range(racks):
        rack = m.add_bucket(f"rack{r}", "rack", alg=ALG_STRAW2)
        for h in range(hosts):
            host = m.add_bucket(f"host{r}_{h}", "host", alg=ALG_UNIFORM)
            for _ in range(osds):
                m.insert_item(host.id, osd, 0x10000)
                osd += 1
            m.insert_item(rack.id, host.id, osds * 0x10000)
        m.insert_item(root.id, rack.id, hosts * osds * 0x10000)
    m.make_replicated_rule("replicated_rule", "default", "host")
    m.make_erasure_rule("ec_rule", "default", "host")
    return m


# phase pipeline: the fused placement->peering graph
PIPELINE_TURNS = 10             # calls of each path timed in turns (the median)
PIPELINE_EPOCHS = 5             # chaos epochs through one program cache
EPOCH_PEER_OSDS = 1024          # config 7's map for the dense _peer_hist
EPOCH_PEER_PGS = 8192


def general_osdmap(pg_num: int):
    """An OSDMap over :func:`mixed_hierarchy` (32 racks of 8 uniform hosts
    of 4 OSDs) with a 6-slot EC pool on its EC rule: the general tier."""
    from ceph_tpu_torch.osdmap.map import OSDMap, Pool

    crush = mixed_hierarchy(32, 8, 4)
    m = OSDMap(crush)
    for o in range(1024):
        m.add_osd(o)
    m.add_pool(Pool(id=1, name="general", kind="erasure", size=6, pg_num=pg_num,
                    pgp_num=pg_num, crush_rule=crush.rule_by_name("ec_rule").id))
    return m


def graph_record(g) -> dict:
    """A graph's capture (nodes, captured and sure launches, ms, the
    device memory its capture reserved) and the launches its replays ran
    (read from its pass counters first)."""
    from ceph_tpu_torch.core import graphs

    graphs.collect()
    return {"nodes": g.nodes, "conditional_nodes": g.cond_nodes,
            "captured_launches": g.launches, "sure_launches": g.sure,
            "capture_ms": g.capture_ms, "capture_reserved_bytes": g.pool_bytes,
            "replays": g.replays, "replayed_launches": dict(g.launched)}


def crush_reweight(m) -> None:
    """A CRUSH reweight in place: the first item of the first four straw2
    buckets at half its weight (the shapes, so the program key, stay)."""
    from ceph_tpu_torch.crush.map import ALG_STRAW2

    buckets = [b for b in m.crush.buckets.values() if b.alg == ALG_STRAW2 and len(b.items) > 1]
    for b in buckets[:4]:
        b.item_weights[0] = b.item_weights[0] // 2 + 1
    m.crush._mutated()


def peer_equal(got, want) -> dict:
    """Each output of a fused call (tensors) against a PeeringResult."""
    fields = ("up", "up_primary", "acting", "acting_primary", "prev_acting", "flags",
              "survivor_mask", "n_alive")
    return {f: bool(np.array_equal(g.cpu().numpy().astype(np.int64),
                                   np.asarray(getattr(want, f)).astype(np.int64)))
            for f, g in zip(fields, got)}


def event_ms(fn) -> tuple[float, float]:
    """(wall ms, CUDA-event ms) of one call of ``fn`` on the current
    stream, the card synchronised before and after."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    fn()
    b.record()
    b.synchronize()
    return (time.perf_counter() - t0) * 1e3, a.elapsed_time(b)


def turns_ms(runners: dict, reps: int) -> dict:
    """Each runner ``reps`` times in turns (the order reversed every
    other turn), after one warm-up call each: medians and all of the
    wall and CUDA-event ms."""
    for fn in runners.values():
        fn()
    walls = {k: [] for k in runners}
    events = {k: [] for k in runners}
    labels = list(runners)
    for i in range(reps):
        for k in (labels if i % 2 == 0 else labels[::-1]):
            w, e = event_ms(runners[k])
            walls[k].append(w)
            events[k].append(e)
    return {k: {"wall_ms": float(np.median(walls[k])), "event_ms": float(np.median(events[k])),
                "all_wall_ms": walls[k], "all_event_ms": events[k]} for k in labels}


def phase_pipeline(dev, counts, reset, n_osds: int = RECOVERY_OSDS,
                   pg_num: int = RECOVERY_PGS, reps: int = PIPELINE_TURNS) -> dict:
    """Phase 15 (see the module docstring).  The path's launch counts run
    from ``reset()`` before the chaos epochs to ``counts()`` after the
    fused runs on both tiers; the staged passes they are held against,
    the guard and the timing calls come after."""
    import copy
    from dataclasses import replace

    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.analysis import runtime_guard
    from ceph_tpu_torch.core import graphs
    from ceph_tpu_torch.crush.engine import runner_signature
    from ceph_tpu_torch.crush.map import ALG_LIST
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.osdmap.mapping import build_pool_state
    from ceph_tpu_torch.recovery import pipeline
    from ceph_tpu_torch.recovery.peering import PeeringEngine

    t0 = time.perf_counter()
    gates = {}
    runtime, driver = graphs.runtime_versions()
    out = {"phase": "pipeline", "torch": torch.__version__, "torch_cuda": torch.version.cuda,
           "cuda_runtime": runtime, "cuda_driver": driver,
           "capture_mode": graphs.CAPTURE_MODE}

    # five chaos epochs with one key through a cache of their own, then a
    # CRUSH reweight (same key, other tables), then both tiers' engines
    base = build_osdmap(n_osds, pg_num=pg_num, size=11, pool_kind="erasure")
    cache = pipeline.PipelineCache()
    pgs = torch.arange(pg_num, dtype=torch.int64, device=dev)
    reset()
    epochs, fns, checks = [], [], []
    m_prev = base
    specs = ["rack:0:down_out", "osd:100:down", "osd:101:out", "osd:100:up",
             "host:host3_0:down"][:PIPELINE_EPOCHS] + ["crush_reweight"]
    for spec in specs:
        m = copy.deepcopy(m_prev)
        if spec == "crush_reweight":
            crush_reweight(m)
        else:
            rec.inject(m, spec)
        pool = m.pools[1]
        crush_arg, fn = pipeline.compile_fused_peering(
            m.crush.to_dense(), pool, m.crush.rules[pool.crush_rule], cache=cache, device=dev)
        fns.append(fn)
        sp = build_pool_state(m_prev, m_prev.pools[1], device=dev)
        sc = build_pool_state(m, pool, device=dev)
        res = []
        wall, ev = event_ms(lambda: res.append(fn(crush_arg, sp, sc, pgs, pool.min_size)))
        epochs.append({"spec": spec, "wall_ms": wall, "event_ms": ev})
        checks.append((m, sp, sc, res[0]))
        m_prev = m
    cur = build_osdmap(n_osds, pg_num=pg_num, size=11, pool_kind="erasure")
    prev = copy.deepcopy(cur)
    rec.inject(cur, RECOVERY_FAILURE)
    gen = general_osdmap(pg_num)
    gen_prev = copy.deepcopy(gen)
    for o in range(0, n_osds, 32):
        gen.osd_weight[o] = 0
    gen.mark_down(100)
    cases = {"config4": (prev, cur), "general": (gen_prev, gen)}
    engines, fused_runs = {}, {}
    for name, (mp, mc) in cases.items():
        eng = PeeringEngine(mc, 1, device=dev)
        sp = build_pool_state(mp, mp.pools[1], device=dev)
        sc = build_pool_state(mc, mc.pools[1], device=dev)
        fused_runs[name] = eng.run(sp, sc)
        engines[name] = (eng, sp, sc)
    torch.cuda.synchronize()
    out["launches"] = counts()

    out["epochs"] = epochs
    fused = fns[0]
    gates["one_program"] = all(fn is fused for fn in fns)
    out["cache"] = cache.stats()
    out["captures"], out["replays"] = fused.captures, fused.replays
    gates["one_miss_then_hits"] = cache.stats() == {
        "entries": 1, "hits": len(specs) - 1, "misses": 1, "evictions": 0}
    gates["one_capture"] = fused.captures == 1 and fused.replays == len(specs)
    out["graph"] = graph_record(fused.graphs()[0])
    out["program_device_bytes"] = fused.device_bytes()
    # every epoch (the reweight too) equal to a staged pass on its own map
    for rec_, (m, sp, sc, got) in zip(epochs, checks):
        rec_["equal"] = peer_equal(got, PeeringEngine(m, 1, device=dev).run_staged(sp, sc))
    gates["epochs_bit_equal_staged"] = all(all(e["equal"].values()) for e in epochs)

    # the graph equal to the staged pass, on both device tiers
    out["tiers"] = {}
    fields = ("up", "up_primary", "acting", "acting_primary", "prev_acting", "flags",
              "survivor_mask", "n_alive")
    for name, (eng, sp, sc) in engines.items():
        got, want = fused_runs[name], eng.run_staged(sp, sc)
        equal = {f: bool(np.array_equal(getattr(got, f), getattr(want, f))) for f in fields}
        gates[f"{name}_bit_equal"] = all(equal.values())
        mc = eng.osdmap
        dense = mc.crush.to_dense()
        sig = runner_signature(dense, mc.crush.rules[mc.pools[1].crush_rule], mc.pools[1].size)
        out["tiers"][name] = {"tier": sig[0], "equal": equal, "counts": got.counts(),
                              "graph": graph_record(eng._fused.graphs()[0]),
                              "program_device_bytes": eng._fused.device_bytes()}
    gates["general_is_general"] = out["tiers"]["general"]["tier"] == "general"
    host = build_osdmap(32, pg_num=32)
    for b in host.crush.buckets.values():
        if host.crush.types[b.type_id] == "host":
            b.alg = ALG_LIST
    host.crush._mutated()
    hpool = host.pools[1]
    gates["host_tier_no_program"] = pipeline.compile_fused_peering(
        host.crush.to_dense(), hpool, host.crush.rules[hpool.crush_rule], device=dev) == (None,
                                                                                          None)

    # one call of each path under the guard
    eng, sp, sc = engines["config4"]
    guard = {}
    for name, fn in (("staged_run", lambda: eng.run_staged(sp, sc)),
                     ("fused_run", lambda: eng.run(sp, sc)),
                     ("replay", lambda: eng._fused(eng._fused_arg, sp, sc, eng._pgs,
                                                   eng.pool.min_size))):
        with runtime_guard.track(sync_debug=True) as g:
            fn()
            torch.cuda.synchronize()
        guard[name] = {"kernel_calls": dict(g.launch_counter.calls),
                       "kernel_launches": dict(g.launch_counter.launches),
                       "replayed_launches": dict(g.launch_counter.replays),
                       "host_reads": g.host_transfers,
                       "sync_warnings": g.transfer_counter.sync_warnings,
                       "builds_and_captures": g.n_compiles}
    out["guard"] = guard
    gates["replay_no_wrapper_call"] = guard["replay"]["kernel_calls"] == {}
    # a replay's launches are counted, those of its WHILE bodies too
    sure = eng._fused.graphs()[0].sure.get("descend", 0)
    gates["replay_launches_counted"] = (
        guard["replay"]["kernel_launches"] == guard["replay"]["replayed_launches"]
        and guard["replay"]["kernel_launches"].get("descend", 0) > sure)
    gates["replay_no_host_read"] = guard["replay"]["host_reads"] == 0
    gates["replay_no_capture"] = guard["replay"]["builds_and_captures"] == 0

    # both paths in turns
    out["turns"] = {}
    for name, (eng, sp, sc) in engines.items():
        out["turns"][name] = turns_ms({"staged": lambda: eng.run_staged(sp, sc),
                                       "fused": lambda: eng.run(sp, sc)}, reps)

    # config 7's dense dirty branch: eager against the graph
    m7 = build_osdmap(EPOCH_PEER_OSDS, pg_num=EPOCH_PEER_PGS, size=6, pool_kind="erasure")
    d = rec.EpochDriver(m7, rec.build_scenario("flap", m7), n_ops=64, device=dev)
    dirty = copy.deepcopy(m7)
    rec.inject(dirty, "rack:1:down")
    state = replace(d._init_state, pool=build_pool_state(dirty, dirty.pools[1], device=dev))
    fused_half = d._fused

    def eager():
        d._fused = None
        try:
            return d._peer_hist(state)
        finally:
            d._fused = fused_half

    a, b = eager(), d._peer_hist(state)
    names = ("up", "up_primary", "acting", "acting_primary", "flags", "survivor_mask",
             "n_alive", "pg_hist", "pg_aux")
    gates["peer_hist_graph_equals_eager"] = all(
        torch.equal(getattr(a, f), getattr(b, f)) for f in names)
    out["epoch_peer_hist"] = {
        "osds": EPOCH_PEER_OSDS, "pgs": EPOCH_PEER_PGS, "dirty": "rack:1:down",
        "graphs": [graph_record(g) for g in fused_half.graphs()],
        "turns": turns_ms({"eager": eager, "graph": lambda: d._peer_hist(state)}, reps)}
    out["gates"] = gates
    out["seconds"] = time.perf_counter() - t0
    return out


#: calls of each way the general phase times in turns
GENERAL_TURNS = 2
GENERAL_PROFILED = "b_mixed_ec"  # the map whose compacted call is profiled


def phase_general(dev, counts, reset, n: int = OBJECTS) -> dict:
    """The general engine on the card: (a) a uniform 1024-OSD hierarchy
    (32 racks of 8 hosts of 4 OSDs) under its replicated rule; (b) the
    same shape with straw2 root and racks over uniform hosts, 32 OSDs
    reweighted to 0, under a replicated and an EC rule (6 slots).  Each:
    the router's tier, host syncs and K1 launches of one call, n objects
    timed with compacted retry rounds (the default at this size) and
    masked ones in turns (median of GENERAL_TURNS each, host clock; the
    two results equal), a profile of one compacted call of GENERAL_PROFILED,
    and 65,536 placements
    (compacted, the threshold) and the same masked equal to the C++
    tier.  Returns the path's launch counts (one call of each map)."""
    from ceph_tpu_torch.crush import interp, interp_batch
    from ceph_tpu_torch.crush.engine import make_batch_runner, runner_signature
    from ceph_tpu_torch.crush.map import ALG_UNIFORM
    from ceph_tpu_torch.models.clusters import build_hierarchy
    from ceph_tpu_torch.testing import cppref

    uniform = build_hierarchy([("rack", 32), ("host", 8)], osds_per_leaf=4, alg=ALG_UNIFORM)
    mixed = mixed_hierarchy(32, 8, 4)
    out_w = np.full(1024, 0x10000, np.uint32)
    out_w[np.random.default_rng(SEED).choice(1024, 32, replace=False)] = 0
    cases = {
        "a_uniform_replicated": (uniform, "replicated_rule", REPLICAS,
                                 np.full(1024, 0x10000, np.uint32)),
        "b_mixed_replicated": (mixed, "replicated_rule", REPLICAS, out_w),
        "b_mixed_ec": (mixed, "ec_rule", 6, out_w),
    }
    xs = torch.arange(n, dtype=torch.int64, device=dev)
    out, runs = {}, {}
    for label, (m, rule_name, rm, w) in cases.items():
        dense, rule = m.to_dense(), m.rule_by_name(rule_name)
        tier = runner_signature(dense, rule, rm)[0]
        if tier != "general":
            raise AssertionError(f"{label}: routed to the {tier} tier")
        crush_arg, fn = make_batch_runner(dense, rule, rm, device=dev)
        runs[label] = (dense, rule, rm, w, fn, crush_arg)
    reset()
    results = {}
    for label, (dense, rule, rm, w, fn, crush_arg) in runs.items():
        before, syncs = counts()["negdraw"], interp_batch.HOST_SYNCS
        results[label] = fn(crush_arg, w, xs)
        torch.cuda.synchronize()
        out[label] = {"rule": rule.name, "result_max": rm,
                      "k1_launches_per_call": counts()["negdraw"] - before,
                      "host_syncs_per_call": interp_batch.HOST_SYNCS - syncs,
                      "out_osds": int((w == 0).sum())}
    launches = counts()
    steps_of = lambda rule: [(s.op, s.arg1, s.arg2) for s in rule.steps]
    k = interp.COMPACT_MIN_BATCH
    for label, (dense, rule, rm, w, fn, crush_arg) in runs.items():
        run = lambda fn=fn, ca=crush_arg, w=w: fn(ca, w, xs)
        syncs = interp_batch.HOST_SYNCS
        with masked_rounds():
            res_m, lens_m = run()
        out[label]["masked_host_syncs_per_call"] = interp_batch.HOST_SYNCS - syncs
        res, lens = results[label]
        if not (torch.equal(res, res_m) and torch.equal(lens, lens_m)):
            raise AssertionError(f"{label}: compacted and masked rounds differ")
        times = in_turns({"compacted": run, "masked": masked(run)}, GENERAL_TURNS)
        for way, secs in times.items():
            sec = float(np.median(secs))
            out[label][way] = {"seconds": sec, "all_seconds": secs, "placements_per_s": n / sec}
        out[label]["placements_per_s"] = out[label]["compacted"]["placements_per_s"]
        if label == GENERAL_PROFILED:
            out[label]["profile"] = profile_call(run)
        sample = np.arange(k, dtype=np.uint32)
        rr, ll = cppref.do_rule_batch(dense, steps_of(rule), sample, w, rm)
        for way, call in (("compacted", lambda: fn(crush_arg, w, sample)),
                          ("masked", masked(lambda: fn(crush_arg, w, sample)))):
            sres, slens = call()
            if not (np.array_equal(sres.cpu().numpy(), rr)
                    and np.array_equal(slens.cpu().numpy(), ll)):
                raise AssertionError(f"{label}: the general engine ({way}) differs from C++")
        if res.shape != (n, rm) or not np.array_equal(res[:k].cpu().numpy(), rr):
            raise AssertionError(f"{label}: the 1M-object run differs from the C++ tier")
        out[label].update(cpp_sample=k, equal_cpp=True,
                          none_slots=int((res == 0x7FFFFFFF).sum()))
        if label.startswith("b_") and out[label]["k1_launches_per_call"] <= 0:
            raise AssertionError(f"{label}: the straw2 levels never launched K1")
    return {"phase": "general", "objects": n, "tier": "general", "maps": out,
            "launches": launches}


# BASELINE config 5: a failure-driven rebalance of 100M objects on a
# 10k-OSD straw2 map (bench/config5_rebalance_sim.py's configuration)
REBALANCE_OSDS = 10_000
REBALANCE_FAILED = 100          # 1% of the OSDs out
REBALANCE_CHUNK = 1 << 20
REBALANCE_CHUNKS_PER_LAUNCH = 8
REBALANCE_LAUNCHES = 12         # 12 x 8 x 2^20 = 100,663,296 objects >= 100M
REBALANCE_SAMPLE = 16_384


def phase_rebalance(dev, counts, reset) -> dict:
    """Config 5 at its own size: build_simple(10000, 8 OSDs a host, 16
    hosts a rack), 3 replicas, 100 OSDs out; 12 launches of 8 chunks of
    2^20 objects (every object of 100M placed): placements/s (2 x objects
    / seconds), the moved count and fraction beside the ideal 3.0%, K3
    launches, host syncs and peak memory; a profile of one launch (after
    the counts).  Gate: 16,384 objects at the start of the first launch
    and of the last are placed as the C++ tier places them, before and
    after, and their moved count is the C++ tier's."""
    from ceph_tpu_torch.crush import interp_batch
    from ceph_tpu_torch.crush.engine import make_batch_runner
    from ceph_tpu_torch.models.clusters import build_simple
    from ceph_tpu_torch.parallel.placement import sharded_rebalance_sim
    from ceph_tpu_torch.testing import cppref

    m = build_simple(REBALANCE_OSDS, osds_per_host=8, hosts_per_rack=16)
    rule = m.rule_by_name("replicated_rule")
    dense = m.to_dense()
    w_before = np.full(dense.max_devices, 0x10000, np.uint32)
    w_after = w_before.copy()
    failed = np.random.default_rng(0).choice(REBALANCE_OSDS, REBALANCE_FAILED, replace=False)
    w_after[failed] = 0
    per_launch = REBALANCE_CHUNK * REBALANCE_CHUNKS_PER_LAUNCH
    objects = per_launch * REBALANCE_LAUNCHES
    ideal = REBALANCE_FAILED * REPLICAS / REBALANCE_OSDS
    step = sharded_rebalance_sim(None, dense, rule, REPLICAS, REBALANCE_CHUNK,
                                 REBALANCE_CHUNKS_PER_LAUNCH, device=dev)
    reset()
    syncs = interp_batch.HOST_SYNCS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    moved = int(sum(step(w_before, w_after, i * per_launch) for i in range(REBALANCE_LAUNCHES)))
    sec = time.perf_counter() - t0
    launches = counts()
    out = {"seconds": sec, "placements_per_s": 2 * objects / sec, "moved": moved,
           "moved_fraction": moved / objects, "k3_launches": launches["descend"],
           "host_syncs": interp_batch.HOST_SYNCS - syncs,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "profile_one_launch": profile_call(lambda: step(w_before, w_after, 0))}
    steps = [(s.op, s.arg1, s.arg2) for s in rule.steps]
    crush_arg, fn = make_batch_runner(dense, rule, REPLICAS, device=dev)
    sample_sim = sharded_rebalance_sim(None, dense, rule, REPLICAS, REBALANCE_SAMPLE, 1,
                                       device=dev)
    samples = []
    for start in (0, (REBALANCE_LAUNCHES - 1) * per_launch):
        xs = np.arange(start, start + REBALANCE_SAMPLE, dtype=np.uint32)
        cpp = [cppref.do_rule_batch(dense, steps, xs, w, REPLICAS) for w in (w_before, w_after)]
        card = [fn(crush_arg, w, xs) for w in (w_before, w_after)]
        equal = all(np.array_equal(c[0].cpu().numpy(), p[0]) and
                    np.array_equal(c[1].cpu().numpy(), p[1]) for c, p in zip(card, cpp))
        cpp_moved = int((cpp[0][0] != cpp[1][0]).any(axis=1).sum())
        sim_moved = int(sample_sim(w_before, w_after, start))
        samples.append({"start": start, "objects": REBALANCE_SAMPLE, "equal_cpp": equal,
                        "moved": sim_moved, "cpp_moved": cpp_moved})
        if not equal or sim_moved != cpp_moved:
            raise AssertionError(f"rebalance sample at {start} differs from the C++ tier")
    return {"phase": "rebalance", "osds": REBALANCE_OSDS, "failed_osds": REBALANCE_FAILED,
            "objects": objects, "launches_of_the_sim": REBALANCE_LAUNCHES,
            "chunk": REBALANCE_CHUNK, "chunks_per_launch": REBALANCE_CHUNKS_PER_LAUNCH,
            "devices": 1, "ideal_moved_fraction": ideal, **out, "samples": samples,
            "launches": launches}


def scalar_sample(m, mp, rng, pool_id: int = 1) -> int:
    """Hold ``SCALAR_SAMPLE`` PGs of the mapping ``mp`` against the scalar
    pipeline (``pg_to_up_acting_osds``, CRUSH on the C++ tier)."""
    from ceph_tpu_torch.osdmap import PGId

    pg_num = m.pools[pool_id].pg_num
    for ps in sorted(int(v) for v in rng.choice(pg_num, SCALAR_SAMPLE, replace=False)):
        pg = PGId(pool_id, ps)
        if mp.get(pg) != m.pg_to_up_acting_osds(pg):
            raise AssertionError(f"pg {pg}: {mp.get(pg)} != {m.pg_to_up_acting_osds(pg)}")
    return SCALAR_SAMPLE


def plan_rows(inc) -> tuple[list, list]:
    return (sorted((pg.pool, pg.ps, tuple(v)) for pg, v in inc.new_pg_upmap_items.items()),
            sorted((pg.pool, pg.ps) for pg in inc.old_pg_upmap_items))


def scorer_plan(start, scorer: str, dev) -> tuple:
    """The first plan of ``calc_pg_upmaps`` with ``scorer`` on a copy of
    ``start`` whose mapping is already built on ``dev``, and its times:
    the call's seconds and each scorer call's ms on the host's clock
    (the device scorer's call ends with its copy back, so the clock
    holds its device work)."""
    import copy

    from ceph_tpu_torch.balancer import calc_pg_upmaps, upmap
    from ceph_tpu_torch.osdmap import OSDMapMapping

    m = copy.deepcopy(start)
    mp = OSDMapMapping(m, device=dev)
    mp.update()
    fn_name = {"device": "_score_candidate_moves_device",
               "numpy": "_score_candidate_moves_np"}[scorer]
    inner = getattr(upmap, fn_name)
    calls_ms: list[float] = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        calls_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(upmap, fn_name, timed)
    try:
        t0 = time.perf_counter()
        plan = calc_pg_upmaps(m, max_deviation=BALANCER_MAX_DEVIATION,
                              max_entries=BALANCER_MAX_OPTIMIZATIONS, mapping=mp,
                              scorer=scorer)
        secs = time.perf_counter() - t0
    finally:
        setattr(upmap, fn_name, inner)
    return plan, {"seconds": secs, "scorer_ms": float(sum(calls_ms)), "scorer_calls_ms": calls_ms}


def phase_balancer(dev, launch_counts, reset_launches, n_osds: int = BALANCER_OSDS,
                   pg_num: int = BALANCER_PGS, golden_sha: str | None = None) -> dict:
    """BASELINE config 3 on the card: (a) bulk remaps of
    ``build_osdmap(n_osds, pg_num)``, one reweight toggled before each,
    as PG mappings/s; (b) the upmap balancer on
    ``build_skewed_osdmap(n_osds, pg_num)`` (``optimize`` + ``execute``
    until a plan is empty), its table's SHA-256 against
    ``golden_sha`` (default: the stored config-3 digest), converged, its
    first plan equal to the first plan of each scorer, timed side by
    side (``scorer_plan``), its mapping equal to the scalar pipeline; (c) one crush-compat tick on a fresh skewed map,
    not worse, equal to the C++ tier under the new weight set.  The
    launch counts cover (a), (b)'s loop and (c), not the checks."""
    import copy

    from ceph_tpu_torch.balancer import Balancer, upmap
    from ceph_tpu_torch.models.clusters import build_osdmap, build_skewed_osdmap
    from ceph_tpu_torch.osdmap import OSDMapMapping
    from ceph_tpu_torch.testing import golden

    rng = np.random.default_rng(SEED + 3)
    path_counts: dict[str, int] = {}

    def tally() -> None:
        for kname, v in launch_counts().items():
            path_counts[kname] = path_counts.get(kname, 0) + v

    # (a) bulk remap
    m = build_osdmap(n_osds, pg_num=pg_num)
    reset_launches()
    t0 = time.perf_counter()
    mp = OSDMapMapping(m, device=dev)
    mp.update()
    first_s = time.perf_counter() - t0
    secs = []
    for i in range(BALANCER_REMAPS):
        m.osd_weight[i] = 0xFFFF if m.osd_weight[i] == 0x10000 else 0x10000
        t0 = time.perf_counter()
        mp.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    tally()
    rates = [pg_num / s for s in secs]
    remap = {"pgs": pg_num, "first_update_s": first_s, "update_s": secs,
             "pg_mappings_per_s": float(np.median(rates)),
             "pg_mappings_per_s_low_high": [min(rates), max(rates)],
             "sample_checked": scalar_sample(m, mp, rng)}
    del m, mp

    # (b) the optimizer loop, the device scorer timed by CUDA events
    ms = build_skewed_osdmap(n_osds, pg_num=pg_num)
    start = copy.deepcopy(ms)
    score_ms: list[float] = []
    admissible: list[int] = []
    remap_s: list[float] = []
    inner = upmap._score_candidate_moves_device

    def timed_scorer(*args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(*args, **kwargs)
        b.record()
        b.synchronize()
        score_ms.append(a.elapsed_time(b))
        admissible.append(len(out[0]))
        return out

    bal = Balancer(ms, max_deviation=BALANCER_MAX_DEVIATION,
                   max_optimizations=BALANCER_MAX_OPTIMIZATIONS, device=dev)
    update = bal.mapping.update

    def timed_update(*args, **kwargs):
        t0 = time.perf_counter()
        update(*args, **kwargs)
        remap_s.append(time.perf_counter() - t0)

    dev_before = max(bal.evaluate().pool_max_deviation.values())
    plans, first_plan = [], None
    upmap._score_candidate_moves_device = timed_scorer
    bal.mapping.update = timed_update
    reset_launches()
    try:
        t_loop = time.perf_counter()
        for _ in range(32):
            score_ms.clear()
            admissible.clear()
            remap_s.clear()
            t0 = time.perf_counter()
            plan = bal.optimize()
            sec = time.perf_counter() - t0
            st = upmap.LAST_RUN_STATS
            first_plan = first_plan or plan
            plans.append({"new": len(plan.new_pg_upmap_items),
                          "removed": len(plan.old_pg_upmap_items), "seconds": sec,
                          **st.as_dict(), "scorer_device_ms": float(sum(score_ms)),
                          "scorer_calls_ms": list(score_ms), "admissible": list(admissible),
                          "remaps": len(remap_s), "remap_s": float(sum(remap_s)),
                          "host_rest_s": sec - float(sum(remap_s)) - float(sum(score_ms)) / 1e3})
            if not bal.execute(plan):
                break
        loop_s = time.perf_counter() - t_loop
    finally:
        upmap._score_candidate_moves_device = inner
        del bal.mapping.update
    tally()
    ev = bal.evaluate()
    final_dev = max(ev.pool_max_deviation.values())
    sha = golden.upmap_table_sha256(ms.pg_upmap_items)
    want_sha = golden_sha or golden.CONFIG3_UPMAP_SHA256
    if sha != want_sha:
        raise AssertionError(f"config-3 upmap table {sha} != {want_sha}")
    if final_dev > BALANCER_MAX_DEVIATION:
        raise AssertionError(f"balancer did not converge: max deviation {final_dev}")
    scorers = {name: scorer_plan(start, name, dev) for name in upmap.SCORERS}
    for name, (plan, _) in scorers.items():
        if plan_rows(plan) != plan_rows(first_plan):
            raise AssertionError(f"the {name} scorer's first plan differs from the loop's")
    bal.mapping.update()
    optimizer = {
        "osds": n_osds, "pgs": pg_num, "max_deviation_before": dev_before,
        "plans": plans, "loop_s": loop_s, "max_deviation_after": final_dev,
        "converged": True, "epoch": ms.epoch, "upmap_pgs": len(ms.pg_upmap_items),
        "upmap_pairs": sum(len(v) for v in ms.pg_upmap_items.values()),
        "table_sha256": sha, "numpy_plan_equal": True,
        "first_plan_by_scorer": {name: t for name, (_, t) in scorers.items()},
        "sample_checked": scalar_sample(ms, bal.mapping, rng),
    }
    prof_map = copy.deepcopy(start)
    prof_bal = Balancer(prof_map, max_deviation=BALANCER_MAX_DEVIATION,
                        max_optimizations=BALANCER_MAX_OPTIMIZATIONS, device=dev)
    prof_plans = []
    optimizer["profile_first_optimize"] = profile_call(
        lambda: prof_plans.append(prof_bal.optimize()))
    if plan_rows(prof_plans[0]) != plan_rows(first_plan):
        raise AssertionError("the profiled first optimize() gave another plan")
    del ms, start, bal, prof_map, prof_bal

    # (c) crush-compat: one tick on a fresh skewed map
    mc = build_skewed_osdmap(n_osds, pg_num=pg_num)
    cbal = Balancer(mc, mode="crush-compat", max_deviation=BALANCER_MAX_DEVIATION, device=dev)
    before = max(cbal.evaluate().pool_max_deviation.values())
    version = mc.crush.version
    reset_launches()
    t0 = time.perf_counter()
    changed = cbal.tick()
    tick_s = time.perf_counter() - t0
    tally()
    after = max(cbal.evaluate().pool_max_deviation.values())
    if after > before:
        raise AssertionError(f"crush-compat made the deviation worse: {before} -> {after}")
    cbal.mapping.update()
    compat = {"tick_s": tick_s, "changed": changed, "max_deviation_before": before,
              "max_deviation_after": after, "crush_versions": mc.crush.version - version,
              "sample_checked": scalar_sample(mc, cbal.mapping, rng)}
    return {"phase": "balancer", "bulk_remap": remap, "optimizer": optimizer,
            "crush_compat": compat, "launches": path_counts}


def run_cli(main_fn, argv) -> tuple[int, str, float]:
    """(exit code, standard output, seconds) of one CLI ``main(argv)``."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def phase_cli(dev, launch_counts, reset_launches, work_dir: str,
              n_osds: int = BALANCER_OSDS, pg_num: int = BALANCER_PGS,
              max_x: int = 65535, ec_size: int = 16 * MIB) -> dict:
    """The harnesses through their ``main()`` on the card: crushtool
    ``--test`` on build_simple(n_osds) equal to ``--cpu``; osdmaptool
    ``--createsimple``, ``--test-map-pgs`` and ``--upmap``, whose command
    file must hold ``calc_pg_upmaps``'s plan for the same saved map (the
    gate checks the plan; the file's text is held to the reference's in
    ``tests/test_torch_cli.py``); ec_bench for reed_sol_van and
    cauchy_good k=8 m=3, then one ``ec_size`` object encoded on the card
    equal to the CPU's encode.  The launch counts cover the CLIs' runs,
    not the checks (``--cpu``, the plan, the encodes)."""
    from ceph_tpu_torch.balancer import calc_pg_upmaps
    from ceph_tpu_torch.cli import crushtool, ec_bench, osdmaptool
    from ceph_tpu_torch.ec import create
    from ceph_tpu_torch.models.clusters import build_simple

    path_counts: dict[str, int] = {}

    def tally() -> None:
        for kname, v in launch_counts().items():
            path_counts[kname] = path_counts.get(kname, 0) + v

    crush_path = os.path.join(work_dir, "simple.json")
    with open(crush_path, "wb") as f:
        f.write(build_simple(n_osds).encode())
    argv = ["-i", crush_path, "--test", "--show-statistics", "--show-mappings",
            "--max-x", str(max_x)]
    on_dev = ["--device", dev.type]
    reset_launches()
    rc, card_out, card_s = run_cli(crushtool.main, argv + on_dev)
    tally()
    rc_cpu, cpu_out, cpu_s = run_cli(crushtool.main, argv + ["--cpu"])
    if rc or rc_cpu or card_out != cpu_out or card_out.count("\n") != max_x + 2:
        raise AssertionError("crushtool --test on the card differs from --cpu")
    out = {"phase": "cli", "crushtool": {
        "map": f"build_simple({n_osds})", "xs": max_x + 1, "card_s": card_s, "cpu_s": cpu_s,
        "statistics": [ln for ln in card_out.splitlines() if ln.startswith("rule ")],
        "equal_cpu": True}}

    map_path = os.path.join(work_dir, "osdmap.json")
    cmd_path = os.path.join(work_dir, "upmap.sh")
    reset_launches()
    rc, _, create_s = run_cli(osdmaptool.main, [map_path, "--createsimple", str(n_osds),
                                                "--pg-num", str(pg_num)])
    rc2, test_out, test_s = run_cli(osdmaptool.main, [map_path, "--test-map-pgs"] + on_dev)
    rc3, upmap_out, upmap_s = run_cli(osdmaptool.main, [map_path, "--upmap", cmd_path,
                                                        "--upmap-max", "2000"] + on_dev)
    tally()
    with open(cmd_path) as f:
        written = f.read()
    plan = calc_pg_upmaps(osdmaptool.load(map_path), max_deviation=1.0, max_entries=2000,
                          device=dev)
    want = "".join(ln + "\n" for ln in osdmaptool.upmap_commands(plan))
    if rc or rc2 or rc3 or written != want or not written:
        raise AssertionError("osdmaptool --upmap's command file is not calc_pg_upmaps's plan")
    out["osdmaptool"] = {
        "osds": n_osds, "pgs": pg_num, "createsimple_s": create_s, "test_map_pgs_s": test_s,
        "test_map_pgs": [ln for ln in test_out.splitlines()
                         if ln.startswith(("avg", "min", "mapping time"))],
        "upmap_s": upmap_s, "upmap": upmap_out.strip(), "commands": written.count("\n"),
        "rm_commands": written.count("rm-pg-upmap-items"), "file_equal_plan": True}

    out["ec_bench"] = {}
    obj = np.random.default_rng(SEED + 4).integers(0, 256, ec_size, dtype=np.uint8)
    for name, params in (("reed_sol_van_8_3", ["technique=reed_sol_van"]),
                         ("cauchy_good_8_3_p2048", ["technique=cauchy_good", "packetsize=2048"])):
        kvs = ["k=8", "m=3"] + params
        profile = {"plugin": "jerasure", **dict(kv.split("=") for kv in kvs)}
        args = ["--plugin", "jerasure", "--size", str(ec_size), "--iterations", "10"] + on_dev
        args += [a for kv in kvs for a in ("--parameter", kv)]
        reset_launches()
        rc, line, _ = run_cli(ec_bench.main, args)
        tally()
        fields = line.strip().split("\t")
        if rc or len(fields) != 2 or not fields[1].endswith(" MB/s"):
            raise AssertionError(f"ec_bench {name} printed {line!r}")
        want_chunks, got_chunks = (create(profile, device=d).encode(set(range(11)), obj)
                                   for d in ("cpu", dev))
        chunk = len(got_chunks[0])
        if sorted(got_chunks) != sorted(want_chunks) or any(
                not np.array_equal(got_chunks[i], want_chunks[i]) for i in want_chunks):
            raise AssertionError(f"ec_bench {name}: the card's encode differs from the CPU's")
        out["ec_bench"][name] = {"size": ec_size, "line": line.strip(), "chunk_bytes": chunk,
                                 "encode_equal_cpu": True}
    out["launches"] = path_counts
    return out


MD_CHUNK = 4096                 # shard bytes a PG in the mesh executor (config 4's map)
MD_GENERAL_OBJECTS = 1 << 16
MD_REBALANCE = (1 << 16, 4)     # chunk, chunks: 262,144 objects before and after
MD_DECODE_WIDTHS = (8 * MIB + 13, 8 * MIB)  # K4 unaligned and TMA variants, k=8 m=3
MD_SCRUB = (1024, 11, 4096)     # PGs, shards, chunk
MD_TRAFFIC_OPS = 65536
MD_CHIPS = 4                    # virtual chips of the dispatcher on the card
# tests/test_dispatch.py's fault matrix, its chips taken modulo MD_CHIPS
MD_MATRIX = [("queued_drop_retry", ["chipdrop:3"]), ("queued_drop_convict", ["chipdrop:0"]),
             ("inflight_stall_hedge", ["chipstall:1.1"]),
             ("inflight_stall_convict", ["chipstall:1.0"]),
             ("inflight_slow_steal", ["chipslow:2.6"]), ("precommit_hedge_race", ["chipslow:1.9"]),
             ("combined", ["chipstall:0.0", "chipdrop:1", "chipslow:2.3"])]
MD_DISPATCH_WIDTHS = (6000, 3000, 9000)


def md_store(codec, pgs: np.ndarray, chunk: int, dev):
    """Seeded data for the degraded PGs (parity by one encode on the
    card): ``read_shard(pg, s)`` over one host array."""
    k = codec.get_data_chunk_count()
    data = card_bytes((k, len(pgs) * chunk), SEED + 13, dev)
    full = torch.cat([data, codec.codec.encode_async(data)]).cpu().numpy()
    col = {int(pg): i * chunk for i, pg in enumerate(pgs)}
    return full, lambda pg, s: full[s, col[pg]:col[pg] + chunk]


def shards_equal(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        sorted(a[pg]) == sorted(b[pg]) and all(np.array_equal(a[pg][s], b[pg][s]) for s in b[pg])
        for pg in b)


def dispatch_matrix(devices, specs, seed: int = 3) -> tuple:
    """The dispatcher over ``devices`` under ``specs`` on three seeded
    k=8 m=3 jobs: (outputs, stats, committed (seq, chip, t_start))."""
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ec.backend import TableEncoder
    from ceph_tpu_torch.recovery.dispatch import ChipFaultSchedule, WorkStealingDispatcher

    faults = ChipFaultSchedule.from_specs(specs, len(devices)) if specs else None
    disp = WorkStealingDispatcher(devices, Config(env={}), faults=faults, seed=seed)
    mat = gf.vandermonde_matrix(8, 3)
    enc = TableEncoder(mat, devices[0])
    jobs = []
    for i, w in enumerate(MD_DISPATCH_WIDTHS):
        src = np.random.default_rng(SEED + i).integers(0, 256, (8, w), dtype=np.uint8)
        jobs.append((disp.submit(enc, src), src))
    disp.drain()
    outs = [(disp.result(job), src) for job, src in jobs]
    committed = [sorted((s, lc.chip.chip_id, lc.t_start) for s, lc in job.committed.items())
                 for job, _ in jobs]
    return outs, dataclasses.asdict(disp.stats), committed


def phase_multidevice(dev, counts, reset, work_dir: str, n_osds: int = RECOVERY_OSDS,
                      pg_num: int = RECOVERY_PGS, objects: int = OBJECTS) -> dict:
    """Item 4 on the card: an NCCL world of one, every mesh path through
    its collectives equal to the single-device path, and the
    work-stealing dispatcher on virtual chips (see the module
    docstring).  The mesh paths run between ``reset()`` and
    ``counts()``; the single-device runs they are held to, the kernel
    checks and the dispatcher matrix run after."""
    import copy

    import torch.distributed as dist

    from ceph_tpu_torch import recovery as rec
    from ceph_tpu_torch.analysis.runtime_guard import assert_rank_identical
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.ec import create, gf, gf_kernels
    from ceph_tpu_torch.ec.backend import TableEncoder
    from ceph_tpu_torch.models.clusters import build_osdmap, build_simple
    from ceph_tpu_torch.obs import PGStateClassifier
    from ceph_tpu_torch.parallel import make_mesh, multihost
    from ceph_tpu_torch.parallel.placement import sharded_placement_step, sharded_rebalance_sim
    from ceph_tpu_torch.recovery.sharded import ShardedDecoder
    from ceph_tpu_torch.workload import TrafficEngine

    t0 = time.perf_counter()
    store_path = os.path.join(work_dir, "nccl_store")
    multihost.init(f"file://{store_path}", world_size=1, rank=0, device=dev.type)
    try:
        mesh = make_mesh(device=dev.type)
        backend = str(dist.get_backend())
        # inputs, made before the counts start
        simple = build_simple(1024)
        s_dense, s_rule = simple.to_dense(), simple.rule_by_name("replicated_rule")
        w = np.full(s_dense.max_devices, 0x10000, np.uint32)
        w_out = w.copy()
        w_out[np.random.default_rng(SEED).choice(1024, 32, replace=False)] = 0
        xs = torch.arange(objects, dtype=torch.int64, device=dev)
        mixed = mixed_hierarchy(32, 8, 4)
        g_dense, g_rule = mixed.to_dense(), mixed.rule_by_name("ec_rule")
        gxs = torch.arange(MD_GENERAL_OBJECTS, dtype=torch.int64, device=dev)
        mat = gf.vandermonde_matrix(8, 3)
        srcs = [card_bytes((8, wd), SEED + 21 + i, dev).cpu().numpy()
                for i, wd in enumerate(MD_DECODE_WIDTHS)]
        cur = build_osdmap(n_osds, pg_num=pg_num, size=11, pool_kind="erasure")
        prev = copy.deepcopy(cur)
        rec.inject(cur, RECOVERY_FAILURE)
        codes = {"rs_8_3_auto": RECOVERY_CODES["rs_8_3_auto"], "rs_8_3_on": RECOVERY_CODES["rs_8_3_on"]}
        codecs = {name: create(profile, device=dev) for name, (profile, _) in codes.items()}
        n_pg, n_sh, ch = MD_SCRUB
        scrub_clean = np.random.default_rng(SEED + 5).integers(0, 256, (n_pg, n_sh, ch),
                                                              dtype=np.uint8)
        scrub_rot = scrub_clean.copy()
        for pg, sh, b in ((3, 1, 7), (n_pg // 2, 10, 0), (n_pg - 1, 4, ch - 1)):
            scrub_rot[pg, sh, b] ^= 0x5A

        reset()
        t_mesh = time.perf_counter()
        mesh_out: dict = {}
        mesh_out["placement"] = sharded_placement_step(mesh, s_dense, s_rule, REPLICAS,
                                                       gather=True)(w_out, xs)
        mesh_out["general"] = sharded_placement_step(mesh, g_dense, g_rule, 6, gather=True)(
            w_out, gxs)
        mesh_out["rebalance"] = int(sharded_rebalance_sim(mesh, s_dense, s_rule, REPLICAS,
                                                          *MD_REBALANCE)(w, w_out, 0))
        dec = ShardedDecoder(mesh)
        enc = TableEncoder(mat, dev)
        mesh_out["decode"] = [dec.decode(enc, src, MD_CHUNK) for src in srcs]
        peering = rec.peer_pool(prev, cur, 1, device=dev)
        plan_by, store_by = {}, {}
        cfg_by = {}
        for name, (profile, mode) in codes.items():
            cfg = Config(env={})
            cfg.set("recovery_xor_schedule", mode)
            cfg.set("recovery_shard_min_bytes", 0)
            cfg_by[name] = cfg
            plan_by[name] = rec.build_plan(peering, codecs[name])
            store_by[name] = md_store(codecs[name], peering.pgs_with(rec.PG_STATE_DEGRADED),
                                      MD_CHUNK, dev)
            mesh_out[name] = rec.RecoveryExecutor(codecs[name], config=cfg, mesh=mesh).run(
                plan_by[name], store_by[name][1])
        sc = rec.Scrubber(n_pg, n_sh, mesh=mesh)
        sc.build_checksums(lambda pg, s_: scrub_clean[pg, s_])
        mesh_out["scrub"] = sc.scrub(lambda pg, s_: scrub_rot[pg, s_])
        mesh_out["traffic"] = TrafficEngine(
            lambda: 0.0, n_osds, pg_num, 8, 11, peering.min_size, ops_per_step=MD_TRAFFIC_OPS,
            mesh=mesh).observe(peering).to_dict()
        mesh_out["pg_states"] = PGStateClassifier(mesh)(peering, 8)
        assert_rank_identical("multidevice", np.arange(8), mesh=mesh)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t_mesh
        launches = counts()

        # the single-device paths, held bit for bit
        want_backend = "nccl" if dev.type == "cuda" else "gloo"
        gates = {"process_group": backend == want_backend and mesh.group is not None
                 and mesh.size == 1}
        res, lens, hist = mesh_out["placement"]
        one = sharded_placement_step(None, s_dense, s_rule, REPLICAS, device=dev)(w_out, xs)
        gates["placement_equal"] = all(torch.equal(a, b) for a, b in zip((res, lens, hist), one))
        one = sharded_placement_step(None, g_dense, g_rule, 6, device=dev)(w_out, gxs)
        gates["general_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(mesh_out["general"], one))
        moved = int(sharded_rebalance_sim(None, s_dense, s_rule, REPLICAS, *MD_REBALANCE,
                                          device=dev)(w, w_out, 0))
        gates["rebalance_equal"] = moved == mesh_out["rebalance"] and moved > 0
        decode_rows = []
        for (out, nb, sh), src, wd in zip(mesh_out["decode"], srcs, MD_DECODE_WIDTHS):
            want = enc.encode(src)
            data = torch.from_numpy(src).to(dev)
            kernel = gf_kernels.matrix_encode(enc.tables, data, enc.nibbles)
            plain = gf_kernels.matrix_encode_plain(enc.tables, data)
            ok, err = compare(kernel, plain)
            decode_rows.append({"width": wd, "aligned": wd % 16 == 0, "equal": bool(
                np.array_equal(out, want)) and nb == 3 * wd and sh == 3 * wd // MD_CHUNK,
                "k4_vs_plain": ok, "max_abs_err": err})
        gates["decode_equal"] = all(r["equal"] for r in decode_rows)
        gates["k4_variants_equal_plain"] = all(r["k4_vs_plain"] for r in decode_rows)
        exec_rows = {}
        for name in codes:
            m_res = mesh_out[name]
            single = rec.RecoveryExecutor(codecs[name], config=cfg_by[name], device=dev).run(
                plan_by[name], store_by[name][1])
            read = store_by[name][1]
            truth = all(np.array_equal(m_res.shards[int(pg)][s_], read(int(pg), s_))
                        for g in plan_by[name].groups for pg in g.pgs for s_ in g.missing)
            exec_rows[name] = {"launches": m_res.launches,
                               "sharded_launches": m_res.sharded_launches,
                               "schedule_launches": m_res.schedule_launches,
                               "bytes_rebuilt": m_res.bytes_recovered,
                               "psum_bytes_rebuilt": m_res.psum_bytes_rebuilt,
                               "equal": shards_equal(m_res.shards, single.shards) and truth}
        gates["executor_equal"] = all(r["equal"] for r in exec_rows.values())
        gates["executor_sharded"] = exec_rows["rs_8_3_auto"]["sharded_launches"] > 0 and (
            exec_rows["rs_8_3_auto"]["psum_bytes_rebuilt"]
            == exec_rows["rs_8_3_auto"]["bytes_rebuilt"])
        sc1 = rec.Scrubber(n_pg, n_sh, device=dev)
        sc1.build_checksums(lambda pg, s_: scrub_clean[pg, s_])
        r1, rm = sc1.scrub(lambda pg, s_: scrub_rot[pg, s_]), mesh_out["scrub"]
        gates["scrub_equal"] = (np.array_equal(r1.inconsistent_mask, rm.inconsistent_mask)
                                and np.array_equal(r1.hist, rm.hist)
                                and r1.n_inconsistent == rm.n_inconsistent == 3)
        t1 = TrafficEngine(lambda: 0.0, n_osds, pg_num, 8, 11, peering.min_size,
                           ops_per_step=MD_TRAFFIC_OPS, device=dev).observe(peering).to_dict()
        t1.pop("ops_per_sec_wall")
        mesh_out["traffic"].pop("ops_per_sec_wall")
        gates["traffic_equal"] = t1 == mesh_out["traffic"]
        p1 = PGStateClassifier(device=dev)(peering, 8)
        gates["pg_states_equal"] = all(np.array_equal(a, b)
                                       for a, b in zip(p1, mesh_out["pg_states"]))
        # the dispatcher on virtual chips of the card, against the CPU
        t_disp = time.perf_counter()
        matrix = {}
        for name, specs in MD_MATRIX:
            card_outs, card_stats, card_commit = dispatch_matrix([dev] * MD_CHIPS, specs)
            _, cpu_stats, cpu_commit = dispatch_matrix([torch.device("cpu")] * MD_CHIPS, specs)
            static = all(np.array_equal(out, TableEncoder(mat, dev).encode(src))
                         for out, src in card_outs)
            matrix[name] = {"bytes_equal_static": static,
                            "decisions_equal_cpu": card_stats == cpu_stats
                            and card_commit == cpu_commit,
                            **{k: card_stats[k] for k in ("launches", "stolen_subshards",
                                                          "hedged_launches", "drop_retries",
                                                          "chip_convictions")}}
        dispatch_s = time.perf_counter() - t_disp
        gates["dispatch_bytes_equal"] = all(r["bytes_equal_static"] for r in matrix.values())
        gates["dispatch_decisions_equal_cpu"] = all(r["decisions_equal_cpu"]
                                                    for r in matrix.values())
    finally:
        multihost.shutdown()
    return {"phase": "multidevice", "backend": backend, "world_size": 1, "gates": gates,
            "objects": objects, "general_objects": MD_GENERAL_OBJECTS,
            "rebalance_objects": MD_REBALANCE[0] * MD_REBALANCE[1], "moved": moved,
            "decode": decode_rows, "executor": exec_rows, "executor_chunk": MD_CHUNK,
            "degraded_pgs": int(len(peering.pgs_with(rec.PG_STATE_DEGRADED))),
            "scrub": {"pgs": n_pg, "shards": n_sh, "chunk": ch,
                      "n_inconsistent": rm.n_inconsistent},
            "traffic_ops": MD_TRAFFIC_OPS, "dispatch_chips": MD_CHIPS, "dispatch": matrix,
            "mesh_paths_s": mesh_s, "dispatch_s": dispatch_s,
            "wall_s": time.perf_counter() - t0, "launches": launches}


MW_OBJECTS = 1 << 20             # placement lanes of the N-rank world check
MW_REBALANCE = (1 << 14, 2)     # chunk, chunks a rank
MW_EXEC_MASKS = [0b00011111111, 0b11111110001, 0b10101011111, 0b01111111110]  # k=8 m=3
MW_EXEC_CHUNK = 1 << 20 | 13    # an odd width: the padding path is live
MW_SKEW = [(0.05, "rankdelay:1.2500"), (0.30, "osd:3:down_out"), (0.80, "osd:9:down_out")]
MW_MEAN_RTOL = 1e-6             # the traffic step's float sums add in another order over N ranks


def mesh_world_cases(n: int, cover: int) -> list:
    """The mesh cases of ``testing/mesh_cases.py`` for an ``n``-rank
    world, on seeded inputs every world shares; the rebalance sim covers
    the objects of ``cover`` ranks."""
    from ceph_tpu_torch.models.clusters import build_osdmap, build_simple

    cases = "ceph_tpu_torch.testing.mesh_cases"
    simple = build_simple(1024)
    w = np.full(simple.to_dense().max_devices, 0x10000, np.uint32)
    w_out = w.copy()
    w_out[np.random.default_rng(SEED).choice(1024, 32, replace=False)] = 0
    xs = np.random.default_rng(SEED + 1).integers(0, 2**32, MW_OBJECTS, dtype=np.uint32)
    rs = np.random.default_rng(SEED + 2)
    src = rs.integers(0, 256, (8, MW_EXEC_CHUNK), dtype=np.uint8)
    mat = np.asarray(rs.integers(1, 256, (3, 8)), np.uint8)
    small = build_osdmap(64, pg_num=32, size=6, pool_kind="erasure").encode()
    clean = rs.integers(0, 256, (1024, 11, 4096), dtype=np.uint8)
    rot = clean.copy()
    rot[[3, 500, 1023], [1, 10, 4], [7, 0, 4095]] ^= 0x5A
    arrays = {"survivor_mask": rs.integers(0, 1 << 11, 8192).astype(np.uint32),
              "n_alive": rs.integers(6, 12, 8192).astype(np.int32),
              "acting_primary": rs.integers(0, 1024, 8192).astype(np.int32),
              "flags": np.zeros(8192, np.int32), "size": 11, "min_size": 9}
    reconcile_map = build_osdmap(32, pg_num=64, size=6, pool_kind="erasure").encode()
    rebalance_chunks = MW_REBALANCE[1] * cover // n
    return [
        (f"{cases}:placement", {"crush_obj": simple.to_obj(), "rule": "replicated_rule",
                                "weights": w_out, "xs": xs}),
        (f"{cases}:rebalance", {"crush_obj": simple.to_obj(), "rule": "replicated_rule",
                                "w_before": w, "w_after": w_out, "chunk": MW_REBALANCE[0],
                                "n_chunks": rebalance_chunks, "starts": [0]}),
        (f"{cases}:sharded_decode", {"matrix": mat, "src": src, "chunk": 4096,
                                     "gather": True}),
        (f"{cases}:executor", {"k": 8, "m_par": 3, "masks": MW_EXEC_MASKS, "chunk": 4096,
                               "seed": 7, "overrides": {"recovery_shard_min_bytes": 0}}),
        (f"{cases}:executor", {"k": 8, "m_par": 3, "masks": MW_EXEC_MASKS, "chunk": 4096,
                               "seed": 7, "overrides": {"recovery_shard_min_bytes": 0,
                                                        "recovery_work_stealing": "on"},
                               "chip_faults": ["chipslow:0.4"], "dispatch_devices": 2}),
        (f"{cases}:supervised", {"map_bytes": small, "failure": "host:host0_1:down_out",
                                 "timeline": [], "k": 4, "m_par": 2, "chunk": 4096, "seed": 3,
                                 "overrides": {"recovery_shard_min_bytes": 0}}),
        (f"{cases}:traffic", {"arrays": arrays, "engine_args": (1024, 8192, 8, 11, 9),
                              "engine_kwargs": {"ops_per_step": 65536 + 7, "seed": 6}}),
        (f"{cases}:pg_states", {"arrays": arrays, "k": 8}),
        (f"{cases}:scrub", {"chunks": rot, "checksum_chunks": clean}),
        (f"{cases}:rank_identical", {"differ_on": 1 if n > 1 else None}),
        (f"{cases}:stalled_worksteal", {"k": 4, "m_par": 2, "masks": [0b001111, 0b110011]}),
        (f"{cases}:reconcile", {"map_bytes": reconcile_map,
                                "timeline": MW_SKEW if n > 1 else MW_SKEW[1:],
                                "n_epochs": 16, "overrides": {"reconcile_every_epochs": 4},
                                "seed": 4, "n_ops": 16}),
    ]


def mesh_world_check(n: int, work_dir: str, kind: str = "cuda") -> dict:
    """The mesh paths in an ``n``-rank world (NCCL, one card a rank, on
    ``cuda``; gloo on ``cpu``), every rank held against a world of one
    on the same inputs (the rebalance sim: one rank over the same
    objects), the dispatcher's typed loss and the rank guard on every
    rank, and ``RankReconciler`` against the in-process
    ``DivergentDriver`` of ``n`` ranks.  Returns the gates and walls."""
    from ceph_tpu_torch import convert
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.recovery.chaos import ChaosTimeline
    from ceph_tpu_torch.recovery.reconcile import DivergentDriver
    from ceph_tpu_torch.testing import mesh_cases
    from ceph_tpu_torch.testing.world import run_world

    walls = {}
    runs = {}
    for size in (1, n):
        t0 = time.perf_counter()
        runs[size] = run_world(size, mesh_world_cases(size, n),
                               os.path.join(work_dir, f"world{size}"), device=kind,
                               timeout_s=600.0, collective_timeout_s=120.0)
        walls[f"world_{size}_s"] = time.perf_counter() - t0
    one = runs[1][0]
    names = ["placement", "rebalance", "decode", "executor_sharded", "executor_worksteal",
             "supervised", "traffic", "pg_states", "scrub"]

    def equal(a, b) -> bool:
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        return a == b

    # what a world's size changes: the decoder's rank count, the
    # dispatcher's chips (its telemetry), and the order of the traffic
    # step's float sums (each rank's fixed-order partial, then rank
    # order), so mean_ms is held at MW_MEAN_RTOL; the bytes and every
    # count may not change
    skip = {"decode": ("n_devices",), "traffic": ("mean_ms",),
            "executor_worksteal": ("stolen_subshards", "hedged_launches", "hedge_wasted_bytes",
                                   "chip_convictions", "idle_fraction_per_chip",
                                   "static_idle_fraction_per_chip")}
    gates = {}
    for i, name in enumerate(names):
        drop = skip.get(name, ())
        trim = (lambda d: {k: v for k, v in d.items() if k not in drop}) if drop else (
            lambda d: d)
        gates[f"{name}_equal"] = all(equal(trim(runs[n][r][i]), trim(one[i]))
                                     for r in range(n))
    mean_rel = max(abs(runs[n][r][6]["mean_ms"] - one[6]["mean_ms"]) / abs(one[6]["mean_ms"])
                   for r in range(n))
    gates["traffic_mean_within_rtol"] = mean_rel <= MW_MEAN_RTOL
    gates["rank_guard_raised_everywhere"] = all(
        runs[n][r][9]["raised"] is not None for r in range(n))
    gates["chip_lost_everywhere"] = all(
        runs[n][r][10] == {"error": "ChipLostError", "chips": [r]} for r in range(n))
    cfg = Config(env={})
    cfg.set("reconcile_every_epochs", 4)
    d = DivergentDriver(convert.osdmap_from_reference(mesh_world_cases(n, n)[-1][1]["map_bytes"]),
                        ChaosTimeline.from_pairs(MW_SKEW), n, config=cfg, seed=4, n_ops=16,
                        device=kind)
    res = d.run(16)
    gates["reconcile_equal_driver"] = all(
        runs[n][r][11]["rounds"] == res.rounds
        and equal(runs[n][r][11]["merged"], mesh_cases._state_lanes(res.merged))
        and equal(runs[n][r][11]["state"], mesh_cases._state_lanes(res.states[r]))
        for r in range(n))
    return {"phase": "mesh_world", "ranks": n, "device": kind, "gates": gates, **walls,
            "sharded_launches": runs[n][0][3]["sharded_launches"],
            "worksteal_launches": runs[n][0][4]["worksteal_launches"],
            "traffic_mean_ms": [runs[n][0][6]["mean_ms"], one[6]["mean_ms"]],
            "traffic_mean_rel_diff": mean_rel}


def phase_tooling(dev, counts, reset, work_dir: str) -> dict:
    """Item 5 on the card (see the module docstring).  Everything but the
    rebuild check runs between ``reset()`` and ``counts()``, inside a
    ``LaunchCounter`` whose check holds that every wrapper call outside a
    capture launched its kernel."""
    from ceph_tpu_torch import _cuda
    from ceph_tpu_torch.analysis import runtime_guard
    from ceph_tpu_torch.common.config import global_config
    from ceph_tpu_torch.models.clusters import build_osdmap
    from ceph_tpu_torch.recovery.chaos import ChaosTimeline
    from ceph_tpu_torch.recovery.checkpoint import CheckpointStore
    from ceph_tpu_torch.recovery.superstep import EpochDriver
    from ceph_tpu_torch.testing import nonregression as nr
    from ceph_tpu_torch.workload.writepath import WritepathDriver

    t0 = time.perf_counter()
    gates = {}
    with runtime_guard.CompileCounter() as cc:
        _cuda.build_all()
    gates["no_rebuild"] = cc.backend_compiles == 0
    rebuild = {"backend_compiles": cc.backend_compiles, "cache_hits": cc.cache_hits}
    reset()
    window = runtime_guard.LaunchCounter(check_launches=True).__enter__()
    t_arch = time.perf_counter()
    archive = nr.render(nr.generate(dev))
    with open(os.path.join(HERE, "tests", "golden", "archive.json")) as f:
        gates["archive_equal"] = archive == f.read()
    archive_s = time.perf_counter() - t_arch
    t_budget = time.perf_counter()
    budgets = nr.launch_budget_cases(dev)  # raises over budget or on a call without launch
    budgets_s = time.perf_counter() - t_budget
    gates["budgets_held"] = sorted(budgets) == sorted(nr.BUDGETS)
    gates["budget_launches_equal_calls"] = all(  # the launches not made by a replay
        {k: v - b["replayed_launches"].get(k, 0) for k, v in b["launches"].items()
         if v != b["replayed_launches"].get(k, 0)} == b["calls"] for b in budgets.values())
    cfg = global_config()
    prev = {k: cfg.get(k) for k in ("debug_fsync_audit", "debug_bucket_checks")}
    try:
        cfg.set("debug_fsync_audit", True)
        cfg.set("debug_bucket_checks", True)
        m = build_osdmap(32, pg_num=16, size=6, pool_kind="erasure")
        drv = EpochDriver(m, ChaosTimeline(), n_ops=64, device=dev)
        drv.run_superstep(4, pull=False)
        store = CheckpointStore(os.path.join(work_dir, "audited"), device=dev)
        with runtime_guard.FsyncAudit("chip_smoke audited save") as audit:
            store.save(drv.final_state, meta={"epoch": 4})
        audit.verify()
        gates["fsync_audited_save"] = store.load_latest(drv.final_state) is not None
        wdrv = WritepathDriver(drv, n_sets=8, ways=2, max_writes=8)
        gates["bucket_checked_writepath"] = runtime_guard.is_pow2(wdrv.batch_size)
    finally:
        for k, v in prev.items():
            cfg.set(k, v)
    torch.cuda.synchronize()
    launches = counts()
    calls = runtime_guard.kernel_counts("CALLS")
    window.__exit__(None, None, None)  # raises on a call outside a capture without launch
    gates["calls_outside_captures_launched"] = True
    fp = budgets["fused_placement"]
    gates["fused_placement_one_replay"] = (
        fp["pipeline_replays"] == 1 and fp["calls"] == {} and fp["host_reads"] == 0
        and fp["launches"] == fp["replayed_launches"] != {})
    # the reference's zero
    for name in ("epoch_superstep", "compacted_superstep", "online_write_batch",
                 "fleet_superstep", "reconcile_round"):
        b = budgets[name]
        gates[f"{name}_no_read_on_the_card"] = (
            b["calls"] == {} and b["host_reads"] == 0 and b["sync_warnings"] == 0
            and b["launches"] == b["replayed_launches"])
    return {"phase": "tooling", "gates": gates, "rebuild": rebuild, "archive_s": archive_s,
            "budgets_s": budgets_s, "seconds": time.perf_counter() - t0,
            "budgets": {n: {k: b[k] for k in ("calls", "launches", "replayed_launches",
                                                "host_reads", "reads_by_seam", "sync_warnings")
                            if k in b}
                        for n, b in budgets.items()},
            "fused_placement_replays": budgets["fused_placement"]["pipeline_replays"],
            "launches": launches, "calls": calls, "captured": window.captured,
            "replayed": window.replays}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--mesh-world"]:
        # the mesh paths in an N-rank NCCL world, one card a rank (run with
        # N cards); every rank against a world of one
        sys.path.insert(0, HERE)
        import tempfile

        from ceph_tpu_torch import _cuda

        _cuda.build_all()
        n = int(argv[1]) if len(argv) > 1 else torch.cuda.device_count()
        if torch.cuda.device_count() < n:
            print(f"chip_smoke: --mesh-world {n} needs {n} cards", file=sys.stderr)
            return 2
        with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as work_dir:
            out = mesh_world_check(n, work_dir)
        print(json.dumps(out), flush=True)
        print(nvidia_smi("name,power.limit"), flush=True)
        bad = [g for g, ok in out["gates"].items() if not ok]
        if bad:
            raise AssertionError(f"the {n}-rank world failed its gates: {bad}")
        return 0
    if argv[:1] == ["--stripe-probe"]:
        sys.path.insert(0, os.path.abspath(argv[1]) if len(argv) > 1 else HERE)
        from ceph_tpu_torch import _cuda

        _cuda.build_all()
        print(json.dumps(stripe_probe(torch.device("cuda"))), flush=True)
        return 0
    sys.path.insert(0, HERE)
    from ceph_tpu_torch import _cuda
    from ceph_tpu_torch.analysis import runtime_guard
    from ceph_tpu_torch.core import graphs
    from ceph_tpu_torch.crush import interp_batch

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    built = _cuda.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {lib: ptxas_report(lib) for lib in _cuda.SIGNATURES}
    from ceph_tpu_torch.testing import sass

    splits = sass.straw2_splits(
        sass.cuobjdump_sass(_cuda.lib_path("straw2")))
    emit({"phase": "build", "seconds": seconds, "nvcc_seconds": built, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda, "ptxas": ptxas,
          "ops_per_draw": OPS_PER_DRAW, "draw_split_sass": splits})

    int_rate = int32_ops_per_s()
    straw2_phase = phase_kernels(OBJECTS, int_rate, dev, splits)
    kernels = straw2_phase["results"]
    for k in kernels:
        k["ptxas"] = {n: v for n, v in ptxas["straw2"].items()
                      if n.startswith("straw2_" + k["name"].split("_")[0])}
    emit({"phase": "kernels", "lanes": OBJECTS, "int32_ops_per_s": int_rate, **straw2_phase})
    bad = [k["name"] for k in kernels if not k["bit_equal"]]
    bad += [e["case"] for e in straw2_phase["edges"] if not e["bit_equal"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    ec = phase_ec_kernels(int_rate, dev)
    prefixes = {"matrix_encode": "gf_matrix", "bitmatrix_encode": "gf2_bitmatrix",
                "byte_lut": "byte_lut"}
    for r in ec["results"]:
        r["ptxas"] = {k: v for k, v in ptxas["ec"].items() if k.startswith(prefixes[r["name"]])}
    emit(ec)
    bad = [r["name"] for r in ec["results"] if not r["bit_equal"]]
    bad += [e["case"] for e in ec["edges"] if not e["bit_equal"]]
    if bad:
        raise AssertionError(f"EC kernels disagree with their plain versions: {bad}")

    sched = phase_schedule_kernel(int_rate, dev)
    sched["results"][0]["ptxas"] = {k: v for k, v in ptxas["ec"].items()
                                    if k.startswith("xor_program")}
    emit(sched)
    bad = [r["name"] for r in sched["results"] if not (r["bit_equal"] and r["k5_equal"])]
    bad += [e["case"] for e in sched["edges"] if not e["bit_equal"]]
    if bad:
        raise AssertionError(f"K6 disagrees with its plain version: {bad}")
    scrub_phase = phase_scrub_kernel(int_rate, dev)
    fold_split = sass.crc_split(sass.cuobjdump_sass(_cuda.lib_path("scrub")))
    for r in scrub_phase["results"]:
        # dynamic shared memory: csrc/scrub.cu's kSmemBytes (T0..T3 one copy a
        # bank, 128 KiB; the staged lines, 72 KiB)
        r["ptxas"] = {k: dict(v, dynamic_smem_bytes=204800) for k, v in ptxas["scrub"].items()}
        r["fold_split_sass"] = fold_split
    emit(scrub_phase)
    bad = [r["name"] for r in scrub_phase["results"] if not r["bit_equal"]]
    bad += [e["case"] for e in scrub_phase["edges"] if not e["bit_equal"]]
    if bad:
        raise AssertionError(f"K8 disagrees with its plain version: {bad}")
    online_phase = phase_online_kernel(int_rate, dev)
    for r in online_phase["results"]:
        r["ptxas"] = {k: v for k, v in ptxas["online"].items() if k.startswith(r["name"])}
    emit(online_phase)
    bad = [r["name"] for r in online_phase["results"] if not r["bit_equal"]]
    bad += [e["case"] for e in online_phase["edges"] if not e["bit_equal"]]
    if bad:
        raise AssertionError(f"K9 disagrees with its plain version: {bad}")

    def counts() -> dict:
        # the launches that ran, whether a wrapper made them or a graph
        # replay did (the replays' conditional bodies read from their counters)
        return runtime_guard.kernel_counts("LAUNCHES")

    def reset() -> None:
        graphs.collect()  # a replay before the reset counts before it
        for mod in runtime_guard.kernel_modules():
            mod.reset_launches()

    # each main path from 0: placement (raw CRUSH in every mode, then the
    # OSDMap), EC (encode, decode, the plugins), recovery
    paths = {}
    # the crush phase's edges run before the counts start: their launches
    # are checks, not the main path's
    edges = emptying_rule_edges(dev)
    bad = [e["case"] for e in edges if not e["equal_cpp"]]
    if bad:
        raise AssertionError(f"rules that empty the working vector differ from the C++ tier: {bad}")
    reset()
    emit({**phase_crush(OBJECTS, dev, interp_batch.MODES), "edges": edges})
    emit(phase_osdmap(dev))
    paths["placement"] = counts()
    general = phase_general(dev, counts, reset)
    emit(general)
    paths["general"] = general["launches"]
    rebalance = phase_rebalance(dev, counts, reset)
    emit(rebalance)
    paths["rebalance"] = rebalance["launches"]
    reset()
    batches = {}
    emit(phase_ec_encode(dev, batches))
    emit(phase_ec_decode(dev, batches))
    batches.clear()
    emit(phase_ec_plugins(dev))
    paths["ec"] = counts()
    recovery = phase_recovery(dev, counts, reset)
    emit(recovery)
    paths["recovery"] = recovery["launches"]
    supervised = phase_supervised(dev, counts, reset)
    emit(supervised)
    paths["supervised"] = supervised["launches"]
    paths["traffic"] = supervised["traffic"]["launches"]
    paths["scrub_qos"] = supervised["scrub_qos"]["launches"]
    bad = [(p, g) for p, info in supervised["passes"].items()
           for g, ok in info["gates"].items() if not ok]
    bad += [(p, g) for p in ("traffic", "scrub_qos")
            for g, ok in supervised[p]["gates"].items() if not ok]
    bad += [(s_, "card_equals_cpu") for s_, r in supervised["card_equals_cpu"].items()
            if not r["equal"]]
    if bad:
        raise AssertionError(f"supervised recovery failed its gates: {bad}")
    epoch = phase_epoch(dev, counts, reset)
    emit(epoch)
    paths["epoch"] = epoch["launches"]
    bad = [g for g, ok in epoch["gates"].items() if not ok]
    if bad:
        raise AssertionError(f"the epoch loop failed its gates: {bad}")
    fleet, fleet_rec = phase_fleet(dev, counts, reset)
    emit(fleet)
    emit(fleet_rec)
    paths["fleet"] = fleet["launches"]
    bad = [g for g, ok in fleet["gates"].items() if not ok]
    if bad:
        raise AssertionError(f"the fleet failed its gates: {bad}")
    divergent, divergent_rec = phase_divergent(dev, counts, reset)
    emit(divergent)
    emit(divergent_rec)
    paths["divergent"] = divergent["launches"]
    bad = [g for g, ok in divergent["gates"].items() if not ok]
    if bad:
        raise AssertionError(f"the divergent ranks failed their gates: {bad}")
    checkpoint, checkpoint_rec = phase_checkpoint(dev, counts, reset)
    emit(checkpoint)
    emit(checkpoint_rec)
    paths["checkpoint"] = checkpoint["launches"]
    bad = [g for g, ok in checkpoint["gates"].items() if not ok]
    if bad:
        raise AssertionError(f"the checkpoints failed their gates: {bad}")
    writepath, writepath_rec = phase_writepath(dev, counts, reset)
    emit(writepath)
    emit(writepath_rec)
    paths["writepath"] = writepath["launches"]
    bad = [g for g, ok in writepath["gates"].items() if not ok]
    if bad:
        raise AssertionError(f"the write path failed its gates: {bad}")
    balancer = phase_balancer(dev, counts, reset)
    emit(balancer)
    paths["balancer"] = balancer["launches"]
    import tempfile

    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as work_dir:
        cli = phase_cli(dev, counts, reset, work_dir)
    emit(cli)
    paths["cli"] = cli["launches"]
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as work_dir:
        multidevice = phase_multidevice(dev, counts, reset, work_dir)
    emit(multidevice)
    paths["multidevice"] = multidevice["launches"]
    bad = [g for g, ok in multidevice["gates"].items() if not ok]
    if bad:
        raise AssertionError(f"the mesh paths failed their gates: {bad}")
    pipeline_phase = phase_pipeline(dev, counts, reset)
    emit(pipeline_phase)
    paths["pipeline"] = pipeline_phase["launches"]
    bad = [g for g, ok in pipeline_phase["gates"].items() if not ok]
    if bad:
        raise AssertionError(f"the fused pipeline failed its gates: {bad}")
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as work_dir:
        tooling = phase_tooling(dev, counts, reset, work_dir)
    emit(tooling)
    paths["tooling"] = tooling["launches"]
    bad = [g for g, ok in tooling["gates"].items() if not ok]
    if bad:
        raise AssertionError(f"the tooling failed its gates: {bad}")
    emit({"launches_by_path": paths})
    print(json.dumps({"phase_walls_s": PHASE_WALLS,
                      "total_s": time.perf_counter() - T_START}), flush=True)
    need = {"placement": ("negdraw", "level_choose", "descend"),
            "general": ("negdraw",), "rebalance": ("descend",),
            "ec": ("matrix_encode", "bitmatrix_encode", "byte_lut"),
            "recovery": ("descend", "matrix_encode", "schedule_apply"),
            "supervised": ("descend", "matrix_encode", "crc32c_rows"),
            "traffic": ("descend", "matrix_encode"),
            "scrub_qos": ("descend", "matrix_encode", "crc32c_rows"),
            "epoch": ("descend",),
            "fleet": ("descend",),
            "divergent": ("descend",),
            "checkpoint": ("descend", "crc32c_rows"),
            "writepath": ("descend", "schedule_apply", "stripe_absorb", "stripe_commit"),
            "balancer": ("descend",),
            "cli": ("descend", "matrix_encode", "bitmatrix_encode"),
            "multidevice": ("negdraw", "descend", "matrix_encode", "schedule_apply",
                            "crc32c_rows"),
            "pipeline": ("negdraw", "descend"),
            "tooling": ("descend", "matrix_encode", "bitmatrix_encode", "schedule_apply",
                        "byte_lut", "crc32c_rows", "stripe_absorb", "stripe_commit")}
    missing = [(p, k) for p, ks in need.items() for k in ks if paths[p].get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"a kernel of a main path never launched: {missing}")
    launches = {k: sum(p.get(k, 0) for p in paths.values()) for k in counts()}

    # one record per kernel: K4 at k=8 m=3, K7 over the CLAY encode's 64 MiB
    main_ec = [r for r in ec["results"] if r["name"] != "matrix_encode" or "k=8" in r["shape"]]
    main_ec = [r for r in main_ec if r["name"] != "byte_lut" or "encode" in r["shape"]]
    main_ec = [r for r in main_ec if r["name"] != "bitmatrix_encode" or "decoder" not in r["shape"]]
    main_ec += sched["results"]
    records = [dict(k, source="ceph_tpu_torch/csrc/straw2.cu") for k in kernels]
    records += [dict(r, source="ceph_tpu_torch/csrc/ec.cu") for r in main_ec]
    # K8 at the scrub pass, with its decode-verify shape beside it
    scrub_pass, verify = scrub_phase["results"]
    records.append(dict(scrub_pass, source="ceph_tpu_torch/csrc/scrub.cu", at_verify_shape={
        key: verify[key] for key in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}))
    records += [dict(r, source="ceph_tpu_torch/csrc/online.cu") for r in online_phase["results"]]
    emit({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": launches[k["name"]],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": k["library_ms"],
         "pipe_floor_ms": k.get("pipe_floor_ms"),
         **({"at_verify_shape": k["at_verify_shape"]} if "at_verify_shape" in k else {})}
        for k in records]})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
