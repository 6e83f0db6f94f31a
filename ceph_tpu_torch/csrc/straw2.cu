// straw2 kernels for Hopper (sm_90a): the CRUSH placement hot loop.
//
// Three kernels share one __device__ straw2 draw (rjenkins hash ->
// crush_ln table walk -> divide by the item weight through the
// precomputed 64-bit reciprocal).  They replace the Pallas TPU kernels of
// ceph_tpu/core/pallas_straw2.py:
//
//   K1 straw2_negdraw_kernel  <- _negdraw_jit / _kernel (straw2_negdraw_fused)
//   K2 straw2_level_kernel    <- _level_jit / _make_level_kernel (level_choose)
//   K3 straw2_descend_kernel  <- _descend_jit / _make_descend_kernel (descend_fused)
//
// What bounds them: the integer pipes.  A draw is ~230 instructions
// (testing/sass.py counts each kernel's draw loop and splits it by pipe)
// against 4-24 bytes of device memory, nearly all 32-bit integer work.
// On sm_90 the ALU pipe (IADD3, LOP3, SHF, ISETP, SEL) and the FMA pipe
// (IMAD in all its forms) each take 64 lanes a clock per SM, half the
// issue rate, and run side by side.  The rjenkins hash is 45 lines of
// (X - Y - Z) ^ (Z shifted); compiled as written a line is an IADD3, an
// SHF and a LOP3 on the ALU pipe (ptxas already puts left shifts on the
// FMA pipe as IMAD.SHL), so the ALU pipe bounded the first kernels at
// ~168 of their ~225 instructions a draw.  This design balances the two
// pipes (~110 and ~115 a draw):
//
//   - the two subtractions of 8 of each mix's 9 lines are multiply-adds
//     by -1 (IMAD x, neg1, y), with neg1 = 0xFFFFFFFF a kernel argument
//     so that ptxas cannot fold them back into an IADD3 (kMixMask);
//   - right shifts stay SHF: IMAD.HI, their multiply form, issues at well
//     under half IMAD's rate on this card;
//   - the divide needs one correction after the 64x64 high product, not
//     three (div_magic's bound);
//   - K2/K3 read a slot as one 16-byte record, the winner's ctnl once, and
//     keep two draws of a row in flight; K1 runs a group of lanes per
//     gathered row (no division by the fanout) with 8- and 16-byte
//     accesses where the rows are aligned.
//
// K2 and K3 stay bound by operations; K1 reads and writes 24 bytes a draw
// and sits near both bounds.  Every table a lane reads stays on chip: the
// crush_ln tables (4 KB) always, and the bucket tables of a descent in
// shared memory whenever they fit in a block's 227 KB (else they are read
// from global memory through L1).  K2/K3 run one thread per lane, and
// blocks walk the batch in a grid-stride loop so each block stages its
// tables once.
//
// What the TPU version needed and this one does not: 16-bit limbs (Mosaic
// had no 64-bit integers), 128-lane table halves read by dynamic_gather,
// clz as a sum of compares, and the VMEM-driven tile and fanout bounds.
//
// Every launcher returns cudaGetLastError() as an int; 0 is success.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Bit i set: line i of every mix subtracts on the FMA pipe (two IMAD by
// neg1) rather than the ALU pipe (one IADD3).  Lines 1, 4 and 7 shift
// left (IMAD.SHL, FMA pipe), the rest right (SHF, ALU pipe); eight FMA
// lines a mix leave the two pipes within a few instructions of each
// other over the whole draw (testing/sass.py's split).  core/straw2.py
// MIX_MASK models the same hash.
constexpr unsigned kMixMask = 0x1FEu;
constexpr int kLnEntries = 258 + 256;          // RH/LH[0..257] then LL[0..255]
constexpr int kMaxLevels = 32;
constexpr int kMaxSmem = 232448;               // 227 KB, a block's maximum on Hopper
constexpr uint32_t kItemNone = 0x7FFFFFFFu;
constexpr uint32_t kCtypeDangling = 255u;
constexpr uint32_t kNeg1 = 0xFFFFFFFFu;        // passed to every kernel as neg1
constexpr uint64_t kU64Max = 0xFFFFFFFFFFFFFFFFull;
constexpr long long kNegdrawNone = 0x7FFFFFFFFFFFFFFFll;  // plain versions' sentinel

struct Level {
  int nb;        // buckets in this level
  int fanout;    // slots per bucket row (padded with zero weights)
  int slot_off;  // first slot of the level in the stacked slot arrays
  int size_off;  // first bucket of the level in the stacked size array
};

struct Levels {
  int n;
  Level lv[kMaxLevels];
};

// Stacked per-level bucket tables: a 16-byte record per slot (magic lo,
// magic hi, id, weight), ctnl per slot (child_type << 16 |
// next_local_index, read only for the winner), sizes per bucket.
struct Tables {
  const uint4* slots;
  const uint32_t* ctnl;
  const uint32_t* size;
};

// x - y - z: one IADD3 (ALU pipe), or with FMA two multiply-adds by
// neg1 = -1 (FMA pipe).  Both are exact mod 2^32.
template <unsigned FMA>
__device__ __forceinline__ uint32_t sub2(uint32_t x, uint32_t y, uint32_t z, uint32_t neg1) {
  if (FMA) return (x + y * neg1) + z * neg1;
  return x - y - z;
}

#define MIX_LINE(i, X, Y, Z, SH) X = sub2<(M >> (i)) & 1u>(X, Y, Z, neg1) ^ (SH)

// One rjenkins mix: nine lines X = (X - Y - Z) ^ (Z shifted).
template <unsigned M>
__device__ __forceinline__ void crush_mix(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t neg1) {
  MIX_LINE(0, a, b, c, c >> 13);
  MIX_LINE(1, b, c, a, a << 8);
  MIX_LINE(2, c, a, b, b >> 13);
  MIX_LINE(3, a, b, c, c >> 12);
  MIX_LINE(4, b, c, a, a << 16);
  MIX_LINE(5, c, a, b, b >> 5);
  MIX_LINE(6, a, b, c, c >> 3);
  MIX_LINE(7, b, c, a, a << 10);
  MIX_LINE(8, c, a, b, b >> 15);
}

#undef MIX_LINE

__device__ __forceinline__ uint32_t crush_hash32_3(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t neg1) {
  constexpr unsigned M = kMixMask;
  uint32_t h = 1315423911u ^ a ^ b ^ c;
  uint32_t x = 231232u, y = 1232u;
  crush_mix<M>(a, b, h, neg1);
  crush_mix<M>(c, x, h, neg1);
  crush_mix<M>(y, a, h, neg1);
  crush_mix<M>(b, x, h, neg1);
  crush_mix<M>(y, c, h, neg1);
  return h;
}

// 2^48 - crush_ln(u) for u in [0, 0xffff], in [0, 2^48].  ln points at
// the block's 16-byte aligned copy of the crush_ln tables: RH/LH pairs
// (index1 - 256 is even, so a pair is one LDS.128), then LL.
__device__ __forceinline__ uint64_t ln_neg(uint32_t u, const unsigned long long* ln) {
  const uint32_t xv = u + 1u;                 // [1, 0x10000]
  const uint32_t p = 31u - __clz(xv);
  const uint32_t iexpon = min(p, 15u);
  const uint32_t xs = xv << (15u - iexpon);   // [0x8000, 0x10000]
  const ulonglong2 rhlh = reinterpret_cast<const ulonglong2*>(ln)[(xs >> 8) - 128u];
  // bits 48..55 of xs * rh (xs < 2^17, rh <= 2^48): the low word's carry
  // cannot reach bit 48, so 32-bit halves give them exactly
  const uint32_t t = xs * (uint32_t)(rhlh.x >> 32) + __umulhi(xs, (uint32_t)rhlh.x);
  const uint64_t llv = ln[258u + ((t >> 16) & 0xFFu)];
  const uint64_t lnv = ((uint64_t)iexpon << 44) + ((rhlh.y + llv) >> 4);
  return (1ull << 48) - lnv;
}

// floor(a / w) for a <= 2^48, w >= 1, with magic = floor((2^64-1)/w).
// magic > (2^64 - w)/w, so a*magic/2^64 > a/w - a/2^64 >= a/w - 2^-16:
// the high product is the quotient or one less, and one correction
// suffices (the reference's div_by_magic allows three).
__device__ __forceinline__ uint64_t div_magic(uint64_t a, uint64_t magic, uint32_t w) {
  const uint64_t q = __umul64hi(a, magic);
  const uint64_t rem = a - q * (uint64_t)w;   // < 2w
  return rem >= w ? q + 1 : q;
}

// Negated straw2 draw floor((2^48 - crush_ln(u)) / w); meaningless for
// w = 0, which every caller masks.
__device__ __forceinline__ uint64_t straw2_draw(uint32_t x, uint32_t id, uint32_t r, uint32_t w,
                                                uint64_t magic, const unsigned long long* ln,
                                                uint32_t neg1) {
  const uint32_t u = crush_hash32_3(x, id, r, neg1) & 0xFFFFu;
  return div_magic(ln_neg(u, ln), magic, w);
}

__device__ __forceinline__ void stage_ln(unsigned long long* s_ln, const unsigned long long* g_ln) {
  for (int i = threadIdx.x; i < kLnEntries; i += blockDim.x) s_ln[i] = g_ln[i];
}

// Copy the stacked tables into shared memory after the crush_ln tables
// (kLnEntries * 8 bytes, a multiple of 16); returns the shared view.
__device__ __forceinline__ Tables stage_tables(unsigned long long* smem, const Tables& g, int n_slots,
                               int n_sizes) {
  uint4* slots = reinterpret_cast<uint4*>(smem + kLnEntries);
  uint32_t* ctnl = reinterpret_cast<uint32_t*>(slots + n_slots);
  uint32_t* size = ctnl + n_slots;
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    slots[i] = g.slots[i];
    ctnl[i] = g.ctnl[i];
  }
  for (int i = threadIdx.x; i < n_sizes; i += blockDim.x) size[i] = g.size[i];
  Tables s{slots, ctnl, size};
  return s;
}

struct Choice {
  uint32_t item;
  uint32_t ctnl;
  uint32_t size;
};

// One straw2 bucket choose: first-index argmin of the negated draws over
// the lane's row.  Zero weights never win (their draw is u64 max), and
// slots past the row's size are zero-weight padding, so they are not
// drawn; an all-zero or empty row keeps slot 0.  The winner's id and
// ctnl are read once, after the row.
__device__ __forceinline__ Choice choose_row(const Tables& t, const Level& L, uint32_t row,
                                             uint32_t x, uint32_t r,
                                             const unsigned long long* ln, uint32_t neg1) {
  const int base = L.slot_off + (int)row * L.fanout;
  Choice c;
  c.size = t.size[L.size_off + (int)row];
  const int live = min(L.fanout, (int)c.size);
  uint64_t best = kU64Max;
  int win = 0;
  auto draw = [&](const uint4& s) {  // s = (magic lo, magic hi, id, weight)
    return straw2_draw(x, s.z, r, s.w, (uint64_t)s.y << 32 | s.x, ln, neg1);
  };
  auto keep = [&](const uint4& s, uint64_t nd, int f) {
    if (s.w != 0 && nd < best) {  // strict: ties keep the first index
      best = nd;
      win = f;
    }
  };
  int f = 0;
#pragma unroll 1
  for (; f + 1 < live; f += 2) {  // two independent draws in flight
    const uint4 s0 = t.slots[base + f], s1 = t.slots[base + f + 1];
    const uint64_t nd0 = draw(s0), nd1 = draw(s1);
    keep(s0, nd0, f);
    keep(s1, nd1, f + 1);
  }
  if (f < live) {
    const uint4 s = t.slots[base + f];
    keep(s, draw(s), f);
  }
  c.item = reinterpret_cast<const uint32_t*>(t.slots)[4 * (base + win) + 2];
  c.ctnl = t.ctnl[base + win];
  return c;
}

// V adjacent slots of one lane: V = 2 reads ids and weights as 8-byte
// pairs and magic as a 16-byte pair, V = 1 slot by slot.
template <int V>
struct Slots {
  uint32_t id[V], w[V];
  uint64_t magic[V];
};

template <int V>
__device__ __forceinline__ Slots<V> load_slots(const uint32_t* ids, const uint32_t* w,
                                               const unsigned long long* magic, long long i) {
  Slots<V> s;
  if constexpr (V == 2) {
    const uint2 id2 = *reinterpret_cast<const uint2*>(ids + i);
    const uint2 w2 = *reinterpret_cast<const uint2*>(w + i);
    const ulonglong2 m2 = *reinterpret_cast<const ulonglong2*>(magic + i);
    s = Slots<V>{{id2.x, id2.y}, {w2.x, w2.y}, {m2.x, m2.y}};
  } else {
    s = Slots<V>{{ids[i]}, {w[i]}, {magic[i]}};
  }
  return s;
}

template <int V>
__device__ __forceinline__ void draw_slots(const Slots<V>& s, uint32_t x, uint32_t r,
                                           long long* out, long long i,
                                           const unsigned long long* ln, uint32_t neg1) {
  long long o[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const uint64_t nd = straw2_draw(x, s.id[v], r, s.w[v], s.magic[v], ln, neg1);
    o[v] = s.w[v] == 0 ? kNegdrawNone : (long long)nd;
  }
  if constexpr (V == 2) {
    *reinterpret_cast<longlong2*>(out + i) = make_longlong2(o[0], o[1]);
  } else {
    out[i] = o[0];
  }
}

// K1: a [rows, fanout] batch of gathered rows, a group of 2^lanes_log2
// lanes per row (x and r loaded once a row), V adjacent slots per lane
// (V = 2: fanout even, arrays aligned).  No division by the fanout: a
// lane steps through rows, and through a row's slots lanes * V apart.
template <int V>
__global__ void __launch_bounds__(kThreads)
straw2_negdraw_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ r,
                      const uint32_t* __restrict__ ids, const uint32_t* __restrict__ w,
                      const unsigned long long* __restrict__ magic,
                      long long* __restrict__ out, int rows, int fanout, int lanes_log2,
                      uint32_t neg1, const unsigned long long* __restrict__ g_ln) {
  __shared__ __align__(16) unsigned long long s_ln[kLnEntries];
  stage_ln(s_ln, g_ln);
  __syncthreads();
  const int lanes = 1 << lanes_log2;
  const int f0 = (threadIdx.x & (lanes - 1)) * V;
  const int step = (gridDim.x * blockDim.x) >> lanes_log2;
  for (int b = (blockIdx.x * blockDim.x + threadIdx.x) >> lanes_log2; b < rows; b += step) {
    const uint32_t xb = x[b], rb = r[b];
    const long long row = (long long)b * fanout;
#pragma unroll 1
    for (int f = f0; f < fanout; f += lanes * V)
      draw_slots<V>(load_slots<V>(ids, w, magic, row + f), xb, rb, out, row + f, s_ln, neg1);
  }
}

// K2: one level choose per lane.  STAGED: the tables are read from
// shared memory (shared loads; else from global memory through L1).
template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
straw2_level_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ r,
                    const uint32_t* __restrict__ lidx, int n, Tables g, int n_slots,
                    int n_sizes, Level L, uint32_t neg1,
                    const unsigned long long* __restrict__ g_ln,
                    int32_t* __restrict__ item, int32_t* __restrict__ ctype,
                    int32_t* __restrict__ nlidx, int32_t* __restrict__ size) {
  extern __shared__ __align__(16) unsigned long long smem[];
  stage_ln(smem, g_ln);
  const Tables t = STAGED ? stage_tables(smem, g, n_slots, n_sizes) : g;
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    Choice c = choose_row(t, L, lidx[i], x[i], r[i], smem, neg1);
    item[i] = (int32_t)c.item;
    ctype[i] = (int32_t)(c.ctnl >> 16);
    nlidx[i] = (int32_t)(c.ctnl & 0xFFFFu);
    size[i] = (int32_t)c.size;
  }
}

// K3: every level of one descent per lane, with the per-level status
// block of interp_batch.descend (empty / wrong-type / out-of-range /
// dangling -> hard or soft per empty_is_hard; done on target_type).
template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
straw2_descend_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ r,
                      const uint32_t* __restrict__ lidx0, const uint8_t* __restrict__ active,
                      int n, Tables g, int n_slots, int n_sizes, Levels levels,
                      int target_type, int empty_is_hard, uint32_t max_devices, uint32_t neg1,
                      const unsigned long long* __restrict__ g_ln,
                      int32_t* __restrict__ item_out, int32_t* __restrict__ nlidx_out,
                      uint8_t* __restrict__ ok_out, uint8_t* __restrict__ hard_out) {
  extern __shared__ __align__(16) unsigned long long smem[];
  stage_ln(smem, g_ln);
  const Tables t = STAGED ? stage_tables(smem, g, n_slots, n_sizes) : g;
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const uint32_t xi = x[i], ri = r[i];
    uint32_t lidx = lidx0[i];
    bool done = active[i] == 0;
    bool ok = false, hard = false;
    uint32_t item = kItemNone, nl = 0;
    for (int lv = 0; lv < levels.n && !done; ++lv) {
      Choice c = choose_row(t, levels.lv[lv], lidx, xi, ri, smem, neg1);
      const uint32_t ctype = c.ctnl >> 16;
      const uint32_t next = c.ctnl & 0xFFFFu;
      const bool empty = c.size == 0;
      const bool is_bucket = c.item >= 0x80000000u;
      const bool reached = target_type != 0 ? ctype == (uint32_t)target_type : !is_bucket;
      const bool wrong_dev = !is_bucket && !reached;
      const bool bad_dev = !is_bucket && c.item >= max_devices;
      const bool bad_bucket = is_bucket && ctype == kCtypeDangling;
      bool hard_now, soft_now;
      if (empty_is_hard) {
        hard_now = empty || wrong_dev || bad_dev || bad_bucket;
        soft_now = false;
      } else {
        hard_now = !empty && (wrong_dev || bad_dev || bad_bucket);
        soft_now = empty;
      }
      ok = reached && !hard_now && !soft_now;
      hard = hard_now;
      item = c.item;
      nl = next;
      done = hard_now || soft_now || reached;
      if (!done) lidx = next;
    }
    item_out[i] = (int32_t)item;
    nlidx_out[i] = (int32_t)nl;
    ok_out[i] = ok ? 1 : 0;
    hard_out[i] = hard ? 1 : 0;
  }
}

size_t table_bytes(int n_slots, int n_sizes) {
  return (size_t)kLnEntries * 8 + (size_t)n_slots * (16 + 4) + (size_t)n_sizes * 4;
}

// Blocks of kThreads that one SM holds at once for (kernel, shared
// memory), times the SM count: asked of the runtime once per kernel,
// device and size, then cached (recovery's peering launches K3 some 300
// times a call).  A kernel's dynamic shared-memory limit is lifted above
// the default 48 KB only when a launch needs it, and only as far as the
// largest launch so far, as the first launchers did per launch: the
// limit set once to a block's maximum coincided with slower peering and
// placement calls on the host clock, a cause not isolated.
struct Resident {
  const void* fn;
  int dev;
  size_t smem;
  int blocks;  // SMs x blocks per SM
};

struct Lifted {
  const void* fn;
  int dev;
  size_t smem;  // the kernel's dynamic shared-memory limit as set
};

std::mutex g_resident_mu;
Resident g_resident[64];
int g_n_resident = 0;
Lifted g_lifted[16];
int g_n_lifted = 0;

cudaError_t lift_smem(const void* fn, int dev, size_t smem) {
  constexpr size_t kDefault = 48 * 1024;
  Lifted* e = nullptr;
  for (int i = 0; i < g_n_lifted; ++i)
    if (g_lifted[i].fn == fn && g_lifted[i].dev == dev) e = &g_lifted[i];
  if (smem <= (e ? e->smem : kDefault)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (e) {
    e->smem = smem;
  } else if (g_n_lifted < 16) {
    g_lifted[g_n_lifted++] = Lifted{fn, dev, smem};
  }  // else: untracked, so lifted again by the next launch that needs it
  return cudaSuccess;
}

int resident_blocks(const void* fn, size_t smem, cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(g_resident_mu);
  *err = lift_smem(fn, dev, smem);
  if (*err != cudaSuccess) return 0;
  for (int i = 0; i < g_n_resident; ++i) {
    const Resident& e = g_resident[i];
    if (e.fn == fn && e.dev == dev && e.smem == smem) return e.blocks;
  }
  int sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (*err != cudaSuccess) return 0;
  const int blocks = sms * (per_sm < 1 ? 1 : per_sm);
  if (g_n_resident < 64) g_resident[g_n_resident++] = Resident{fn, dev, smem, blocks};
  return blocks;
}

// Grid of a grid-stride launch over `threads` threads: no more blocks
// than can be resident at once (each block stages its tables once), no
// more than the batch needs.
int grid_for(const void* fn, long long threads, size_t smem, cudaError_t* err) {
  const int cap = resident_blocks(fn, smem, err);
  const long long need = (threads + kThreads - 1) / kThreads;
  return (int)(need < cap ? need : cap);
}

Tables make_tables(const void* slots, const void* ctnl, const void* size) {
  Tables t{static_cast<const uint4*>(slots), static_cast<const uint32_t*>(ctnl),
           static_cast<const uint32_t*>(size)};
  return t;
}

}  // namespace

extern "C" {

const char* straw2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1.  x, r: [n / fanout] u32; ids, w: [n] u32; magic: [n] u64;
// out: [n] i64 (zero weight -> i64 max).
int straw2_negdraw(const void* x, const void* r, const void* ids, const void* w,
                   const void* magic, void* out, int n, int fanout, const void* ln,
                   void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (n <= 0) return 0;
  if (fanout <= 0 || n % fanout != 0) return (int)cudaErrorInvalidValue;
  const int rows = n / fanout;
  const bool pairs = fanout % 2 == 0 &&
                     ((reinterpret_cast<uintptr_t>(ids) | reinterpret_cast<uintptr_t>(w)) % 8 |
                      (reinterpret_cast<uintptr_t>(magic) | reinterpret_cast<uintptr_t>(out)) %
                          16) == 0;
  const int per_lane = pairs ? 2 : 1;
  int lanes_log2 = 0;  // the fewest lanes, up to a warp, that cover a row
  while (lanes_log2 < 5 && (1 << lanes_log2) * per_lane < fanout) ++lanes_log2;
  const void* fn = pairs ? (const void*)straw2_negdraw_kernel<2> : (const void*)straw2_negdraw_kernel<1>;
  cudaError_t err;
  const int grid = grid_for(fn, (long long)rows << lanes_log2, 0, &err);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NEGDRAW_ARGS                                                                          \
  static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(r),                          \
      static_cast<const uint32_t*>(ids), static_cast<const uint32_t*>(w),                    \
      static_cast<const unsigned long long*>(magic), static_cast<long long*>(out), rows, fanout, \
      lanes_log2, kNeg1, static_cast<const unsigned long long*>(ln)
  if (pairs) {
    straw2_negdraw_kernel<2><<<grid, kThreads, 0, s>>>(NEGDRAW_ARGS);
  } else {
    straw2_negdraw_kernel<1><<<grid, kThreads, 0, s>>>(NEGDRAW_ARGS);
  }
#undef NEGDRAW_ARGS
  return (int)cudaGetLastError();
}

// K2.  level = {nb, fanout, slot_off, size_off} of the chosen level in
// the stacked tables; slots: [n_slots] 16-byte records.
int straw2_level_choose(const void* x, const void* r, const void* lidx, int n, const void* slots,
                        const void* ctnl, const void* size, int n_slots, int n_sizes,
                        const int* level, const void* ln, void* item, void* ctype, void* nlidx,
                        void* size_out, void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  Level L{level[0], level[1], level[2], level[3]};
  size_t full = table_bytes(n_slots, n_sizes);
  int staged = full <= (size_t)kMaxSmem;
  size_t smem = staged ? full : (size_t)kLnEntries * 8;
  auto kernel = staged ? straw2_level_kernel<true> : straw2_level_kernel<false>;
  cudaError_t err;
  int grid = grid_for((const void*)kernel, n, smem, &err);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(r),
      static_cast<const uint32_t*>(lidx), n, make_tables(slots, ctnl, size), n_slots, n_sizes,
      L, kNeg1, static_cast<const unsigned long long*>(ln), static_cast<int32_t*>(item),
      static_cast<int32_t*>(ctype), static_cast<int32_t*>(nlidx),
      static_cast<int32_t*>(size_out));
  return (int)cudaGetLastError();
}

// K3.  meta: n_levels rows of {nb, fanout, slot_off, size_off}.
int straw2_descend(const void* x, const void* r, const void* lidx, const void* active, int n,
                   const void* slots, const void* ctnl, const void* size, int n_slots,
                   int n_sizes, const int* meta, int n_levels, int target_type,
                   int empty_is_hard, int max_devices, const void* ln, void* item, void* nlidx,
                   void* ok, void* hard, void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels levels;
  levels.n = n_levels;
  for (int l = 0; l < n_levels; ++l)
    levels.lv[l] = Level{meta[4 * l], meta[4 * l + 1], meta[4 * l + 2], meta[4 * l + 3]};
  size_t full = table_bytes(n_slots, n_sizes);
  int staged = full <= (size_t)kMaxSmem;
  size_t smem = staged ? full : (size_t)kLnEntries * 8;
  auto kernel = staged ? straw2_descend_kernel<true> : straw2_descend_kernel<false>;
  cudaError_t err;
  int grid = grid_for((const void*)kernel, n, smem, &err);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(r),
      static_cast<const uint32_t*>(lidx), static_cast<const uint8_t*>(active), n,
      make_tables(slots, ctnl, size), n_slots, n_sizes, levels, target_type,
      empty_is_hard, (uint32_t)max_devices, kNeg1, static_cast<const unsigned long long*>(ln),
      static_cast<int32_t*>(item), static_cast<int32_t*>(nlidx), static_cast<uint8_t*>(ok),
      static_cast<uint8_t*>(hard));
  return (int)cudaGetLastError();
}

}  // extern "C"
