// straw2 kernels for Hopper (sm_90a): the CRUSH placement hot loop.
//
// Three kernels share one __device__ straw2 routine (rjenkins hash ->
// crush_ln table walk -> divide by the item weight through the
// precomputed 64-bit reciprocal).  They replace the Pallas TPU kernels of
// ceph_tpu/core/pallas_straw2.py:
//
//   K1 straw2_negdraw_kernel  <- _negdraw_jit / _kernel (straw2_negdraw_fused)
//   K2 straw2_level_kernel    <- _level_jit / _make_level_kernel (level_choose)
//   K3 straw2_descend_kernel  <- _descend_jit / _make_descend_kernel (descend_fused)
//
// What bounds them: integer ALU work.  One draw is ~245 32-bit integer
// operations counted in this source (five rjenkins mixes of 9 lines for
// hash32_3, the crush_ln lookups, a 64x64 high multiply with up to three
// corrections, the argmin compare) against 4-24 bytes of device memory.  A 3-replica
// chooseleaf on build_simple(1024) costs ~3 x (32 + 8 + 4) draws per
// object for ~16 bytes of input and output, so the card's integer rate,
// not its memory, sets the floor.  The design therefore keeps every table
// a lane reads on chip: the crush_ln tables (4 KB) always, and the bucket
// tables of a descent in shared memory whenever they fit in a block's
// 227 KB (else they are read from global memory through L1).  One thread
// owns one lane; blocks walk the batch in a grid-stride loop so each
// block stages its tables once.
//
// What the TPU version needed and this one does not: 16-bit limbs (Mosaic
// had no 64-bit integers), 128-lane table halves read by dynamic_gather,
// clz as a sum of compares, and the VMEM-driven tile and fanout bounds.
//
// Every launcher returns cudaGetLastError() as an int; 0 is success.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLnEntries = 258 + 256;          // RH/LH[0..257] then LL[0..255]
constexpr int kMaxLevels = 32;
constexpr int kMaxSmem = 232448;               // 227 KB, a block's maximum on Hopper
constexpr uint32_t kItemNone = 0x7FFFFFFFu;
constexpr uint32_t kCtypeDangling = 255u;
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

// Stacked per-level bucket tables: slot arrays are [sum nb*fanout],
// sizes [sum nb].  ctnl packs child_type << 16 | next_local_index.
struct Tables {
  const unsigned long long* magic;
  const uint32_t* ids;
  const uint32_t* w;
  const uint32_t* ctnl;
  const uint32_t* size;
};

#define CRUSH_MIX(a, b, c)  \
  do {                      \
    a -= b; a -= c; a ^= (c >> 13); \
    b -= c; b -= a; b ^= (a << 8);  \
    c -= a; c -= b; c ^= (b >> 13); \
    a -= b; a -= c; a ^= (c >> 12); \
    b -= c; b -= a; b ^= (a << 16); \
    c -= a; c -= b; c ^= (b >> 5);  \
    a -= b; a -= c; a ^= (c >> 3);  \
    b -= c; b -= a; b ^= (a << 10); \
    c -= a; c -= b; c ^= (b >> 15); \
  } while (0)

__device__ __forceinline__ uint32_t crush_hash32_3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = 1315423911u ^ a ^ b ^ c;
  uint32_t x = 231232u, y = 1232u;
  CRUSH_MIX(a, b, h);
  CRUSH_MIX(c, x, h);
  CRUSH_MIX(y, a, h);
  CRUSH_MIX(b, x, h);
  CRUSH_MIX(y, c, h);
  return h;
}

// Negated straw2 draw: floor((2^48 - crush_ln(u)) / w), u64 max for w = 0.
// ln points at the block's shared copy of the crush_ln tables.
__device__ __forceinline__ uint64_t straw2_negdraw(uint32_t x, uint32_t id, uint32_t r,
                                                   uint32_t w, uint64_t magic,
                                                   const unsigned long long* ln) {
  if (w == 0) return kU64Max;
  uint32_t u = crush_hash32_3(x, id, r) & 0xFFFFu;
  uint32_t xv = u + 1u;                       // [1, 0x10000]
  uint32_t p = 31u - __clz(xv);
  uint32_t xs = xv, iexpon = 15u;
  if (p < 15u) {
    xs = xv << (15u - p);
    iexpon = p;
  }
  uint32_t index1 = (xs >> 8) << 1;           // [256, 512]
  uint64_t rh = ln[index1 - 256u];
  uint64_t lh = ln[index1 - 255u];
  uint64_t index2 = (((uint64_t)xs * rh) >> 48) & 0xFFu;  // product < 2^64
  uint64_t llv = ln[258u + (uint32_t)index2];
  uint64_t lnv = ((uint64_t)iexpon << 44) + ((lh + llv) >> 4);
  uint64_t a = (1ull << 48) - lnv;            // <= 2^48
  // magic = floor((2^64-1)/w): the high product undershoots by < 3
  uint64_t q = __umul64hi(a, magic);
  uint64_t rem = a - q * (uint64_t)w;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (rem >= w) {
      q += 1;
      rem -= w;
    }
  }
  return q;
}

__device__ __forceinline__ void stage_ln(unsigned long long* s_ln, const unsigned long long* g_ln) {
  for (int i = threadIdx.x; i < kLnEntries; i += blockDim.x) s_ln[i] = g_ln[i];
}

// Copy the stacked tables into shared memory after the crush_ln tables;
// returns the shared view.  Layout: magic (8-byte) first, then the u32
// arrays, so every array keeps its natural alignment.
__device__ Tables stage_tables(unsigned long long* smem, const Tables& g, int n_slots,
                               int n_sizes) {
  unsigned long long* magic = smem + kLnEntries;
  uint32_t* ids = reinterpret_cast<uint32_t*>(magic + n_slots);
  uint32_t* w = ids + n_slots;
  uint32_t* ctnl = w + n_slots;
  uint32_t* size = ctnl + n_slots;
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    magic[i] = g.magic[i];
    ids[i] = g.ids[i];
    w[i] = g.w[i];
    ctnl[i] = g.ctnl[i];
  }
  for (int i = threadIdx.x; i < n_sizes; i += blockDim.x) size[i] = g.size[i];
  Tables s{magic, ids, w, ctnl, size};
  return s;
}

struct Choice {
  uint32_t item;
  uint32_t ctnl;
  uint32_t size;
};

// One straw2 bucket choose: first-index argmin of the negated draws over
// the lane's row.  Slots past the row's size are zero-weight padding that
// can never win a strict less-than, so they are skipped.
__device__ __forceinline__ Choice choose_row(const Tables& t, const Level& L, uint32_t row,
                                             uint32_t x, uint32_t r,
                                             const unsigned long long* ln) {
  const int base = L.slot_off + (int)row * L.fanout;
  Choice c;
  c.size = t.size[L.size_off + (int)row];
  uint64_t best = straw2_negdraw(x, t.ids[base], r, t.w[base], t.magic[base], ln);
  c.item = t.ids[base];
  c.ctnl = t.ctnl[base];
  const int live = min(L.fanout, (int)c.size);
  for (int f = 1; f < live; ++f) {
    uint64_t nd = straw2_negdraw(x, t.ids[base + f], r, t.w[base + f], t.magic[base + f], ln);
    if (nd < best) {  // strict: ties keep the first index
      best = nd;
      c.item = t.ids[base + f];
      c.ctnl = t.ctnl[base + f];
    }
  }
  return c;
}

// K1: per element of a [n / fanout, fanout] batch of gathered rows.
__global__ void __launch_bounds__(kThreads)
straw2_negdraw_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ r,
                      const uint32_t* __restrict__ ids, const uint32_t* __restrict__ w,
                      const unsigned long long* __restrict__ magic,
                      long long* __restrict__ out, int n, int fanout,
                      const unsigned long long* __restrict__ g_ln) {
  __shared__ unsigned long long s_ln[kLnEntries];
  stage_ln(s_ln, g_ln);
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int b = i / fanout;
    uint64_t nd = straw2_negdraw(x[b], ids[i], r[b], w[i], magic[i], s_ln);
    out[i] = nd == kU64Max ? kNegdrawNone : (long long)nd;
  }
}

// K2: one level choose per lane.
__global__ void __launch_bounds__(kThreads)
straw2_level_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ r,
                    const uint32_t* __restrict__ lidx, int n, Tables g, int n_slots,
                    int n_sizes, Level L, int staged,
                    const unsigned long long* __restrict__ g_ln,
                    int32_t* __restrict__ item, int32_t* __restrict__ ctype,
                    int32_t* __restrict__ nlidx, int32_t* __restrict__ size) {
  extern __shared__ unsigned long long smem[];
  stage_ln(smem, g_ln);
  Tables t = staged ? stage_tables(smem, g, n_slots, n_sizes) : g;
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    Choice c = choose_row(t, L, lidx[i], x[i], r[i], smem);
    item[i] = (int32_t)c.item;
    ctype[i] = (int32_t)(c.ctnl >> 16);
    nlidx[i] = (int32_t)(c.ctnl & 0xFFFFu);
    size[i] = (int32_t)c.size;
  }
}

// K3: every level of one descent per lane, with the per-level status
// block of interp_batch.descend (empty / wrong-type / out-of-range /
// dangling -> hard or soft per empty_is_hard; done on target_type).
__global__ void __launch_bounds__(kThreads)
straw2_descend_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ r,
                      const uint32_t* __restrict__ lidx0, const uint8_t* __restrict__ active,
                      int n, Tables g, int n_slots, int n_sizes, Levels levels, int staged,
                      int target_type, int empty_is_hard, uint32_t max_devices,
                      const unsigned long long* __restrict__ g_ln,
                      int32_t* __restrict__ item_out, int32_t* __restrict__ nlidx_out,
                      uint8_t* __restrict__ ok_out, uint8_t* __restrict__ hard_out) {
  extern __shared__ unsigned long long smem[];
  stage_ln(smem, g_ln);
  Tables t = staged ? stage_tables(smem, g, n_slots, n_sizes) : g;
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const uint32_t xi = x[i], ri = r[i];
    uint32_t lidx = lidx0[i];
    bool done = active[i] == 0;
    bool ok = false, hard = false;
    uint32_t item = kItemNone, nl = 0;
    for (int lv = 0; lv < levels.n && !done; ++lv) {
      Choice c = choose_row(t, levels.lv[lv], lidx, xi, ri, smem);
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
  return (size_t)kLnEntries * 8 + (size_t)n_slots * (8 + 4 + 4 + 4) + (size_t)n_sizes * 4;
}

// Grid of a grid-stride launch: no more blocks than can be resident at
// once (each block stages its tables once), no more than the batch needs.
template <typename K>
int grid_for(K kernel, int n, size_t smem, cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  if (smem > 48 * 1024) {
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (*err != cudaSuccess) return 0;
  }
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) per_sm = 1;
  long long need = ((long long)n + kThreads - 1) / kThreads;
  long long cap = (long long)sms * per_sm;
  return (int)(need < cap ? need : cap);
}

Tables make_tables(const void* magic, const void* ids, const void* w, const void* ctnl,
                   const void* size) {
  Tables t{static_cast<const unsigned long long*>(magic), static_cast<const uint32_t*>(ids),
           static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(ctnl),
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
  cudaError_t err;
  int grid = grid_for(straw2_negdraw_kernel, n, 0, &err);
  if (err != cudaSuccess) return (int)err;
  straw2_negdraw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(r),
      static_cast<const uint32_t*>(ids), static_cast<const uint32_t*>(w),
      static_cast<const unsigned long long*>(magic), static_cast<long long*>(out), n, fanout,
      static_cast<const unsigned long long*>(ln));
  return (int)cudaGetLastError();
}

// K2.  level = {nb, fanout, slot_off, size_off} of the chosen level in
// the stacked tables.
int straw2_level_choose(const void* x, const void* r, const void* lidx, int n,
                        const void* magic, const void* ids, const void* w, const void* ctnl,
                        const void* size, int n_slots, int n_sizes, const int* level,
                        const void* ln, void* item, void* ctype, void* nlidx, void* size_out,
                        void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  Level L{level[0], level[1], level[2], level[3]};
  size_t full = table_bytes(n_slots, n_sizes);
  int staged = full <= (size_t)kMaxSmem;
  size_t smem = staged ? full : (size_t)kLnEntries * 8;
  cudaError_t err;
  int grid = grid_for(straw2_level_kernel, n, smem, &err);
  if (err != cudaSuccess) return (int)err;
  straw2_level_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(r),
      static_cast<const uint32_t*>(lidx), n, make_tables(magic, ids, w, ctnl, size), n_slots,
      n_sizes, L, staged, static_cast<const unsigned long long*>(ln),
      static_cast<int32_t*>(item), static_cast<int32_t*>(ctype), static_cast<int32_t*>(nlidx),
      static_cast<int32_t*>(size_out));
  return (int)cudaGetLastError();
}

// K3.  meta: n_levels rows of {nb, fanout, slot_off, size_off}.
int straw2_descend(const void* x, const void* r, const void* lidx, const void* active, int n,
                   const void* magic, const void* ids, const void* w, const void* ctnl,
                   const void* size, int n_slots, int n_sizes, const int* meta, int n_levels,
                   int target_type, int empty_is_hard, int max_devices, const void* ln,
                   void* item, void* nlidx, void* ok, void* hard, void* stream) {
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
  cudaError_t err;
  int grid = grid_for(straw2_descend_kernel, n, smem, &err);
  if (err != cudaSuccess) return (int)err;
  straw2_descend_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(r),
      static_cast<const uint32_t*>(lidx), static_cast<const uint8_t*>(active), n,
      make_tables(magic, ids, w, ctnl, size), n_slots, n_sizes, levels, staged, target_type,
      empty_is_hard, (uint32_t)max_devices, static_cast<const unsigned long long*>(ln),
      static_cast<int32_t*>(item), static_cast<int32_t*>(nlidx), static_cast<uint8_t*>(ok),
      static_cast<uint8_t*>(hard));
  return (int)cudaGetLastError();
}

}  // extern "C"
