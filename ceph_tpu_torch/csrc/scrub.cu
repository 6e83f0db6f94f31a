// Scrub kernel for Hopper (sm_90a): CRC32C of rows.
//
// K8 crc32c_rows_kernel <- the reference package's recovery/scrub.py
//    _crc_rows, a lax.fori_loop over the bytes of a row vmapped over the
//    rows (an XLA loop, not a Pallas kernel).
//
// out[r] = CRC32C(data[r, 0:L]): the Castagnoli polynomial, reflected
// (0x82F63B78), init and final XOR 0xFFFFFFFF — ceph_crc32c's checksum
// as the scrub compares it; crc32c("123456789") = 0xE3069283; L = 0
// gives 0.
//
// What bounds it: the bytes read (one table lookup a byte costs less on
// this card than a byte of HBM).  A row's CRC is one dependent chain, so
// the design cuts each row into segments that lanes fold at once and
// combines their CRCs (zlib's crc32_combine idea):
//
//   R(c, M) = S_|M|(c) ^ R(0, M), S_n(c) = c * x^(8n) mod P (reflected),
//   so R(0, A||B) = S_|B|(R(0, A)) ^ R(0, B), and
//   CRC32C(row) = R(0, row) ^ S_L(0xFFFFFFFF) ^ 0xFFFFFFFF.
//
// - W = 2^log_w lanes a row (one to 512: a warp a row at the scrub
//   pass's [90112, 32768], a block a row at a decode-verify call's
//   [32, 32768]), each folding one segment of `seg` bytes (a multiple of
//   16).  Segments are aligned to the row's end: lane W-1 takes the last
//   `seg` bytes, the first segment may be short and lanes before it are
//   empty (R = 0).  The host picks (log_w, seg) from the shape alone
//   (recovery/scrub.py crc_segments): enough lanes to fill 132 SMs x
//   512 threads, and about 1 KiB a lane on long rows.
// - A lane folds its segment four bytes at a time by slicing-by-4
//   tables, one copy per bank ([4][256][32] u32, 128 KiB of shared
//   memory, lane l reading column l), so a warp's 32 random lookups never
//   conflict.
// - Reads: on the H100 a warp's loads reach the HBM rate only when each
//   takes whole 128-byte lines; lanes that each stream their own segment
//   16, 32 or 64 contiguous bytes a load run at about two thirds of it
//   (PERF.md).  So when every segment is whole and 16-byte aligned
//   (W >= 8, seg W = L), groups of eight lanes read a line of one of
//   their eight segments a load, stage the words in shared memory where
//   the segment's lane reads them (a 144-byte row a lane, 72 KiB a
//   block, no bank conflicts), and keep two steps of 128 bytes a lane in
//   flight.  Otherwise (rows of a stacked view, odd L, a short first
//   segment) a lane reads its own segment: its head byte by byte up to a
//   16-byte boundary, then 16-byte loads, four a step with the next four
//   in flight, then its tail.
// - The lanes of a row combine in a tree: at level d, lane l (l a
//   multiple of 2^(d+1)) takes a <- S_{seg 2^d}(a) ^ a[l + 2^d].  The
//   right block is always whole (a short segment or an empty lane only
//   ever opens a row), so every level has one operator, applied by four
//   lookups in its byte tables; within a warp by shuffles, across warps
//   through shared memory.
// - Blocks of 512 threads are persistent (one an SM: tables and staging
//   fill 200 KiB) and stride over the rows, so the tables are built once
//   a block and any n fits.
//
// The operand `consts` (u32, host-built and cached per shape by
// recovery/scrub.py crc_operand): words [0, 1024) the slicing tables
// T0..T3 (T0 the byte table), then for each tree level d < log_w the
// byte tables of S_{seg 2^d}, 4 x 256 words each.  `init` is
// S_L(0xFFFFFFFF) ^ 0xFFFFFFFF.  The CPU model of this decomposition is
// recovery/scrub.py crc_rows_segmented_plain, held against the byte chain
// in tests/test_torch_crc_combine.py.
//
// Every launcher returns cudaGetLastError() as an int; 0 is success.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

extern __shared__ uint32_t tables[];  // T0..T3 one copy a bank ([4][256][32]), then staging

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLogW = 9;                         // a row's lanes fit one block
constexpr int kTableWords = 4 * 256;                // T0..T3, or one operator's tables
constexpr int kTableBytes = 256 * 32 * 4;           // one table, one copy per bank
constexpr int kGroup = 8;                           // lanes that share a 128-byte line
constexpr int kStageRow = kGroup * 16 + 16;         // a lane's staged line, padded
constexpr int kStageWarp = 32 * kStageRow;
constexpr int kSmemBytes = 4 * kTableBytes + (kThreads / 32) * kStageWarp;  // 200 KiB
constexpr int kVecs = 4;                            // 16-byte loads a step (own segment)

// Entry i of table k for the lane whose 4 x lane is `lane4`, where `x`
// holds i in bits 7..14: k * kTableBytes + 128 i + 4 lane bytes into the
// tables (masking x and OR-ing in lane4 is one LOP3).
template <int k>
__device__ __forceinline__ uint32_t lds(uint32_t x, uint32_t lane4) {
  return *reinterpret_cast<const uint32_t*>(reinterpret_cast<const char*>(tables) +
                                            k * kTableBytes + ((x & 0x7F80u) | lane4));
}

__device__ __forceinline__ uint32_t fold_byte(uint32_t lane4, uint32_t crc, uint32_t b) {
  return lds<0>((crc ^ b) << 7, lane4) ^ (crc >> 8);
}

__device__ __forceinline__ uint32_t fold_word(uint32_t lane4, uint32_t crc, uint32_t w) {
  const uint32_t c = crc ^ w;
  return lds<3>(c << 7, lane4) ^ lds<2>(c >> 1, lane4) ^ lds<1>(c >> 9, lane4) ^
         lds<0>(c >> 17, lane4);
}

__device__ __forceinline__ uint32_t fold_vec(uint32_t lane4, uint32_t crc, uint4 v) {
  crc = fold_word(lane4, crc, v.x);
  crc = fold_word(lane4, crc, v.y);
  crc = fold_word(lane4, crc, v.z);
  return fold_word(lane4, crc, v.w);
}

// R(0, p[0:len)): the register after the bytes from state 0.
__device__ uint32_t fold_segment(uint32_t lane4, const uint8_t* p, long long len) {
  uint32_t crc = 0;
  const uint8_t* end = p + len;
  while (p < end && (reinterpret_cast<uintptr_t>(p) & 15u))
    crc = fold_byte(lane4, crc, __ldg(p++));
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const long long vecs = (end - p) >> 4;
  long long v = 0;
  if (vecs >= kVecs) {
    uint4 cur[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) cur[u] = __ldg(q + u);
    for (v = kVecs; v + kVecs <= vecs; v += kVecs) {
      uint4 next[kVecs];
#pragma unroll
      for (int u = 0; u < kVecs; ++u) next[u] = __ldg(q + v + u);
#pragma unroll
      for (int u = 0; u < kVecs; ++u) crc = fold_vec(lane4, crc, cur[u]);
#pragma unroll
      for (int u = 0; u < kVecs; ++u) cur[u] = next[u];
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) crc = fold_vec(lane4, crc, cur[u]);
  }
  for (; v < vecs; ++v) crc = fold_vec(lane4, crc, __ldg(q + v));
  p += vecs << 4;
  while (p < end) crc = fold_byte(lane4, crc, __ldg(p++));
  return crc;
}

// The group's loads of step s: load k reads 16-byte word q of line s of
// the group's segment k (the group's first segment at `first`), so the
// eight lanes of a load take one whole 128-byte line.
__device__ __forceinline__ void load_lines(uint4 v[kGroup], const uint8_t* first, long long seg,
                                           long long s, int q) {
  const uint8_t* p = first + (s << 7) + 16 * q;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) v[k] = __ldg(reinterpret_cast<const uint4*>(p + k * seg));
}

// One step of a group: stage the loaded words where their segment's lane
// reads them (row b + k, word q of `stage`), load step s + 2 into the
// same registers, then fold the lane's own staged line.
__device__ __forceinline__ uint32_t stage_and_fold(uint32_t lane4, unsigned mask, uint32_t crc,
                                                   uint4 v[kGroup], char* stage, int lane,
                                                   const uint8_t* first, long long seg,
                                                   long long s, long long steps) {
  const int q = lane & (kGroup - 1), b = lane & ~(kGroup - 1);
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
    *reinterpret_cast<uint4*>(stage + (b + k) * kStageRow + 16 * q) = v[k];
  __syncwarp(mask);
  if (s + 2 < steps) load_lines(v, first, seg, s + 2, q);
  const uint4* own = reinterpret_cast<const uint4*>(stage + lane * kStageRow);
#pragma unroll
  for (int k = 0; k < kGroup; ++k) crc = fold_vec(lane4, crc, own[k]);
  __syncwarp(mask);
  return crc;
}

// R(0, own segment) for a group of kGroup lanes (lane-in-row l, all eight
// in one row) whose segments of `seg` bytes lie side by side from `first`
// (16-byte aligned): 128 bytes a lane a step, every load a whole line,
// two steps in flight.  The lanes of the group call it together.
__device__ uint32_t fold_group(uint32_t lane4, char* stage, const uint8_t* first, long long seg) {
  const int lane = lane4 >> 2;
  const unsigned mask = 0xFFu << (lane & ~(kGroup - 1));
  const long long steps = seg >> 7;
  uint32_t crc = 0;
  uint4 a[kGroup], b[kGroup];
  if (steps > 0) load_lines(a, first, seg, 0, lane & (kGroup - 1));
  if (steps > 1) load_lines(b, first, seg, 1, lane & (kGroup - 1));
  for (long long s = 0; s < steps; s += 2) {
    crc = stage_and_fold(lane4, mask, crc, a, stage, lane, first, seg, s, steps);
    if (s + 1 < steps) crc = stage_and_fold(lane4, mask, crc, b, stage, lane, first, seg, s + 1,
                                            steps);
  }
  const uint4* q = reinterpret_cast<const uint4*>(first + (lane & (kGroup - 1)) * seg +
                                                  (steps << 7));
  for (int v = 0; v < (int)((seg & 127) >> 4); ++v) crc = fold_vec(lane4, crc, __ldg(q + v));
  return crc;
}

// S(a) by the operator's byte tables m[k][i] = S(i << 8k).
__device__ __forceinline__ uint32_t shift(const uint32_t* __restrict__ m, uint32_t a) {
  return __ldg(m + (a & 0xFFu)) ^ __ldg(m + 256 + ((a >> 8) & 0xFFu)) ^
         __ldg(m + 512 + ((a >> 16) & 0xFFu)) ^ __ldg(m + 768 + (a >> 24));
}

__global__ void __launch_bounds__(kThreads, 1) crc32c_rows_kernel(
    const uint8_t* __restrict__ data, long long n, long long L, int log_w, long long seg,
    bool grouped, const uint32_t* __restrict__ consts, uint32_t init,
    long long* __restrict__ out) {
  __shared__ uint32_t warp_crc[kThreads / 32];
  for (int i = threadIdx.x; i < kTableWords * 32; i += kThreads)
    tables[i] = __ldg(consts + (i >> 5));
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int W = 1 << log_w;
  const int l = threadIdx.x & (W - 1);           // lane within the row
  const int rows = kThreads >> log_w;            // rows a pass
  const uint32_t lane4 = 4u * lane;
  char* stage = reinterpret_cast<char*>(tables) + 4 * kTableBytes +
                (threadIdx.x >> 5) * kStageWarp;  // the warp's staged lines
  const long long end = L - (long long)(W - 1 - l) * seg;  // the lane's segment [begin, end)
  const long long begin = end - seg > 0 ? end - seg : 0;
  const int warp_levels = log_w < 5 ? log_w : 5;
  for (long long r0 = (long long)blockIdx.x * rows; r0 < n; r0 += (long long)gridDim.x * rows) {
    const long long r = r0 + (threadIdx.x >> log_w);
    uint32_t a = 0;
    if (r < n && grouped)
      a = fold_group(lane4, stage, data + r * L + (l & ~(kGroup - 1)) * seg, seg);
    else if (r < n && end > 0)
      a = fold_segment(lane4, data + r * L + begin, end - begin);
    for (int d = 0; d < warp_levels; ++d) {
      const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, a, 1 << d);
      a = shift(consts + kTableWords * (1 + d), a) ^ right;
    }
    if (log_w <= 5) {
      if (l == 0 && r < n) out[r] = (long long)(a ^ init);
      continue;
    }
    if (lane == 0) warp_crc[threadIdx.x >> 5] = a;
    __syncthreads();
    if (threadIdx.x < 32) {  // warp 0 combines the warps of each row
      constexpr int kWarps = kThreads / 32;
      a = lane < kWarps ? warp_crc[lane] : 0;
      for (int d = 5; d < log_w; ++d) {
        const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, a, 1 << (d - 5));
        a = shift(consts + kTableWords * (1 + d), a) ^ right;
      }
      const int warps = 1 << (log_w - 5);      // warps a row
      const long long rr = r0 + (lane >> (log_w - 5));
      if (lane < kWarps && (lane & (warps - 1)) == 0 && rr < n) out[rr] = (long long)(a ^ init);
    }
    __syncthreads();
  }
}

std::mutex g_mu;
int g_sms[16];  // SMs of each device whose shared-memory limit is lifted (0: not yet)

}  // namespace

extern "C" {

const char* scrub_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K8.  data: [n, L] u8, rows L bytes apart (any alignment); out: [n]
// int64, each the row's CRC32C as an unsigned 32-bit value.  log_w, seg,
// consts, init: the segmentation and operand described above (seg a
// multiple of 16, seg << log_w >= L).
int scrub_crc32c_rows(const void* data, long long n, long long L, int log_w, long long seg,
                      const void* consts, long long init, void* out, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (n <= 0) return 0;
  if (L < 0 || log_w < 0 || log_w > kMaxLogW || seg < 16 || seg % 16 || (seg << log_w) < L)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 16) return (int)cudaErrorInvalidDevice;
  int sms;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (!g_sms[dev]) {
      err = cudaFuncSetAttribute(crc32c_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return (int)err;
    }
    sms = g_sms[dev];
  }
  const long long rows = kThreads >> log_w;
  const long long passes = (n + rows - 1) / rows;
  const int blocks = (int)(passes < sms ? passes : sms);
  // groups of eight lanes share lines when every segment is whole and aligned
  const bool grouped = (1 << log_w) >= kGroup && (seg << log_w) == L &&
                       reinterpret_cast<uintptr_t>(data) % 16 == 0;
  crc32c_rows_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, L, log_w, seg, grouped,
      static_cast<const uint32_t*>(consts), (uint32_t)init, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
