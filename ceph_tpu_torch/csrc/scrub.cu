// Scrub kernel for Hopper (sm_90a): CRC32C of rows.
//
// K8 crc32c_rows_kernel <- the reference package's recovery/scrub.py
//    _crc_rows, a lax.fori_loop over the bytes of a row vmapped over the
//    rows (an XLA loop, not a Pallas kernel).
//
// out[r] = CRC32C(data[r, 0:L]): the Castagnoli polynomial, reflected
// (0x82F63B78), init and final XOR 0xFFFFFFFF — ceph_crc32c's checksum
// as the scrub compares it; crc32c("123456789") = 0xE3069283.
//
// Design (the simple one): one thread per row, the 256-entry table built
// into shared memory by each block, the row read with 16-byte loads and
// its bytes chained through the table in registers.  A row that does not
// start on a 16-byte boundary (rows of a stacked view, odd L) takes its
// head byte by byte up to the boundary, then 16-byte loads, then its
// tail byte by byte.  Rows beyond one grid are covered by a grid-stride
// loop.  The work a row is serial (each byte's lookup depends on the
// last), so a thread's time is L table lookups; many rows keep the card
// busy.  What bounds the function is the bytes read (CRC is linear, so a
// warp per row with CRC combining could reach it: later work).
//
// Every launcher returns cudaGetLastError() as an int; 0 is success.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kPoly = 0x82F63B78u;
constexpr long long kMaxBlocks = 1LL << 20;

__device__ __forceinline__ uint32_t crc_byte(const uint32_t* table, uint32_t crc, uint32_t b) {
  return (crc >> 8) ^ table[(crc ^ b) & 0xFFu];
}

__device__ __forceinline__ uint32_t crc_word(const uint32_t* table, uint32_t crc, uint32_t w) {
  crc = crc_byte(table, crc, w);
  crc = crc_byte(table, crc, w >> 8);
  crc = crc_byte(table, crc, w >> 16);
  return crc_byte(table, crc, w >> 24);
}

__global__ void __launch_bounds__(kThreads) crc32c_rows_kernel(
    const uint8_t* __restrict__ data, long long n, long long L, long long* __restrict__ out) {
  __shared__ uint32_t table[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t c = (uint32_t)i;
    for (int b = 0; b < 8; ++b) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
    table[i] = c;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    const uint8_t* p = data + r * L;
    const uint8_t* end = p + L;
    uint32_t crc = 0xFFFFFFFFu;
    while (p < end && (reinterpret_cast<uintptr_t>(p) & 15u)) crc = crc_byte(table, crc, *p++);
    const long long vecs = (long long)(end - p) >> 4;
    const uint4* q = reinterpret_cast<const uint4*>(p);
    for (long long v = 0; v < vecs; ++v) {
      const uint4 w = __ldg(q + v);
      crc = crc_word(table, crc, w.x);
      crc = crc_word(table, crc, w.y);
      crc = crc_word(table, crc, w.z);
      crc = crc_word(table, crc, w.w);
    }
    p += vecs << 4;
    while (p < end) crc = crc_byte(table, crc, *p++);
    out[r] = (long long)(crc ^ 0xFFFFFFFFu);
  }
}

}  // namespace

extern "C" {

const char* scrub_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K8.  data: [n, L] u8, rows L bytes apart (any alignment); out: [n]
// int64, each the row's CRC32C as an unsigned 32-bit value.
int scrub_crc32c_rows(const void* data, long long n, long long L, void* out, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (n <= 0) return 0;
  if (L < 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  crc32c_rows_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, L, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
