// Erasure-coding kernels for Hopper (sm_90a): the byte work of every codec.
//
// They replace the Pallas TPU kernels of ceph_tpu/ec/:
//
//   K4 gf_matrix_kernel      <- pallas_gf.py _matrix_jit / _make_matrix_kernel
//                               (matrix_encode: GF(2^8) matrix x data)
//   K5 gf2_bitmatrix_kernel  <- pallas_kernels.py _encode_padded_jit / _kernel
//                               (PallasBitmatrixEncoder: GF(2) bitmatrix x packets)
//   K6 xor_schedule_kernel   <- pallas_kernels.py _schedule_padded_jit / _schedule_kernel
//                               (schedule_apply: the XOR-schedule interpreter)
//   K7 byte_lut_kernel       <- pallas_gf.py _byte_lut_jit / _byte_lut_kernel
//                               (byte_lut: table[x] for every byte)
//
// What bounds them: device memory.  Each reads every input byte once and
// writes every output byte once; per byte they do little: K4 one table
// lookup per coefficient (m*k per byte column, 24 at k=8 m=3), K5 one
// masked XOR per bitmatrix entry per 4-byte word, K7 one lookup.  At the
// card's 3.35 TB/s the bytes take longer than the operations at its
// integer instruction rate, so the designs aim at full-width coalesced loads
// and keep every table on chip:
//
// - K4: a thread owns 16 byte columns (one 16-byte load per data row)
//   and accumulates 4 output rows in registers per pass over the k data
//   rows.  The m*k 256-byte product tables sit in shared memory when
//   they fit a block's 227 KB (6 KB at k=8 m=3), else they are read from
//   global memory through L1 (w=8 allows k+m up to 256).  Random byte
//   lookups into a 256-byte table conflict on shared-memory banks; that
//   is the first thing a faster version would remove (nibble tables
//   held in registers with __byte_perm).
// - K5: the bitmatrix is held as one 32-bit mask word per input packet
//   row and tile of RT output rows (bit r = entry (tile*RT + r, s)), in
//   shared memory.  A thread owns one 4-byte word (1 byte when the
//   packet size is not a multiple of 4) of one packet column, walks the
//   k*w input packet rows once, and XORs each into the RT accumulators
//   its mask selects.  Tiles of output rows (grid y) keep the
//   accumulators in registers for any w (w = 32 decoders have 256 rows).
//   It indexes the [k, S] chunk layout directly: row s = j*w + l of
//   group g is bytes [g*w*p + l*p, +p) of chunk j, so the host does no
//   packing or transpose.
// - K6: a data-dependent interpreter over u32 word rows.  Buffers are
//   [inputs | outputs | derived]; step (dst, src) is buf[dst] ^= buf[src].
//   Steps only ever combine rows of one word column, so a thread owns one
//   column of every buffer and runs the whole step table on it: no
//   __syncthreads anywhere.  The step table is read by every thread of a
//   warp at once (__ldg, a broadcast).  The buffers of a block's TN
//   columns sit in shared memory as [n_bufs][TN], consecutive threads on
//   consecutive banks, when n_bufs * TN * 4 bytes fit a block (TN = 128,
//   else 64); larger schedules (w = 32 repairs with up to 1024 derived
//   rows) run on a [n_bufs, NW] scratch in device memory, still one
//   coalesced column per thread.  Each step is a dependent load-XOR-store
//   on the same column, so the shared path is bound by shared-memory
//   latency and occupancy (n_bufs sets how many columns fit an SM); the
//   bytes it must move are only the n_in input and n_out output rows.
// - K7: the 256-byte table in shared memory, one 4-byte word per thread.
//
// What the TPU versions needed and these do not: 128-lane table halves
// selected by compare (tpu.dynamic_gather), bytes packed four to a u32
// lane with host-side padding to the tile, per-packet padding to whole
// words, the [KW, MW, 1] mask layout that dodged a lane-strided load,
// and the x64 scoping.
//
// Every launcher returns cudaGetLastError() as an int; 0 is success.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's maximum on Hopper
constexpr int kRowsK4 = 4;        // output rows a K4 thread accumulates per pass

// table[b] for each of the 4 bytes of v
__device__ __forceinline__ uint32_t lut4(const uint8_t* t, uint32_t v) {
  return (uint32_t)t[v & 0xFFu] | ((uint32_t)t[(v >> 8) & 0xFFu] << 8) |
         ((uint32_t)t[(v >> 16) & 0xFFu] << 16) | ((uint32_t)t[v >> 24] << 24);
}

// K4.  out[j, :] = XOR_i tables[j*k + i][data[i, :]] over GF(2^8).
// tables: m*k rows of 256 bytes; data [k, S], out [m, S], row-major.
// vec: S % 16 == 0 and both pointers 16-byte aligned (else byte loads).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
gf_matrix_kernel(const uint8_t* __restrict__ tables, const uint8_t* __restrict__ data,
                 uint8_t* __restrict__ out, int m, int k, long long S, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* tb = tables;
  if (kStaged) {
    const int n16 = m * k * 16;  // 16-byte words of the tables
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      reinterpret_cast<uint4*>(smem)[i] = __ldg(reinterpret_cast<const uint4*>(tables) + i);
    __syncthreads();
    tb = smem;
  }
  const long long ncol = (S + 15) / 16;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < ncol;
       c += (long long)gridDim.x * blockDim.x) {
    const long long b0 = c * 16;
    const int nb = (int)(S - b0 < 16 ? S - b0 : 16);
    const bool full = vec && nb == 16;
    for (int j0 = 0; j0 < m; j0 += kRowsK4) {
      uint32_t acc[kRowsK4][4];
#pragma unroll
      for (int jj = 0; jj < kRowsK4; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[jj][q] = 0u;
      for (int i = 0; i < k; ++i) {
        const uint8_t* src = data + (long long)i * S + b0;
        uint32_t d[4] = {0u, 0u, 0u, 0u};
        if (full) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
          d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
        } else {
#pragma unroll
          for (int b = 0; b < 16; ++b)
            if (b < nb) d[b >> 2] |= (uint32_t)src[b] << (8 * (b & 3));
        }
#pragma unroll
        for (int jj = 0; jj < kRowsK4; ++jj) {
          if (j0 + jj < m) {
            const uint8_t* t = tb + ((size_t)(j0 + jj) * k + i) * 256;
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[jj][q] ^= lut4(t, d[q]);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < kRowsK4; ++jj) {
        if (j0 + jj < m) {
          uint8_t* dst = out + (long long)(j0 + jj) * S + b0;
          if (full) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3]);
          } else {
#pragma unroll
            for (int b = 0; b < 16; ++b)
              if (b < nb) dst[b] = (uint8_t)(acc[jj][b >> 2] >> (8 * (b & 3)));
          }
        }
      }
    }
  }
}

// K5.  out row r = XOR over input packet rows s with bitmatrix[r, s] set.
// masks: [n_tiles, kw] words, bit r of masks[tile*kw + s] = entry
// (tile*RT + r, s).  data [kw / w, S], out [mw / w, S]; U bytes a unit.
template <int U, int RT>
__global__ void __launch_bounds__(kThreads)
gf2_bitmatrix_kernel(const uint32_t* __restrict__ masks, const uint8_t* __restrict__ data,
                     uint8_t* __restrict__ out, int kw, int mw, int w, int p, long long S) {
  extern __shared__ uint32_t smask[];
  const int tile = blockIdx.y;
  for (int s = threadIdx.x; s < kw; s += blockDim.x) smask[s] = masks[(size_t)tile * kw + s];
  __syncthreads();
  const long long nunit = S / w / U;  // units along one packet row
  const long long wp = (long long)w * p;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < nunit;
       c += (long long)gridDim.x * blockDim.x) {
    const long long pos = c * U;  // byte offset along the packet row
    const long long g = pos / p;
    const long long base = g * wp + (pos - g * p);
    uint32_t acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0u;
    int j = 0, l = 0;
    for (int s = 0; s < kw; ++s) {
      const uint8_t* src = data + (long long)j * S + base + (long long)l * p;
      uint32_t d;
      if constexpr (U == 4) {
        d = __ldg(reinterpret_cast<const uint32_t*>(src));
      } else {
        d = (uint32_t)__ldg(src);
      }
      const uint32_t msk = smask[s];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] ^= d & (0u - ((msk >> r) & 1u));
      if (++l == w) {
        l = 0;
        ++j;
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row = tile * RT + r;
      if (row < mw) {
        const int i = row / w;
        uint8_t* dst = out + (long long)i * S + base + (long long)(row - i * w) * p;
        if constexpr (U == 4) {
          *reinterpret_cast<uint32_t*>(dst) = acc[r];
        } else {
          *dst = (uint8_t)acc[r];
        }
      }
    }
  }
}

// K7.  out[i] = table[x[i]]; vec: both pointers 4-byte aligned.
__global__ void __launch_bounds__(kThreads)
byte_lut_kernel(const uint8_t* __restrict__ table, const uint8_t* __restrict__ x,
                uint8_t* __restrict__ out, long long n, int vec) {
  __shared__ uint8_t t[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) t[i] = table[i];
  __syncthreads();
  const long long nw = (n + 3) / 4;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < nw;
       c += (long long)gridDim.x * blockDim.x) {
    const long long b0 = c * 4;
    if (vec && b0 + 4 <= n) {
      *reinterpret_cast<uint32_t*>(out + b0) = lut4(t, __ldg(reinterpret_cast<const uint32_t*>(x + b0)));
    } else {
      for (int b = 0; b < 4 && b0 + b < n; ++b) out[b0 + b] = t[x[b0 + b]];
    }
  }
}

// K6.  Buffers [inputs | outputs | derived] of one word column per
// thread: rows [0, n_in) from in [n_in, nw], the rest zero; each step
// (dst, src) of steps [n_steps, 2] does buf[dst] ^= buf[src]; rows
// [n_in, n_in + n_out) go to out [n_out, nw].  kShared: the block's
// blockDim.x columns of every buffer in shared memory, [n_bufs][TN];
// else scratch [n_bufs, nw] in device memory.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
xor_schedule_kernel(const int* __restrict__ steps, int n_steps, const uint32_t* __restrict__ in,
                    uint32_t* __restrict__ out, uint32_t* __restrict__ scratch, int n_in,
                    int n_out, int n_bufs, long long nw) {
  extern __shared__ uint32_t sbuf[];
  const int tn = blockDim.x;
  for (long long c0 = (long long)blockIdx.x * tn; c0 < nw; c0 += (long long)gridDim.x * tn) {
    const long long c = c0 + threadIdx.x;
    if (c >= nw) continue;  // a thread touches only its own column
    if constexpr (kShared) {
      uint32_t* buf = sbuf + threadIdx.x;
      for (int r = 0; r < n_in; ++r) buf[r * tn] = __ldg(in + (long long)r * nw + c);
      for (int r = n_in; r < n_bufs; ++r) buf[r * tn] = 0u;
      for (int i = 0; i < n_steps; ++i) {
        const int dst = __ldg(steps + 2 * i), src = __ldg(steps + 2 * i + 1);
        buf[dst * tn] ^= buf[src * tn];
      }
      for (int r = 0; r < n_out; ++r) out[(long long)r * nw + c] = buf[(n_in + r) * tn];
    } else {
      uint32_t* buf = scratch + c;
      for (int r = 0; r < n_in; ++r) buf[r * nw] = __ldg(in + (long long)r * nw + c);
      for (int r = n_in; r < n_bufs; ++r) buf[r * nw] = 0u;
      for (int i = 0; i < n_steps; ++i) {
        const int dst = __ldg(steps + 2 * i), src = __ldg(steps + 2 * i + 1);
        buf[dst * nw] ^= buf[src * nw];
      }
      for (int r = 0; r < n_out; ++r) out[(long long)r * nw + c] = buf[(n_in + r) * nw];
    }
  }
}

// Grid of a grid-stride launch: no more blocks than can be resident at
// once (each block stages its tables once), no more than the work needs.
template <typename K>
int grid_for(K kernel, long long n, size_t smem, cudaError_t* err, int block = kThreads) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  if (smem > 48 * 1024) {
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (*err != cudaSuccess) return 0;
  }
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem);
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) per_sm = 1;
  long long need = (n + block - 1) / block;
  long long cap = (long long)sms * per_sm;
  return (int)(need < cap ? need : cap);
}

bool aligned(const void* a, uintptr_t to) { return reinterpret_cast<uintptr_t>(a) % to == 0; }

template <int U, int RT>
int launch_bitmatrix(const void* masks, const void* data, void* out, int kw, int mw, int w, int p,
                     long long S, cudaStream_t stream) {
  const long long nunit = S / w / U;
  const size_t smem = (size_t)kw * 4;
  cudaError_t err;
  int grid = grid_for(gf2_bitmatrix_kernel<U, RT>, nunit, smem, &err);
  if (err != cudaSuccess) return (int)err;
  dim3 blocks(grid, (mw + RT - 1) / RT);
  gf2_bitmatrix_kernel<U, RT><<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(masks), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), kw, mw, w, p, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4.  tables: [m*k, 256] u8; data: [k, S] u8; out: [m, S] u8.
int ec_matrix_encode(const void* tables, const void* data, void* out, int m, int k,
                     long long S, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (S <= 0 || m <= 0) return 0;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  const size_t tbytes = (size_t)m * k * 256;
  const int vec = S % 16 == 0 && aligned(data, 16) && aligned(out, 16);
  const long long ncol = (S + 15) / 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const uint8_t* t = static_cast<const uint8_t*>(tables);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (tbytes <= (size_t)kMaxSmem) {
    int grid = grid_for(gf_matrix_kernel<true>, ncol, tbytes, &err);
    if (err != cudaSuccess) return (int)err;
    gf_matrix_kernel<true><<<grid, kThreads, tbytes, st>>>(t, d, o, m, k, S, vec);
  } else {
    int grid = grid_for(gf_matrix_kernel<false>, ncol, 0, &err);
    if (err != cudaSuccess) return (int)err;
    gf_matrix_kernel<false><<<grid, kThreads, 0, st>>>(t, d, o, m, k, S, vec);
  }
  return (int)cudaGetLastError();
}

// K5.  masks: [ceil(mw / rt), kw] u32; data: [kw / w, S] u8; out:
// [mw / w, S] u8; S a multiple of w * p; rt in {8, 16, 32}.
int ec_bitmatrix_encode(const void* masks, const void* data, void* out, int kw, int mw, int w,
                        int p, int rt, long long S, void* stream) {
  cudaGetLastError();
  if (S <= 0 || mw <= 0) return 0;
  if (w <= 0 || p <= 0 || kw <= 0 || S % ((long long)w * p) != 0 || (size_t)kw * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool word = p % 4 == 0 && aligned(data, 4) && aligned(out, 4);
  if (word) {
    if (rt == 8) return launch_bitmatrix<4, 8>(masks, data, out, kw, mw, w, p, S, st);
    if (rt == 16) return launch_bitmatrix<4, 16>(masks, data, out, kw, mw, w, p, S, st);
    if (rt == 32) return launch_bitmatrix<4, 32>(masks, data, out, kw, mw, w, p, S, st);
  } else {
    if (rt == 8) return launch_bitmatrix<1, 8>(masks, data, out, kw, mw, w, p, S, st);
    if (rt == 16) return launch_bitmatrix<1, 16>(masks, data, out, kw, mw, w, p, S, st);
    if (rt == 32) return launch_bitmatrix<1, 32>(masks, data, out, kw, mw, w, p, S, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K6.  steps: [n_steps, 2] i32, every index in [0, n_bufs); in: [n_in,
// nw] u32; out: [n_out, nw] u32.  tn > 0: shared-memory path with tn
// columns a block (n_bufs * tn * 4 bytes of shared memory); tn == 0:
// global path on scratch [n_bufs, nw] u32.
int ec_xor_schedule(const void* steps, int n_steps, const void* in, void* out, void* scratch,
                    int n_in, int n_out, int n_bufs, int tn, long long nw, void* stream) {
  cudaGetLastError();
  if (nw <= 0 || n_out <= 0) return 0;
  if (n_in < 0 || n_steps < 0 || n_bufs < n_in + n_out || tn < 0 || tn > kThreads ||
      (tn == 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int* s = static_cast<const int*>(steps);
  const uint32_t* i = static_cast<const uint32_t*>(in);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (tn > 0) {
    const size_t smem = (size_t)n_bufs * tn * 4;
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(xor_schedule_kernel<true>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    int grid = grid_for(xor_schedule_kernel<true>, nw, smem, &err, tn);
    if (err != cudaSuccess) return (int)err;
    xor_schedule_kernel<true><<<grid, tn, smem, st>>>(s, n_steps, i, o, nullptr, n_in, n_out,
                                                      n_bufs, nw);
  } else {
    int grid = grid_for(xor_schedule_kernel<false>, nw, 0, &err);
    if (err != cudaSuccess) return (int)err;
    xor_schedule_kernel<false><<<grid, kThreads, 0, st>>>(
        s, n_steps, i, o, static_cast<uint32_t*>(scratch), n_in, n_out, n_bufs, nw);
  }
  return (int)cudaGetLastError();
}

// K7.  table: [256] u8; x, out: [n] u8.
int ec_byte_lut(const void* table, const void* x, void* out, long long n, void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  const int vec = aligned(x, 4) && aligned(out, 4);
  cudaError_t err;
  int grid = grid_for(byte_lut_kernel, (n + 3) / 4, 0, &err);
  if (err != cudaSuccess) return (int)err;
  byte_lut_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<const uint8_t*>(x),
      static_cast<uint8_t*>(out), n, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
