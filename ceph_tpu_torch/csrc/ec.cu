// Erasure-coding kernels for Hopper (sm_90a): the byte work of every codec.
//
// They replace the Pallas TPU kernels of ceph_tpu/ec/:
//
//   K4 gf_matrix_tma_kernel  <- pallas_gf.py _matrix_jit / _make_matrix_kernel
//      gf_matrix_kernel         (matrix_encode: GF(2^8) matrix x data)
//   K5 gf2_bitmatrix_tma_kernel <- pallas_kernels.py _encode_padded_jit / _kernel
//      gf2_bitmatrix_kernel     (PallasBitmatrixEncoder: GF(2) bitmatrix x packets)
//   K6 xor_program_smem      <- pallas_kernels.py _schedule_padded_jit / _schedule_kernel
//      xor_program_global       (schedule_apply: the XOR-schedule interpreter)
//   K7 byte_lut16_kernel     <- pallas_gf.py _byte_lut_jit / _byte_lut_kernel
//      byte_lut_kernel          (byte_lut: table[x] for every byte)
//
// What bounds them: device memory.  Each reads every input byte once and
// writes every output byte once; per byte they do little: K4 two
// 4-byte lookups per coefficient per word (m*k per byte column), K5 one
// XOR per set bitmatrix entry per 4-byte word, K7 one lookup.  At the
// card's 3.35 TB/s the bytes take longer than the operations at its
// integer instruction rate, so the designs aim at full-width coalesced loads
// and keep every table on chip:
//
// - K4: a product c*x is split by linearity into c*(x & 7), c*(x & 8),
//   c*(x & 0x70) and c*(x & 0x80): the two 8-entry halves of each
//   coefficient's split nibble tables (lo[x] = c*x, hi[x] = c*(x << 4),
//   32 bytes a coefficient, built on the host) are looked up for 4 bytes
//   at once with one prmt each, and the two high bits select c*8 and
//   c*128 through masks that prmt's sign mode makes.  The selectors and
//   masks are computed once per data word and shared by all m outputs,
//   so a coefficient costs 5 instructions per 4 bytes and no table
//   lookup in memory.  A thread owns 16 byte columns and accumulates 4
//   output rows in registers per pass over the k data rows.  Where the
//   data is 16-byte aligned, TMA bulk copies stage each tile's k rows
//   (4 KB each) into a shared-memory ring of 2-4 tiles (more for small
//   k), so a block has the next tiles in flight while it works one.
//   Else, and for tables over 16 KB (read from global memory through
//   L1), a thread loads its columns itself, one load always in flight.
// - K5: only the set entries are walked.  The host compiles the
//   bitmatrix once into per-output-row lists of input rows
//   (ec/kernels.py Bitmatrix.prog), the rows dealt to 8 groups balanced
//   by entries; a row costs one XOR per entry per 16 bytes, none for
//   its zero entries, and no padded rows.  Where packets are whole
//   16-byte units and the data aligned, a persistent block stages a
//   tile of 512 columns of every input packet row in shared memory
//   with TMA bulk copies (K4's ring, 2-4 tiles deep), and each of its 8
//   warps walks one row group against it, 16 bytes a lane: every input
//   byte is read from device memory once, for any number of output
//   rows, so a 64- or 128-row decoder reads its inputs once.  Else (odd
//   packet sizes, unaligned data, kw over ~200) a thread walks every
//   row over its own 16, 4 or 1 bytes with loads through L1.  Both
//   index the [k, S] chunk layout directly: row s = j*w + l of group g
//   is bytes [g*w*p + l*p, +p) of chunk j, so the host does no packing
//   or transpose.
// - K6: the XOR-schedule interpreter over u32 word rows.  The host
//   compiles the step table into a program (ec/kernels.py
//   compile_program): one op per run of same-destination steps,
//   accumulated in a register; the first write to a zero buffer is an
//   assignment (no zeroing pass); ops ordered by read-after-write level
//   and packed in groups of 16 terms that read nothing the group
//   writes, so a group issues all its loads before its stores; slots
//   reused by liveness.  A thread owns 4 consecutive words (uint4 slots,
//   [slot][threads]), so one term serves 4 words.  Shared-memory path: a
//   persistent block walks column tiles; the program, laid out on the
//   host for the launch shape (byte offsets, a continue bit, groups
//   padded with reads of a zero slot), is loaded once per block and read
//   as broadcast 16-byte loads one group ahead, so a term is one load,
//   4 XORs and a predicated store; outputs collect in output slots and
//   go to global memory once a tile.  TMA bulk copies stage the input
//   rows (4-byte cp.async where a row is not 16-byte aligned), two tiles
//   deep when that leaves as many warps resident, else one while the
//   SM's other blocks compute.  Programs whose slots do not fit a block
//   (w = 32 repairs) run the same ops on a [n_work, NW] device-memory
//   scratch.  What bounds it: the bytes of the n_in input and n_out
//   output rows, then latency: shared memory holds a few hundred word
//   columns of the schedule per SM, so 2-4 warps an SM hide every load.
// - K7: the 256-byte table in shared memory; a thread loads two
//   16-byte units, both issued before its first lookup, and blocks
//   each take one stretch of the data (a 4-byte word a thread, one load
//   in flight, before); unaligned data goes 4 or 1 bytes a thread.
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

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's maximum on Hopper
constexpr int kRowsK4 = 4;        // output rows a K4 thread accumulates per pass
constexpr int kNibbleSmem = 16384;  // K4 stages nibble tables up to this in shared memory
constexpr int kTileK4 = kThreads * 16;  // bytes of a data row in one K4 TMA tile
constexpr int kMaxStagesK4 = 4;         // K4 TMA ring buffers at most
constexpr int kStageBytesK4 = 65536;    // K4 TMA ring size aimed at (3 blocks an SM)

// table[b] for each of the 4 bytes of v
__device__ __forceinline__ uint32_t lut4(const uint8_t* t, uint32_t v) {
  return (uint32_t)t[v & 0xFFu] | ((uint32_t)t[(v >> 8) & 0xFFu] << 8) |
         ((uint32_t)t[(v >> 16) & 0xFFu] << 16) | ((uint32_t)t[v >> 24] << 24);
}

// prmt.b32: bytes of {b, a} picked by the four selector nibbles of s; a
// nibble with bit 3 set gives the sign (bit 7) of its byte, replicated.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
}

// What K4 derives once from a data word and shares among all m outputs:
// lo/hi hold bits 0-2 and 4-6 of each byte as prmt selector nibbles,
// mlo/mhi are 0xFF in each byte whose bit 3 / bit 7 is set.
struct NibbleSel {
  uint32_t lo, hi, mlo, mhi;
};

__device__ __forceinline__ NibbleSel nibble_sel(uint32_t d) {
  const uint32_t x = d & 0x07070707u;
  const uint32_t y = (d >> 4) & 0x07070707u;
  NibbleSel n;
  n.lo = prmt(x | (x >> 4), 0u, 0x0020u);  // nibble b = bits 0-2 of byte b
  n.hi = prmt(y | (y >> 4), 0u, 0x0020u);
  n.mlo = prmt(d << 4, 0u, 0xBA98u);  // sign of each byte of d << 4: bit 3
  n.mhi = prmt(d, 0u, 0xBA98u);
  return n;
}

// Asynchronous copies into shared memory.  TMA bulk copies complete on
// an mbarrier: one thread arms it with the bytes to expect, then any
// threads issue copies that count down those bytes; waiters spin on the
// barrier's phase parity.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One TMA bulk copy global -> shared of bytes (a multiple of 16, both
// addresses 16-byte aligned), completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Rows [0, n) of a tile, one bulk copy each, issued by the 32 lanes of
// warp 0 side by side (threads of other warps do nothing): row r is
// bytes bytes from src + r * pitch into dst + r * dst_pitch.
__device__ __forceinline__ void bulk_rows(uint8_t* dst, size_t dst_pitch, const uint8_t* src,
                                          long long pitch, int n, unsigned bytes, uint64_t* bar) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  if (lane == 0) mbar_expect_tx(bar, bytes * (unsigned)n);
  __syncwarp();
  for (int r = lane; r < n; r += 32) bulk_copy(dst + r * dst_pitch, src + r * pitch, bytes, bar);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;"); }

// K4.  out[j, :] = XOR_i c_ji * data[i, :] over GF(2^8), c * x split by
// linearity as c*(x & 7) ^ c*(x & 8) ^ c*(x & 0x70) ^ c*(x & 0x80).
// nib: m*k rows of 32 bytes, lo[x] = c*x then hi[x] = c*(x << 4) for
// x < 16 (16-byte words tb[2 * row], tb[2 * row + 1]); data [k, S], out
// [m, S], row-major.

// A staged table row: word z of each half, whose low byte is c*8 (lo)
// or c*128 (hi), replicated to all 4 bytes once, so the inner loop
// masks it directly.
__device__ __forceinline__ uint4 replicate_z(uint4 v) {
  v.z = prmt(v.z, 0u, 0u);
  return v;
}

// acc[jj] ^= c_{j0 + jj, i} * d for the 16 bytes d, jj < kRowsK4,
// j0 + jj < m; trow = the tables of data row i.  kReplicated: the
// tables' z words were replicated when they were staged.
template <bool kReplicated>
__device__ __forceinline__ void nibble_accumulate(uint32_t (&acc)[kRowsK4][4],
                                                  const uint32_t (&d)[4],
                                                  const uint4* __restrict__ trow, int j0, int m,
                                                  int k) {
  NibbleSel sel[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) sel[q] = nibble_sel(d[q]);
#pragma unroll
  for (int jj = 0; jj < kRowsK4; ++jj) {
    if (j0 + jj < m) {
      const uint4 lo = trow[(size_t)(j0 + jj) * k * 2], hi = trow[(size_t)(j0 + jj) * k * 2 + 1];
      const uint32_t c8 = kReplicated ? lo.z : prmt(lo.z, 0u, 0u);
      const uint32_t c128 = kReplicated ? hi.z : prmt(hi.z, 0u, 0u);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t a = acc[jj][q] ^ prmt(lo.x, lo.y, sel[q].lo) ^ prmt(hi.x, hi.y, sel[q].hi);
        a ^= sel[q].mlo & c8;
        acc[jj][q] = a ^ (sel[q].mhi & c128);
      }
    }
  }
}

// Output rows j0 .. j0 + kRowsK4 - 1 (< m) at bytes [b0, b0 + nb).
__device__ __forceinline__ void store_rows(uint8_t* __restrict__ out, const uint32_t (&acc)[kRowsK4][4],
                                           int j0, int m, long long S, long long b0, int nb,
                                           bool full) {
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

// The TMA path (S % 16 == 0, data and out 16-byte aligned, tables in
// shared memory): a persistent block walks tiles of kTileK4 bytes; the
// lanes of warp 0 copy a tile's k data rows into shared memory with
// bulk copies, into a ring of `stages` (2 to kMaxStagesK4) buffers, so
// stages - 1 tiles are in flight while one is worked.  A thread owns 16
// bytes of the tile: one conflict-free 16-byte shared load per data row
// (the next row's issued one ahead), 4 output rows in registers per
// pass.  Shared memory: [stages][k][kTileK4] data, then the tables with
// c*8 and c*128 replicated.
__global__ void __launch_bounds__(kThreads)
gf_matrix_tma_kernel(const uint8_t* __restrict__ nib, const uint8_t* __restrict__ data,
                     uint8_t* __restrict__ out, int m, int k, long long S, int stages) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint64_t bar[kMaxStagesK4];
  uint8_t* tiles = smem;
  uint4* tb = reinterpret_cast<uint4*>(smem + (size_t)stages * k * kTileK4);
  const int n16 = m * k * 2;
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    tb[i] = replicate_z(__ldg(reinterpret_cast<const uint4*>(nib) + i));
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&bar[st], 1);
    mbar_fence_init();
  }
  __syncthreads();
  const long long n_tiles = (S + kTileK4 - 1) / kTileK4;
  auto issue = [&](long long tile, int st) {
    const long long b0 = tile * kTileK4;
    const unsigned bytes = (unsigned)(S - b0 < kTileK4 ? S - b0 : kTileK4);
    bulk_rows(tiles + (size_t)st * k * kTileK4, kTileK4, data + b0, S, k, bytes, &bar[st]);
  };
  const long long step = gridDim.x;
  for (int j = 0; j < stages - 1; ++j)
    if (blockIdx.x + j * step < n_tiles) issue(blockIdx.x + j * step, j);
  unsigned phase = 0u;  // bit st: the parity stage st's barrier completes next
  int st = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += step) {
    const long long ahead = tile + (stages - 1) * step;
    if (ahead < n_tiles) issue(ahead, st == 0 ? stages - 1 : st - 1);
    mbar_wait(&bar[st], (phase >> st) & 1u);
    phase ^= 1u << st;
    const long long b0 = tile * kTileK4 + (long long)threadIdx.x * 16;
    if (b0 < S) {
      const uint4* rows = reinterpret_cast<const uint4*>(tiles + (size_t)st * k * kTileK4) +
                          threadIdx.x;
      for (int j0 = 0; j0 < m; j0 += kRowsK4) {
        uint32_t acc[kRowsK4][4];
#pragma unroll
        for (int jj = 0; jj < kRowsK4; ++jj)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[jj][q] = 0u;
        uint4 v = rows[0];
        for (int i = 0; i < k; ++i) {
          const uint32_t d[4] = {v.x, v.y, v.z, v.w};
          if (i + 1 < k) v = rows[(size_t)(i + 1) * (kTileK4 / 16)];  // the next row's load ahead
          nibble_accumulate<true>(acc, d, tb + (size_t)i * 2, j0, m, k);
        }
        store_rows(out, acc, j0, m, S, b0, 16, true);
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
    st = st + 1 == stages ? 0 : st + 1;
  }
}

// The global-load path, for ragged or unaligned data and for tables too
// large to stage: a thread owns 16 byte columns in a grid-stride loop,
// one 16-byte load per data row (byte loads at a ragged end or
// unaligned), the next load, of this column or the next, always in
// flight.  kStaged: the tables in shared memory, else read through L1.
// vec: S % 16 == 0 and both pointers 16-byte aligned.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
gf_matrix_kernel(const uint8_t* __restrict__ nib, const uint8_t* __restrict__ data,
                 uint8_t* __restrict__ out, int m, int k, long long S, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint4* tb = reinterpret_cast<const uint4*>(nib);
  if (kStaged) {
    const int n16 = m * k * 2;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      reinterpret_cast<uint4*>(smem)[i] = replicate_z(__ldg(tb + i));
    __syncthreads();
    tb = reinterpret_cast<const uint4*>(smem);
  }
  const long long ncol = (S + 15) / 16;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // row i of column c: 16 bytes (fewer at the ragged end) as 4 words
  auto load = [&](long long c, int i, uint32_t* d) {
    const long long b0 = c * 16;
    const int nb = (int)(S - b0 < 16 ? S - b0 : 16);
    const uint8_t* src = data + (long long)i * S + b0;
    if (vec && nb == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = 0u;
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (b < nb) d[b >> 2] |= (uint32_t)src[b] << (8 * (b & 3));
    }
  };
  uint32_t d[4], next[4];
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < ncol) load(c, 0, d);
  for (; c < ncol; c += stride) {
    const long long b0 = c * 16;
    const int nb = (int)(S - b0 < 16 ? S - b0 : 16);
    for (int j0 = 0; j0 < m; j0 += kRowsK4) {
      uint32_t acc[kRowsK4][4];
#pragma unroll
      for (int jj = 0; jj < kRowsK4; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[jj][q] = 0u;
      const bool last_pass = j0 + kRowsK4 >= m;
      for (int i = 0; i < k; ++i) {
        // the next load in flight: this column's next row, the first row
        // again for the next pass, or the next column's first row
        if (i + 1 < k) {
          load(c, i + 1, next);
        } else if (!last_pass) {
          load(c, 0, next);
        } else if (c + stride < ncol) {
          load(c + stride, 0, next);
        }
        nibble_accumulate<kStaged>(acc, d, tb + (size_t)i * 2, j0, m, k);
#pragma unroll
        for (int q = 0; q < 4; ++q) d[q] = next[q];
      }
      store_rows(out, acc, j0, m, S, b0, nb, vec && nb == 16);
    }
  }
}

// K5.  out row r = XOR over the input packet rows s whose bitmatrix
// entry (r, s) is set.  data [kw / w, S], out [mw / w, S]: packet row s
// = j*w + l of group g is bytes [g*w*p + l*p, +p) of chunk j; "column"
// x = g*p + c is byte c of group g's packets, cols = S / w of them.
//
// prog (ec/kernels.py Bitmatrix.prog), in uint4 units: words 0..kWarpsK5
// of the first three hold the uint4 index of each row group's first
// row, then the end; a row is a header {n, i, t, 0} (its n entries,
// output chunk i, packet t) and ceil(n / 4) uint4 of entries s | j << 16
// (input row s of chunk j), the last padded.  Row groups are balanced
// by entries on the host; each warp of a block walks one.
constexpr int kTileK5 = 512;      // bytes of each packet row in a K5 tile: 32 lanes x 16
constexpr int kWarpsK5 = 8;       // row groups: the warps of a K5 block
constexpr int kMaxStagesK5 = 4;   // K5 TMA ring buffers at most
constexpr int kStageBytesK5 = 108 * 1024;  // K5 ring and prog aimed at (2 blocks an SM)
static_assert(kThreads == 32 * kWarpsK5, "a K5 block is one warp per row group");

// x / p, in 32 bits while x fits (a 64-bit divide is a long call)
__device__ __forceinline__ long long div_p(long long x, int p) {
  return x <= 0xFFFFFFFFll ? (long long)((unsigned)x / (unsigned)p) : x / p;
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// One row's XOR over a staged tile: entries ent[0 .. n), row s of the
// tile at mine + s * kTileK5; eight loads in flight, then four with the
// padding masked.
__device__ __forceinline__ uint4 walk_staged(const uint4* __restrict__ ent, int n,
                                             const uint8_t* __restrict__ mine) {
  auto row = [&](uint32_t e) {
    return *reinterpret_cast<const uint4*>(mine + (e & 0xFFFFu) * kTileK5);
  };
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  int e = 0;
  for (; e + 8 <= n; e += 8, ent += 2) {
    const uint4 a = ent[0], b = ent[1];
    const uint4 v0 = row(a.x), v1 = row(a.y), v2 = row(a.z), v3 = row(a.w);
    const uint4 v4 = row(b.x), v5 = row(b.y), v6 = row(b.z), v7 = row(b.w);
    acc = xor4(acc, xor4(xor4(xor4(v0, v1), xor4(v2, v3)), xor4(xor4(v4, v5), xor4(v6, v7))));
  }
  for (; e < n; e += 4, ++ent) {
    const uint4 a = ent[0], z = make_uint4(0u, 0u, 0u, 0u);
    const uint4 v0 = row(a.x), v1 = e + 1 < n ? row(a.y) : z;
    const uint4 v2 = e + 2 < n ? row(a.z) : z, v3 = e + 3 < n ? row(a.w) : z;
    acc = xor4(acc, xor4(xor4(v0, v1), xor4(v2, v3)));
  }
  return acc;
}

// The staged path (p % 16 == 0, data and out 16-byte aligned, the ring
// fits): a persistent block walks tiles of kTileK5 columns; the lanes of
// warp 0 copy every input row's columns of a tile (split where a packet
// ends) into a ring of `stages` buffers with TMA bulk copies, so the
// next tiles are in flight while one is worked.  Each warp walks its row
// group against the staged tile, lane L on bytes [16 L, 16 L + 16): one
// conflict-free 16-byte shared load per entry, each input byte read from
// device memory once however many rows use it.  Shared memory:
// [stages][kw][kTileK5] tiles, then prog.
__global__ void __launch_bounds__(kThreads)
gf2_bitmatrix_tma_kernel(const uint4* __restrict__ prog, int prog16,
                         const uint8_t* __restrict__ data, uint8_t* __restrict__ out, int kw,
                         int w, int p, long long S, int stages) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint64_t bar[kMaxStagesK5];
  uint8_t* tiles = smem;
  uint4* sprog = reinterpret_cast<uint4*>(smem + (size_t)stages * kw * kTileK5);
  for (int i = threadIdx.x; i < prog16; i += blockDim.x) sprog[i] = __ldg(prog + i);
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&bar[st], 1);
    mbar_fence_init();
  }
  __syncthreads();
  const long long cols = S / w, wp = (long long)w * p;
  const long long n_tiles = (cols + kTileK5 - 1) / kTileK5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto issue = [&](long long tile, int st) {
    if (warp != 0) return;
    const long long x0 = tile * kTileK5;
    const int len = (int)(cols - x0 < kTileK5 ? cols - x0 : kTileK5);
    if (lane == 0) mbar_expect_tx(&bar[st], (unsigned)len * (unsigned)kw);
    __syncwarp();
    const long long g0 = div_p(x0, p);
    const int pieces = (int)(div_p(x0 + len - 1, p) - g0 + 1);
    uint8_t* stage = tiles + (size_t)st * kw * kTileK5;
    for (int q = lane; q < kw * pieces; q += 32) {
      const int s = q / pieces, j = s / w;
      const long long g = g0 + (q - s * pieces);
      const long long a = g * p > x0 ? g * p : x0;
      const long long b = (g + 1) * p < x0 + len ? (g + 1) * p : x0 + len;
      bulk_copy(stage + (size_t)s * kTileK5 + (a - x0),
                data + j * S + g * wp + (long long)(s - j * w) * p + (a - g * p),
                (unsigned)(b - a), &bar[st]);
    }
  };
  const long long step = gridDim.x;
  for (int j = 0; j < stages - 1; ++j)
    if (blockIdx.x + j * step < n_tiles) issue(blockIdx.x + j * step, j);
  const uint32_t* groups = reinterpret_cast<const uint32_t*>(sprog);
  const int h0 = (int)groups[warp], h1 = (int)groups[warp + 1];
  unsigned phase = 0u;  // bit st: the parity stage st's barrier completes next
  int st = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += step) {
    const long long ahead = tile + (stages - 1) * step;
    if (ahead < n_tiles) issue(ahead, st == 0 ? stages - 1 : st - 1);
    mbar_wait(&bar[st], (phase >> st) & 1u);
    phase ^= 1u << st;
    const long long x = tile * kTileK5 + lane * 16;
    if (x < cols) {
      const long long g = div_p(x, p);
      uint8_t* obase = out + g * wp + (x - g * p);
      const uint8_t* mine = tiles + (size_t)st * kw * kTileK5 + lane * 16;
      for (int h = h0; h < h1;) {
        const uint4 head = sprog[h];
        const uint4 acc = walk_staged(sprog + h + 1, (int)head.x, mine);
        __stcs(reinterpret_cast<uint4*>(obase + (long long)head.y * S + (long long)head.z * p),
               acc);
        h += 1 + (int)((head.x + 3) >> 2);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    st = st + 1 == stages ? 0 : st + 1;
  }
}

// U bytes at a (aligned to U), widened to a uint4 (U < 16: in x).
template <int U>
__device__ __forceinline__ uint4 load_unit(const uint8_t* a) {
  if constexpr (U == 16) return __ldg(reinterpret_cast<const uint4*>(a));
  if constexpr (U == 4) return make_uint4(__ldg(reinterpret_cast<const uint32_t*>(a)), 0u, 0u, 0u);
  if constexpr (U == 1) return make_uint4(__ldg(a), 0u, 0u, 0u);
}

template <int U>
__device__ __forceinline__ void store_unit(uint8_t* a, uint4 v) {
  if constexpr (U == 16) __stcs(reinterpret_cast<uint4*>(a), v);
  if constexpr (U == 4) *reinterpret_cast<uint32_t*>(a) = v.x;
  if constexpr (U == 1) *a = (uint8_t)v.x;
}

// The global-load path, for packets that are not whole 16-byte units,
// unaligned data, and rings that do not fit (kw > ~200): a thread owns
// U bytes of one column in a grid-stride loop and walks every row of
// prog (read through the read-only cache), four loads in flight, each
// input read through L1 for each row that uses it.
template <int U>
__global__ void __launch_bounds__(kThreads)
gf2_bitmatrix_kernel(const uint4* __restrict__ prog, const uint8_t* __restrict__ data,
                     uint8_t* __restrict__ out, int w, int p, long long S) {
  const long long cols = S / w, wp = (long long)w * p, nunit = cols / U;
  const uint32_t* groups = reinterpret_cast<const uint32_t*>(prog);
  const int h0 = (int)__ldg(groups), h1 = (int)__ldg(groups + kWarpsK5);
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < nunit;
       c += (long long)gridDim.x * blockDim.x) {
    const long long x = c * U, g = div_p(x, p);
    const uint8_t* dbase = data + g * wp + (x - g * p);
    uint8_t* obase = out + g * wp + (x - g * p);
    auto row = [&](uint32_t e) {
      const uint32_t j = e >> 16;
      return load_unit<U>(dbase + (long long)j * S + (long long)((e & 0xFFFFu) - j * w) * p);
    };
    for (int h = h0; h < h1;) {
      const uint4 head = __ldg(prog + h);
      const int n = (int)head.x;
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      const uint4 z = acc;
      for (int e = 0; e < n; e += 4) {
        const uint4 a = __ldg(prog + h + 1 + (e >> 2));
        const uint4 v0 = row(a.x), v1 = e + 1 < n ? row(a.y) : z;
        const uint4 v2 = e + 2 < n ? row(a.z) : z, v3 = e + 3 < n ? row(a.w) : z;
        acc = xor4(acc, xor4(xor4(v0, v1), xor4(v2, v3)));
      }
      store_unit<U>(obase + (long long)head.y * S + (long long)head.z * p, acc);
      h += 1 + ((n + 3) >> 2);
    }
  }
}

// K7.  out[i] = table[x[i]].  The 16-byte path (x and out 16-byte
// aligned): each block covers kUnitsK7 * kThreads consecutive 16-byte
// units, a thread issuing the loads of its kUnitsK7 units before its
// first lookup; the n % 16 tail bytes go to the first block's first
// threads.  One block per stretch, not a persistent grid-stride loop:
// blocks that each move one stretch and exit kept a plain copy's rate,
// which the persistent loop fell short of.
constexpr int kUnitsK7 = 2;

__device__ __forceinline__ uint4 lut16(const uint8_t* t, uint4 v) {
  return make_uint4(lut4(t, v.x), lut4(t, v.y), lut4(t, v.z), lut4(t, v.w));
}

__global__ void __launch_bounds__(kThreads)
byte_lut16_kernel(const uint8_t* __restrict__ table, const uint8_t* __restrict__ x,
                  uint8_t* __restrict__ out, long long n) {
  __shared__ uint8_t t[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) t[i] = table[i];
  __syncthreads();
  const long long n16 = n / 16;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const long long c = (long long)blockIdx.x * blockDim.x * kUnitsK7 + threadIdx.x;
  uint4 v[kUnitsK7];
#pragma unroll
  for (int u = 0; u < kUnitsK7; ++u)
    if (c + u * blockDim.x < n16) v[u] = __ldg(xv + c + u * blockDim.x);
#pragma unroll
  for (int u = 0; u < kUnitsK7; ++u)
    if (c + u * blockDim.x < n16) __stcs(ov + c + u * blockDim.x, lut16(t, v[u]));
  const long long tail = n16 * 16 + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) out[tail] = t[x[tail]];
}

// The edge path (x or out not 16-byte aligned): one 4-byte word a
// thread (vec: both 4-byte aligned), else bytes.
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

// K6.  An XOR program (ec/kernels.py compile_program) over u32 word
// rows.  A thread owns kWords consecutive words of every slot (uint4);
// no thread reads another's words, so the program needs no barrier.
constexpr int kWords = 4;
constexpr int kGroupTerms = 16;
constexpr uint32_t kNotEnd = 0xFFFFu;  // the global path's dst code of a term whose op goes on
constexpr uint32_t kToOut = 0x8000u;   // the global path's dst code of an output row

__device__ __forceinline__ uint4 masked_xor(uint4 a, uint32_t keep, uint4 b) {
  return make_uint4((a.x & keep) ^ b.x, (a.y & keep) ^ b.y, (a.z & keep) ^ b.z,
                    (a.w & keep) ^ b.w);
}

// acc to words [c0, c0 + 4) of out row r; full: all 4 in range and the
// row 16-byte aligned.
__device__ __forceinline__ void store_words(uint32_t* __restrict__ out, uint32_t r, long long nw,
                                            long long c0, uint4 acc, bool full) {
  uint32_t* dst = out + (long long)r * nw + c0;
  if (full) {
    __stcs(reinterpret_cast<uint4*>(dst), acc);
  } else {
    const uint32_t a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int q = 0; q < kWords; ++q)
      if (c0 + q < nw) dst[q] = a[q];
  }
}

// One tile of the shared-memory path.  prog: per group, kGroupTerms
// source offsets then kGroupTerms destination words (8 x uint4), offsets
// in bytes from this thread's first slot (slot * blockDim.x * 16, fixed
// on the host for the launch shape and the input stage).  A destination
// word with bit 31 set continues the op; else it ends it and is the
// offset acc is stored to (a work slot or an output slot), and the next
// term restarts acc (acc & keep, keep = 0 after an end).  Short groups
// are padded with terms that read a zero slot.  So a term is one load,
// four XORs and a predicated store, with no branch; a group's 16 loads
// issue before its stores, and its terms are fetched as 8 broadcast
// loads one group ahead.
__device__ __forceinline__ void run_tile(const uint4* __restrict__ prog, int n_groups,
                                         uint8_t* __restrict__ base) {
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  uint32_t keep = 0u;
  uint4 nt[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) nt[q] = prog[q];
  for (int g = 0; g < n_groups; ++g) {
    uint32_t src[kGroupTerms], dst[kGroupTerms];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      src[4 * q] = nt[q].x; src[4 * q + 1] = nt[q].y;
      src[4 * q + 2] = nt[q].z; src[4 * q + 3] = nt[q].w;
      dst[4 * q] = nt[q + 4].x; dst[4 * q + 1] = nt[q + 4].y;
      dst[4 * q + 2] = nt[q + 4].z; dst[4 * q + 3] = nt[q + 4].w;
    }
    uint4 v[kGroupTerms];
#pragma unroll
    for (int t = 0; t < kGroupTerms; ++t) v[t] = *reinterpret_cast<const uint4*>(base + src[t]);
    if (g + 1 < n_groups) {
#pragma unroll
      for (int q = 0; q < 8; ++q) nt[q] = prog[(g + 1) * 8 + q];
    }
#pragma unroll
    for (int t = 0; t < kGroupTerms; ++t) {
      acc = masked_xor(acc, keep, v[t]);
      keep = (uint32_t)((int32_t)dst[t] >> 31);
      if ((int32_t)dst[t] >= 0) *reinterpret_cast<uint4*>(base + dst[t]) = acc;
    }
  }
}

// Shared-memory path: a persistent block walks column tiles of
// blockDim.x * 4 words.  Slots [n_slots][blockDim.x] of uint4: the work
// slots, a zero slot, the n_out output slots (out_slot0 on), then one
// copy of the input rows per stage (in_slot0 on).  kBulk (nw % 4 == 0,
// in and out 16-byte aligned): the lanes of warp 0 copy the input rows'
// tiles with TMA bulk copies (a slot's layout is the row's), completing
// on the stage's mbarrier; else each thread copies its own words with
// 4-byte cp.async.  With 2 stages the next tile's inputs arrive while
// this one runs; with 1, while the SM's other blocks run.  After the
// program, each thread writes its words of the output slots to the
// output rows.  terms: [stages] programs of n_groups groups (run_tile),
// copy s addressing stage s's inputs; they sit after the slots.
template <bool kBulk>
__global__ void __launch_bounds__(128)
xor_program_smem(const uint4* __restrict__ terms, int n_groups, const uint32_t* __restrict__ in,
                 uint32_t* __restrict__ out, int n_in, int n_out, int n_slots, int zero_slot,
                 int out_slot0, int in_slot0, int stages, long long nw) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint64_t bar[2];
  const int tn = blockDim.x, tid = threadIdx.x;
  uint4* slots = reinterpret_cast<uint4*>(smem);
  uint4* sprog = slots + (size_t)n_slots * tn;
  const int n_prog = stages * n_groups * 8;
  for (int i = tid; i < n_prog; i += tn) sprog[i] = __ldg(terms + i);
  uint4* mine = slots + tid;  // slot s of this thread: mine[s * tn]
  mine[(size_t)zero_slot * tn] = make_uint4(0u, 0u, 0u, 0u);
  if (kBulk && tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();

  const long long tile_words = (long long)tn * kWords;
  const long long n_tiles = (nw + tile_words - 1) / tile_words;
  auto stage_tile = [&](long long tile, int stage) {
    uint4* dst = slots + (size_t)(in_slot0 + stage * n_in) * tn;
    const long long w0 = tile * tile_words;
    if (kBulk) {
      const unsigned bytes = (unsigned)((nw - w0 < tile_words ? nw - w0 : tile_words) * 4);
      bulk_rows(reinterpret_cast<uint8_t*>(dst), (size_t)tn * 16,
                reinterpret_cast<const uint8_t*>(in + w0), nw * 4, n_in, bytes, &bar[stage]);
    } else {
      const long long c0 = w0 + (long long)tid * kWords;
      dst += tid;
      for (int r = 0; r < n_in; ++r, dst += tn) {
        const uint32_t* src = in + (long long)r * nw + c0;
#pragma unroll
        for (int q = 0; q < kWords; ++q)
          if (c0 + q < nw) cp_async4(reinterpret_cast<uint32_t*>(dst) + q, src + q);
      }
      cp_async_commit();
    }
  };
  unsigned phase = 0u;  // bit s: the parity stage s's barrier completes next
  auto wait_tile = [&](int stage) {
    if (kBulk) {
      mbar_wait(&bar[stage], (phase >> stage) & 1u);
      phase ^= 1u << stage;
    } else {
      cp_async_wait_all();
    }
  };

  int stage = 0;
  long long tile = blockIdx.x;
  if (tile < n_tiles) stage_tile(tile, 0);
  for (; tile < n_tiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    // with 2 stages the next tile's copies go out first; cp.async groups
    // complete in order, so that path waits for this tile's before
    if (stages == 2 && next < n_tiles) {
      if (!kBulk) wait_tile(stage);
      stage_tile(next, stage ^ 1);
      if (kBulk) wait_tile(stage);
    } else {
      wait_tile(stage);
    }
    run_tile(sprog + (size_t)stage * n_groups * 8, n_groups, reinterpret_cast<uint8_t*>(mine));
    const long long c0 = tile * tile_words + (long long)tid * kWords;
    const bool full = kBulk && c0 + kWords <= nw;
    const uint4* o = mine + (size_t)out_slot0 * tn;
    for (int r = 0; r < n_out; ++r, o += tn) store_words(out, r, nw, c0, *o, full);
    __syncthreads();  // every thread is done with this stage before it is refilled
    if (stages == 2) {
      stage ^= 1;
    } else if (next < n_tiles) {
      stage_tile(next, 0);
    }
  }
}

// Global-memory path, for programs whose slots do not fit a block: the
// flat program (terms src | dst << 16 in groups of groups[g] terms, dst
// kNotEnd, kToOut | row or a work slot), work slots in scratch [n_work,
// nw4 / 4] of uint4 (nw4 = nw rounded up to 4 words), inputs read from
// in, the program through the read-only cache.  vec: nw % 4 == 0 and
// in, out 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
xor_program_global(const uint32_t* __restrict__ terms, const uint16_t* __restrict__ groups,
                   int n_groups, const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   uint4* __restrict__ scratch, int n_work, long long nw, int vec) {
  const long long n4 = (nw + kWords - 1) / kWords;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < n4;
       c += (long long)gridDim.x * blockDim.x) {
    const long long c0 = c * kWords;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    int t0 = 0;
    for (int g = 0; g < n_groups; ++g) {
      const int T = __ldg(groups + g);
      uint32_t term[kGroupTerms];
      uint4 v[kGroupTerms];
#pragma unroll
      for (int t = 0; t < kGroupTerms; ++t) {
        if (t < T) {
          term[t] = __ldg(terms + t0 + t);
          const uint32_t s = term[t] & 0xFFFFu;
          if (s < (uint32_t)n_work) {
            v[t] = scratch[(size_t)s * n4 + c];
          } else {
            const uint32_t* src = in + (long long)(s - n_work) * nw + c0;
            if (vec) {
              v[t] = __ldg(reinterpret_cast<const uint4*>(src));
            } else {
              uint32_t a[4] = {0u, 0u, 0u, 0u};
#pragma unroll
              for (int q = 0; q < kWords; ++q)
                if (c0 + q < nw) a[q] = __ldg(src + q);
              v[t] = make_uint4(a[0], a[1], a[2], a[3]);
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kGroupTerms; ++t) {
        if (t < T) {
          acc = masked_xor(acc, 0xFFFFFFFFu, v[t]);
          const uint32_t d = term[t] >> 16;
          if (d != kNotEnd) {
            if (d & kToOut) {
              store_words(out, d & 0x7FFFu, nw, c0, acc, vec && c0 + kWords <= nw);
            } else {
              scratch[(size_t)d * n4 + c] = acc;
            }
            acc = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
      t0 += T;
    }
  }
}

// Launch settings, made once: per kernel and device, the dynamic
// shared memory it is lifted to and whether it prefers shared memory
// over L1; per kernel, device, shared memory and block, the blocks that
// can be resident.  A launch that finds its entry makes no driver call
// besides the launch.
struct Lifted {
  const void* fn;
  int dev;
  size_t smem;  // the kernel's dynamic shared-memory limit as set
  bool carveout;
};

struct Resident {
  const void* fn;
  int dev;
  size_t smem;
  int block;
  int blocks;  // SMs x blocks per SM
};

std::mutex g_launch_mu;
Lifted g_lifted[16];
int g_n_lifted = 0;
Resident g_resident[64];
int g_n_resident = 0;

cudaError_t lift(const void* fn, int dev, size_t smem, bool carveout) {
  constexpr size_t kDefault = 48 * 1024;
  Lifted* e = nullptr;
  for (int i = 0; i < g_n_lifted; ++i)
    if (g_lifted[i].fn == fn && g_lifted[i].dev == dev) e = &g_lifted[i];
  if (!e && g_n_lifted < 16) {
    e = &g_lifted[g_n_lifted++];
    *e = Lifted{fn, dev, kDefault, false};
  }  // else: untracked, so set again by every launch that needs it
  if (carveout && !(e && e->carveout)) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (e) e->carveout = true;
  }
  if (smem > (e ? e->smem : kDefault)) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (e) e->smem = smem;
  }
  return cudaSuccess;
}

// Grid of a grid-stride launch: no more blocks than can be resident at
// once (each block stages its tables once), no more than the work needs.
// carveout: the kernel prefers shared memory over L1.
template <typename K>
int grid_for(K kernel, long long n, size_t smem, cudaError_t* err, int block = kThreads,
             bool carveout = false) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0, blocks = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  {
    std::lock_guard<std::mutex> lock(g_launch_mu);
    *err = lift(fn, dev, smem, carveout);
    if (*err != cudaSuccess) return 0;
    for (int i = 0; i < g_n_resident && !blocks; ++i) {
      const Resident& e = g_resident[i];
      if (e.fn == fn && e.dev == dev && e.smem == smem && e.block == block) blocks = e.blocks;
    }
    if (!blocks) {
      int sms = 0, per_sm = 0;
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (*err != cudaSuccess) return 0;
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem);
      if (*err != cudaSuccess) return 0;
      blocks = sms * (per_sm < 1 ? 1 : per_sm);
      if (g_n_resident < 64) g_resident[g_n_resident++] = Resident{fn, dev, smem, block, blocks};
    }
  }
  const long long need = (n + block - 1) / block;
  return (int)(need < blocks ? need : blocks);
}

bool aligned(const void* a, uintptr_t to) { return reinterpret_cast<uintptr_t>(a) % to == 0; }

template <int U>
int launch_bitmatrix(const uint4* prog, const void* data, void* out, int w, int p, long long S,
                     cudaStream_t stream) {
  cudaError_t err;
  int grid = grid_for(gf2_bitmatrix_kernel<U>, S / w / U, 0, &err);
  if (err != cudaSuccess) return (int)err;
  gf2_bitmatrix_kernel<U><<<grid, kThreads, 0, stream>>>(
      prog, static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out), w, p, S);
  return (int)cudaGetLastError();
}

template <bool kBulk>
int launch_program(const uint4* terms, int n_groups, const uint32_t* in, uint32_t* out, int n_in,
                   int n_out, int n_slots, int zero_slot, int out_slot0, int in_slot0, int stages,
                   long long nw, int threads, size_t smem, cudaStream_t st) {
  cudaError_t err;
  const long long tile = (long long)threads * kWords;
  int grid = grid_for(xor_program_smem<kBulk>, (nw + tile - 1) / tile * threads, smem, &err,
                      threads, true);
  if (err != cudaSuccess) return (int)err;
  xor_program_smem<kBulk><<<grid, threads, smem, st>>>(terms, n_groups, in, out, n_in, n_out,
                                                       n_slots, zero_slot, out_slot0, in_slot0,
                                                       stages, nw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4.  nib: [m*k, 32] u8 nibble tables, 16-byte aligned; data: [k, S]
// u8; out: [m, S] u8.
int ec_matrix_encode(const void* nib, const void* data, void* out, int m, int k, long long S,
                     void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (S <= 0 || m <= 0) return 0;
  if (k <= 0 || !aligned(nib, 16)) return (int)cudaErrorInvalidValue;
  const size_t tbytes = (size_t)m * k * 32;
  const int vec = S % 16 == 0 && aligned(data, 16) && aligned(out, 16);
  const long long ncol = (S + 15) / 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const uint8_t* t = static_cast<const uint8_t*>(nib);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  // as many ring stages as fit kStageBytesK4, 2 to kMaxStagesK4: small k
  // keeps more tiles in flight
  const long long fit = kStageBytesK4 / ((long long)k * kTileK4);
  const int stages = (int)(fit < 2 ? 2 : fit > kMaxStagesK4 ? kMaxStagesK4 : fit);
  const size_t tma_smem = (size_t)stages * k * kTileK4 + tbytes;
  if (vec && tbytes <= (size_t)kNibbleSmem && tma_smem <= (size_t)kMaxSmem - 64) {
    int grid = grid_for(gf_matrix_tma_kernel, (S + kTileK4 - 1) / kTileK4 * kThreads, tma_smem,
                        &err);
    if (err != cudaSuccess) return (int)err;
    gf_matrix_tma_kernel<<<grid, kThreads, tma_smem, st>>>(t, d, o, m, k, S, stages);
  } else if (tbytes <= (size_t)kNibbleSmem) {
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

// K5.  prog: [prog16] uint4 (ec/kernels.py Bitmatrix.prog), 16-byte
// aligned; data: [kw / w, S] u8; out: [mw / w, S] u8; S a multiple of
// w * p.
int ec_bitmatrix_encode(const void* prog, int prog16, const void* data, void* out, int kw, int mw,
                        int w, int p, long long S, void* stream) {
  cudaGetLastError();
  if (S <= 0 || mw <= 0) return 0;
  if (w <= 0 || p <= 0 || kw <= 0 || kw > 0xFFFF || prog16 < 3 || !aligned(prog, 16) ||
      S % ((long long)w * p) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* pr = static_cast<const uint4*>(prog);
  const bool vec = p % 16 == 0 && aligned(data, 16) && aligned(out, 16);
  // as many ring stages as fit kStageBytesK5 beside prog, 2 to kMaxStagesK5
  const size_t pbytes = (size_t)prog16 * 16, stage = (size_t)kw * kTileK5;
  const long long fit = ((long long)kStageBytesK5 - (long long)pbytes) / (long long)stage;
  const int stages = (int)(fit < 2 ? 2 : fit > kMaxStagesK5 ? kMaxStagesK5 : fit);
  const size_t smem = stages * stage + pbytes;
  if (vec && smem <= (size_t)kMaxSmem - 64) {
    cudaError_t err;
    const long long n_tiles = (S / w + kTileK5 - 1) / kTileK5;
    int grid = grid_for(gf2_bitmatrix_tma_kernel, n_tiles * kThreads, smem, &err, kThreads, true);
    if (err != cudaSuccess) return (int)err;
    gf2_bitmatrix_tma_kernel<<<grid, kThreads, smem, st>>>(
        pr, prog16, static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out), kw, w, p, S,
        stages);
    return (int)cudaGetLastError();
  }
  if (vec) return launch_bitmatrix<16>(pr, data, out, w, p, S, st);
  if (p % 4 == 0 && aligned(data, 4) && aligned(out, 4))
    return launch_bitmatrix<4>(pr, data, out, w, p, S, st);
  return launch_bitmatrix<1>(pr, data, out, w, p, S, st);
}

// K6.  threads > 0: the shared-memory path, blocks of threads (<= 128,
// a multiple of 32) and stages (1 or 2) copies of the inputs; terms:
// [stages, n_groups, 2, kGroupTerms] u32 addressed for that shape
// (ec/kernels.py XorProgram.smem_terms), n_slots uint4 slots a thread.
// threads == 0: the global path; terms: [n_terms] u32 of slot indices
// in groups of groups[g] (u16) terms, on scratch [n_work, ceil(nw / 4) *
// 4] u32, 16-byte aligned.  in: [n_in, nw] u32; out: [n_out, nw] u32.
int ec_xor_program(const void* terms, const void* groups, int n_terms, int n_groups,
                   const void* in, void* out, void* scratch, int n_in, int n_out, int n_work,
                   int n_slots, int zero_slot, int out_slot0, int in_slot0, int threads,
                   int stages, long long nw, void* stream) {
  cudaGetLastError();
  if (nw <= 0 || n_out <= 0) return 0;
  if (n_in < 0 || n_work < 0 || n_terms < 0 || n_groups < 0 || threads < 0 || threads > 128 ||
      (threads > 0 && (threads % 32 != 0 || (stages != 1 && stages != 2) || !aligned(terms, 16) ||
                       zero_slot < 0 || in_slot0 < 0 || in_slot0 + stages * n_in > n_slots ||
                       zero_slot >= n_slots || out_slot0 < 0 || out_slot0 + n_out > n_slots)) ||
      (threads == 0 && n_work > 0 && (scratch == nullptr || !aligned(scratch, 16))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* i = static_cast<const uint32_t*>(in);
  uint32_t* o = static_cast<uint32_t*>(out);
  const int vec = nw % kWords == 0 && aligned(in, 16) && aligned(out, 16);
  if (threads > 0) {
    const size_t smem = ((size_t)n_slots * threads + (size_t)stages * n_groups * 8) * 16;
    if (smem > (size_t)kMaxSmem - 16) return (int)cudaErrorInvalidValue;
    const uint4* tm = static_cast<const uint4*>(terms);
    if (vec)
      return launch_program<true>(tm, n_groups, i, o, n_in, n_out, n_slots, zero_slot, out_slot0,
                                  in_slot0, stages, nw, threads, smem, st);
    return launch_program<false>(tm, n_groups, i, o, n_in, n_out, n_slots, zero_slot, out_slot0,
                                 in_slot0, stages, nw, threads, smem, st);
  }
  cudaError_t err;
  int grid = grid_for(xor_program_global, (nw + kWords - 1) / kWords, 0, &err);
  if (err != cudaSuccess) return (int)err;
  xor_program_global<<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(terms), static_cast<const uint16_t*>(groups), n_groups, i, o,
      static_cast<uint4*>(scratch), n_work, nw, vec);
  return (int)cudaGetLastError();
}

// K7.  table: [256] u8; x, out: [n] u8.
int ec_byte_lut(const void* table, const void* x, void* out, long long n, void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* t = static_cast<const uint8_t*>(table);
  const uint8_t* xi = static_cast<const uint8_t*>(x);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (aligned(x, 16) && aligned(out, 16)) {
    const long long stretch = (long long)kThreads * kUnitsK7 * 16;
    const long long grid = (n + stretch - 1) / stretch;
    if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    byte_lut16_kernel<<<(unsigned)grid, kThreads, 0, st>>>(t, xi, o, n);
  } else {
    const int vec = aligned(x, 4) && aligned(out, 4);
    cudaError_t err;
    int grid = grid_for(byte_lut_kernel, (n + 3) / 4, 0, &err);
    if (err != cudaSuccess) return (int)err;
    byte_lut_kernel<<<grid, kThreads, 0, st>>>(t, xi, o, n, vec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
