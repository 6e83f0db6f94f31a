// Stripe-buffer kernel for Hopper (sm_90a): phase 1 of the online EC
// write path.
//
// K9 stripe_absorb_kernel <- the reference package's ec/online.py
//    stripe_buffer_step, phase 1: a lax.fori_loop over one epoch's write
//    batch (an XLA loop, not a Pallas kernel).
//
// For each valid write of the batch, in order: find its set
// (crush_hash32_2(key, kSetSalt) & (n_sets - 1)); a hit is the first way
// whose key equals it, else the victim is the first minimum of the
// set's LRU ticks (empty slots hold -1) and the stripe installs from the
// backing store (data = hash rows of the key, parity 0, Δdata = data,
// dirty 0); then a full-stripe write replaces data and Δdata with the
// op's payload rows (parity 0, dirty = every chunk), or a small write
// XORs the payload into its chunk's w rows of data and Δdata (dirty |=
// its chunk's bit).  The slot takes the key and the write's tick.  An
// invalid lane changes nothing.
//
// Writes to different sets never interact, and the only thing the sets
// share is the LRU clock: the tick a write stamps is the starting tick
// plus the count of valid writes before it in the batch.  So one block
// takes one set: it walks the batch in tiles of its threads, computes
// every lane's set and the valid prefix counts (warp ballots), compacts
// the lanes of its own set in order, lets thread 0 make each write's
// decision on the set's keys and ticks in shared memory, then all
// threads apply the writes to the slot's rows.  A thread owns the same
// elements of every slot (element e = r * words + c, e = t mod threads),
// so consecutive writes to one slot need no barrier between them.  The
// base and payload rows are made in the kernel (crush_hash32_2 of the
// element index and the key or seed, salted).
//
// Δdata goes to ddata[r, slot * words + c]: the slots stacked along the
// word axis, which is what phase 2's K6 launch takes; the wrapper zeroes
// it.  The counter row (hits, misses, evictions, delta writes, full
// writes, delta words, full words) is summed with integer atomics: each
// block adds its own counts once, so the sum is the same in any order.
// The buffer lanes are updated in place (the wrapper passes clones);
// the tick goes to a separate output, since every block reads the input
// tick.
//
// The CPU model of this order is ec/online.py stripe_absorb_by_set_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWays = 64;
constexpr int kLanes = 7;
constexpr uint32_t kSetSalt = 0xB5297A4Du;
constexpr uint32_t kPayloadSalt = 0x68E31DA4u;
constexpr uint32_t kBaseSalt = 0x1B56C4E9u;

__device__ __forceinline__ void crush_mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a = a - b - c; a ^= c >> 13;
  b = b - c - a; b ^= a << 8;
  c = c - a - b; c ^= b >> 13;
  a = a - b - c; a ^= c >> 12;
  b = b - c - a; b ^= a << 16;
  c = c - a - b; c ^= b >> 5;
  a = a - b - c; a ^= c >> 3;
  b = b - c - a; b ^= a << 10;
  c = c - a - b; c ^= b >> 15;
}

__device__ __forceinline__ uint32_t crush_hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = 1315423911u ^ a ^ b;
  uint32_t x = 231232u, y = 1232u;
  crush_mix(a, b, h);
  crush_mix(x, a, h);
  crush_mix(b, y, h);
  return h;
}

// one write's decision, made by thread 0
struct Write {
  int way;
  int chunk;
  uint32_t key;
  uint32_t seed;
  int install;
  int full;
};

__global__ void __launch_bounds__(kThreads)
stripe_absorb_kernel(const int* __restrict__ bkeys, const int* __restrict__ bchunks,
                     const unsigned char* __restrict__ bfulls, const int* __restrict__ bseeds,
                     const unsigned char* __restrict__ bvalid, int B, int* keys, uint32_t* data,
                     uint32_t* parity, uint32_t* dirty, int* lru, const int* tick_in,
                     int* tick_out, uint32_t* ddata, unsigned long long* row, int ways, int kw,
                     int mw, int words, int k, int w) {
  __shared__ int s_keys[kMaxWays];
  __shared__ int s_lru[kMaxWays];
  __shared__ uint32_t s_dirty[kMaxWays];
  __shared__ int s_warp_valid[kThreads / 32];
  __shared__ int s_warp_mine[kThreads / 32];
  __shared__ int s_lane[kThreads];
  __shared__ int s_tick[kThreads];
  __shared__ Write s_write[kThreads];
  __shared__ int s_n;

  const int set = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const uint32_t set_mask = (uint32_t)gridDim.x - 1u;
  const long long n_slots = (long long)gridDim.x * ways;
  const int tick0 = *tick_in;
  for (int i = t; i < ways; i += kThreads) {
    s_keys[i] = keys[(long long)set * ways + i];
    s_lru[i] = lru[(long long)set * ways + i];
    s_dirty[i] = dirty[(long long)set * ways + i];
  }
  long long counts[kLanes] = {0, 0, 0, 0, 0, 0, 0};
  const uint32_t full_dirty = k >= 32 ? 0xFFFFFFFFu : ((1u << k) - 1u);
  const int slot_elems = kw * words;
  int carry = 0;  // valid lanes before this tile
  for (int base = 0; base < B; base += kThreads) {
    const int i = base + t;
    int valid = 0, mine = 0;
    if (i < B) {
      valid = bvalid[i] != 0;
      mine = valid && (crush_hash32_2((uint32_t)bkeys[i], kSetSalt) & set_mask) == (uint32_t)set;
    }
    const unsigned vb = __ballot_sync(0xFFFFFFFFu, valid);
    const unsigned mb = __ballot_sync(0xFFFFFFFFu, mine);
    if (lane == 0) {
      s_warp_valid[warp] = __popc(vb);
      s_warp_mine[warp] = __popc(mb);
    }
    __syncthreads();
    int v_before = carry, m_before = 0, v_tile = 0, m_tile = 0;
    for (int j = 0; j < kThreads / 32; ++j) {
      if (j < warp) {
        v_before += s_warp_valid[j];
        m_before += s_warp_mine[j];
      }
      v_tile += s_warp_valid[j];
      m_tile += s_warp_mine[j];
    }
    const unsigned below = (1u << lane) - 1u;
    v_before += __popc(vb & below);
    m_before += __popc(mb & below);
    if (mine) {
      s_lane[m_before] = i;
      s_tick[m_before] = tick0 + v_before;
    }
    if (t == 0) s_n = m_tile;
    __syncthreads();
    const int n = s_n;
    if (t == 0) {
      // the decisions, in batch order, on the set's keys and ticks
      for (int j = 0; j < n; ++j) {
        const int li = s_lane[j];
        const int key = bkeys[li];
        int way = -1;
        for (int x = 0; x < ways; ++x)
          if (s_keys[x] == key) { way = x; break; }
        const int hit = way >= 0;
        if (!hit) {
          way = 0;
          for (int x = 1; x < ways; ++x)
            if (s_lru[x] < s_lru[way]) way = x;
        }
        const int install = !hit;
        const int evict = install && s_keys[way] >= 0;
        const int full = bfulls[li] != 0;
        const int chunk = bchunks[li];
        uint32_t d = install ? 0u : s_dirty[way];
        if (full) d = full_dirty;
        else d |= (chunk >= 0 && chunk < 32) ? (1u << chunk) : 0u;
        s_dirty[way] = d;
        s_keys[way] = key;
        s_lru[way] = s_tick[j];
        s_write[j] = Write{way, chunk, (uint32_t)key, (uint32_t)bseeds[li], install, full};
        counts[0] += hit;
        counts[1] += install;
        counts[2] += evict;
        counts[3] += !full;
        counts[4] += full;
        counts[5] += (!full && hit) ? (long long)w * words : 0;
        counts[6] += (full || !hit) ? (long long)slot_elems : 0;
      }
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const Write wr = s_write[j];
      const long long slot = (long long)set * ways + wr.way;
      uint32_t* sd = data + slot * slot_elems;
      for (int e = t; e < slot_elems; e += kThreads) {
        const int r = e / words, c = e - r * words;
        uint32_t* dd = ddata + (long long)r * (n_slots * words) + slot * words + c;
        uint32_t dv, ddv;
        if (wr.install) {
          dv = ddv = crush_hash32_2((uint32_t)e, wr.key ^ kBaseSalt);
        } else {
          dv = sd[e];
          ddv = *dd;
        }
        if (wr.full) {
          dv = ddv = crush_hash32_2((uint32_t)e, wr.seed ^ kPayloadSalt);
        } else if (r / w == wr.chunk) {
          const uint32_t p = crush_hash32_2((uint32_t)e, wr.seed ^ kPayloadSalt);
          dv ^= p;
          ddv ^= p;
        }
        sd[e] = dv;
        *dd = ddv;
      }
      if (wr.install || wr.full) {
        uint32_t* sp = parity + slot * (long long)mw * words;
        for (int e = t; e < mw * words; e += kThreads) sp[e] = 0u;
      }
    }
    carry += v_tile;
    __syncthreads();  // s_lane, s_tick and s_write are rewritten next tile
  }
  for (int i = t; i < ways; i += kThreads) {
    keys[(long long)set * ways + i] = s_keys[i];
    lru[(long long)set * ways + i] = s_lru[i];
    dirty[(long long)set * ways + i] = s_dirty[i];
  }
  if (t == 0) {
#pragma unroll
    for (int x = 0; x < kLanes; ++x)
      if (counts[x]) atomicAdd(row + x, (unsigned long long)counts[x]);
    if (set == 0) *tick_out = tick0 + carry;
  }
}

}  // namespace

extern "C" {

const char* online_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K9.  Batch lanes [B]: bkeys int32, bchunks int32, bfulls bool, bseeds
// int32 (u32 bits), bvalid bool.  Buffer lanes, updated in place:
// keys/lru [n_sets, ways] int32, data [n_sets, ways, kw, words] and
// parity [n_sets, ways, mw, words] u32, dirty [n_sets, ways] u32.
// tick_in, tick_out: int32 scalars.  ddata: [kw, n_sets * ways * words]
// u32, zeroed.  row: [7] int64, zeroed.  n_sets a power of two.
int online_stripe_absorb(const void* bkeys, const void* bchunks, const void* bfulls,
                         const void* bseeds, const void* bvalid, int B, void* keys, void* data,
                         void* parity, void* dirty, void* lru, const void* tick_in,
                         void* tick_out, void* ddata, void* row, int n_sets, int ways, int kw,
                         int mw, int words, int k, int w, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (n_sets <= 0 || (n_sets & (n_sets - 1)) || ways <= 0 || ways > kMaxWays || kw <= 0 ||
      mw < 0 || words <= 0 || w <= 0 || k <= 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  stripe_absorb_kernel<<<n_sets, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bkeys), static_cast<const int*>(bchunks),
      static_cast<const unsigned char*>(bfulls), static_cast<const int*>(bseeds),
      static_cast<const unsigned char*>(bvalid), B, static_cast<int*>(keys),
      static_cast<uint32_t*>(data), static_cast<uint32_t*>(parity),
      static_cast<uint32_t*>(dirty), static_cast<int*>(lru), static_cast<const int*>(tick_in),
      static_cast<int*>(tick_out), static_cast<uint32_t*>(ddata),
      static_cast<unsigned long long*>(row), ways, kw, mw, words, k, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
