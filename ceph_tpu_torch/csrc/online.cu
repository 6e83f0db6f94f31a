// Stripe-buffer kernels for Hopper (sm_90a): the online EC write path's
// epoch step around phase 2's K6 launch.
//
// K9 stripe_absorb_kernel <- the reference package's ec/online.py
//    stripe_buffer_step, phase 1: a lax.fori_loop over one epoch's write
//    batch (an XLA loop, not a Pallas kernel).
// K9's commit, stripe_commit_kernel <- the same function's phase-2 tail:
//    Δparity XORed into each touched slot's parity and the counter row
//    added into the totals (XLA ops, not a Pallas kernel).
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
// decision on the set's keys and ticks in shared memory (the tile's
// threads stage their lanes' keys, chunks, fulls and seeds there, so the
// serial loop reads no global memory), then all threads apply the writes
// to the slot's rows.  A thread owns the same elements of every slot
// (element e = r * words + c, e = t mod threads), so consecutive writes
// to one slot need no barrier between them.  The base and payload rows
// are made in the kernel (crush_hash32_2 of the element index and the
// key or seed, salted), kUnroll independent elements at a time so that
// their dependent hash chains overlap; an install that a full write
// overwrites makes no base rows.
//
// The buffer lanes are updated in place: the step consumes its buffer.
// Δdata is written only for the slots the batch touches, compacted to
// ddata[r, j * words + c] with j the batch lane of the slot's first
// write, and slot_of[j] names that slot; every other entry is written
// as zeros with slot_of[j] = -1 by one block: a valid lane's set, or an
// invalid lane's i mod n_sets.  An entry belongs to the slot, not to the
// key: an install in the middle of the batch replaces it with the base
// rows.  Each thread keeps a bit a way for whether its elements of the
// way's entry are nonzero after the last write, so the touched count
// (slots whose Δdata has a nonzero word: two equal small writes cancel)
// is one barrier a touched way at the end.  The counter row (hits,
// misses, evictions, delta writes, full writes, delta words, full
// words, touched slots) is summed with integer atomics, once a block,
// so the sum is the same in any order.  The tick goes to a separate
// output, since every block reads the input tick.
//
// Bound: at config 10's width (1024 sets x 4 ways of [40, 128] words, a
// batch of 256) the function must move 10-16 MB (5.2 MB of compact
// Δdata, the touched slots' data both ways), ~3-5 us at 3.35 TB/s, and
// make one content hash (~110 integer operations) a word it installs or
// writes: 169 M operations for a random batch of 256, ~5 us at the
// card's int32 rate.  What holds the kernel above that: one set's
// writes run in one block, on one SM, and an install's 5,120 hashes
// take ~5 us at one SM's integer rate, so the set with the longest
// chain of installs sets the kernel's tail.
//
// The commit kernel takes phase 2's K6 output over the compact operand,
// dpar[r, j * words + c], and XORs each owned entry into its slot's
// parity: one block an entry, so no slot is written twice.  Its block 0
// also adds row into totals and writes K9's new tick into the buffer's
// tick, both in place, so the step leaves the whole buffer updated (K9
// cannot write the tick: every block reads it).  Its bytes are the
// owned entries' Δparity and parity (~0.1 MB at config 10): launch-bound.
//
// The CPU models of this order are ec/online.py
// stripe_absorb_by_set_plain and stripe_commit_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxWays = 64;
constexpr int kLanes = 8;
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
  int entry;  // the batch lane whose compact Δdata entry the slot owns
  int flags;  // kInstall | kFull | kFirst
};

constexpr int kInstall = 1, kFull = 2, kFirst = 4;

__global__ void __launch_bounds__(kThreads)
stripe_absorb_kernel(const int* __restrict__ bkeys, const int* __restrict__ bchunks,
                     const unsigned char* __restrict__ bfulls, const int* __restrict__ bseeds,
                     const unsigned char* __restrict__ bvalid, int B, int* keys, uint32_t* data,
                     uint32_t* parity, uint32_t* dirty, int* lru, const int* tick_in,
                     int* tick_out, uint32_t* ddata, int* slot_of, unsigned long long* row,
                     int ways, int kw, int mw, int words, int k, int w) {
  __shared__ int s_keys[kMaxWays];
  __shared__ int s_lru[kMaxWays];
  __shared__ uint32_t s_dirty[kMaxWays];
  __shared__ int s_entry[kMaxWays];
  __shared__ int s_warp_valid[kThreads / 32];
  __shared__ int s_warp_mine[kThreads / 32];
  __shared__ int s_lane[kThreads];
  __shared__ int s_tick[kThreads];
  __shared__ int s_key[kThreads];
  __shared__ int s_chunk[kThreads];
  __shared__ uint32_t s_seed[kThreads];
  __shared__ unsigned char s_full[kThreads];
  __shared__ Write s_write[kThreads];
  __shared__ int s_zero[kThreads];
  __shared__ int s_n, s_nz;

  const int set = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const uint32_t set_mask = (uint32_t)gridDim.x - 1u;
  const long long ld = (long long)B * words;  // a row of the compact Δdata
  const int tick0 = *tick_in;
  for (int i = t; i < ways; i += kThreads) {
    s_keys[i] = keys[(long long)set * ways + i];
    s_lru[i] = lru[(long long)set * ways + i];
    s_dirty[i] = dirty[(long long)set * ways + i];
    s_entry[i] = -1;
  }
  if (t == 0) s_nz = 0;
  long long counts[kLanes] = {0, 0, 0, 0, 0, 0, 0, 0};
  const uint32_t full_dirty = k >= 32 ? 0xFFFFFFFFu : ((1u << k) - 1u);
  const int slot_elems = kw * words;
  uint64_t nonzero = 0;  // bit x: this thread's elements of way x's entry are not all 0
  int carry = 0;         // valid lanes before this tile
  __syncthreads();
  for (int base = 0; base < B; base += kThreads) {
    const int i = base + t;
    int valid = 0, mine = 0, key = 0;
    if (i < B) {
      valid = bvalid[i] != 0;
      key = bkeys[i];
      mine = valid && (crush_hash32_2((uint32_t)key, kSetSalt) & set_mask) == (uint32_t)set;
      if (!valid && ((uint32_t)i & set_mask) == (uint32_t)set) {
        s_zero[atomicAdd(&s_nz, 1)] = i;  // an invalid lane's entry: this block zeroes it
        slot_of[i] = -1;
      }
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
      s_key[m_before] = key;
      s_chunk[m_before] = bchunks[i];
      s_seed[m_before] = (uint32_t)bseeds[i];
      s_full[m_before] = bfulls[i] != 0;
    }
    if (t == 0) s_n = m_tile;
    __syncthreads();
    const int n = s_n;
    if (t == 0) {
      // the decisions, in batch order, on the set's keys and ticks
      for (int j = 0; j < n; ++j) {
        const int li = s_lane[j];
        const int key = s_key[j];
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
        const int full = s_full[j];
        const int chunk = s_chunk[j];
        const int first = s_entry[way] < 0;
        if (first) {
          s_entry[way] = li;
          slot_of[li] = set * ways + way;
        } else {
          s_zero[s_nz++] = li;  // a later write to the slot: its own entry stays zero
          slot_of[li] = -1;
        }
        uint32_t d = install ? 0u : s_dirty[way];
        if (full) d = full_dirty;
        else d |= (chunk >= 0 && chunk < 32) ? (1u << chunk) : 0u;
        s_dirty[way] = d;
        s_keys[way] = key;
        s_lru[way] = s_tick[j];
        s_write[j] = Write{way, chunk, (uint32_t)key, s_seed[j], s_entry[way],
                           (install ? kInstall : 0) | (full ? kFull : 0) | (first ? kFirst : 0)};
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
      uint32_t* de = ddata + (long long)wr.entry * words;
      const bool install = wr.flags & kInstall, full = wr.flags & kFull;
      const bool make_base = install && !full;
      const uint32_t base_salt = wr.key ^ kBaseSalt, pay_salt = wr.seed ^ kPayloadSalt;
      bool nz = false;
      for (int e0 = t; e0 < slot_elems; e0 += kThreads * kUnroll) {
        // the hashes first, kUnroll independent chains, then the memory
        uint32_t hb[kUnroll], hp[kUnroll];
        bool in_chunk[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + u * kThreads;
          in_chunk[u] = !full && (e / words) / w == wr.chunk;
          hb[u] = make_base ? crush_hash32_2((uint32_t)e, base_salt) : 0u;
          hp[u] = (full || in_chunk[u]) ? crush_hash32_2((uint32_t)e, pay_salt) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + u * kThreads;
          if (e >= slot_elems) break;
          const int r = e / words, c = e - r * words;
          uint32_t* dd = de + r * ld + c;
          uint32_t dv, ddv;
          if (full) {
            dv = ddv = hp[u];
          } else {
            if (install) {
              dv = ddv = hb[u];
            } else {
              dv = sd[e];
              ddv = (wr.flags & kFirst) ? 0u : *dd;
            }
            dv ^= hp[u];  // 0 outside the write's chunk
            ddv ^= hp[u];
          }
          sd[e] = dv;
          *dd = ddv;
          nz |= ddv != 0u;
        }
      }
      nonzero = nz ? (nonzero | (1ull << wr.way)) : (nonzero & ~(1ull << wr.way));
      if (install || full) {
        uint32_t* sp = parity + slot * (long long)mw * words;
        for (int e = t; e < mw * words; e += kThreads) sp[e] = 0u;
      }
    }
    const int nzero = s_nz;
    for (int j = 0; j < nzero; ++j) {
      uint32_t* de = ddata + (long long)s_zero[j] * words;
      for (int e = t; e < slot_elems; e += kThreads) {
        const int r = e / words, c = e - r * words;
        de[r * ld + c] = 0u;
      }
    }
    carry += v_tile;
    __syncthreads();  // s_lane, s_tick, s_write and s_zero are rewritten next tile
    if (t == 0) s_nz = 0;
    __syncthreads();
  }
  for (int x = 0; x < ways; ++x) {
    if (s_entry[x] < 0) continue;  // the same for every thread: shared, written before
    const int touched = __syncthreads_or((int)((nonzero >> x) & 1ull));
    if (t == 0) counts[7] += touched != 0;
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

__global__ void __launch_bounds__(kThreads)
stripe_commit_kernel(const uint32_t* __restrict__ dpar, const int* __restrict__ slot_of,
                     uint32_t* parity, const long long* __restrict__ row,
                     const int* __restrict__ tick_new, int* tick, long long* totals, int B,
                     int mw, int words) {
  const int j = blockIdx.x;
  const int t = threadIdx.x;
  if (j == 0 && t < kLanes) totals[t] += row[t];
  if (j == 0 && t == kLanes) *tick = *tick_new;
  if (j >= B) return;
  const int slot = slot_of[j];
  if (slot < 0) return;
  const long long ld = (long long)B * words;
  uint32_t* sp = parity + (long long)slot * mw * words;
  const uint32_t* de = dpar + (long long)j * words;
  for (int e = t; e < mw * words; e += kThreads) {
    const int r = e / words, c = e - r * words;
    sp[e] ^= de[r * ld + c];
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
// tick_in, tick_out: int32 scalars.  ddata: [kw, B * words] u32 and
// slot_of: [B] int32, every entry written.  row: [8] int64, zeroed.
// n_sets a power of two.
int online_stripe_absorb(const void* bkeys, const void* bchunks, const void* bfulls,
                         const void* bseeds, const void* bvalid, int B, void* keys, void* data,
                         void* parity, void* dirty, void* lru, const void* tick_in,
                         void* tick_out, void* ddata, void* slot_of, void* row, int n_sets,
                         int ways, int kw, int mw, int words, int k, int w, void* stream) {
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
      static_cast<int*>(tick_out), static_cast<uint32_t*>(ddata), static_cast<int*>(slot_of),
      static_cast<unsigned long long*>(row), ways, kw, mw, words, k, w);
  return (int)cudaGetLastError();
}

// K9's commit.  dpar: [mw, B * words] u32 (K6 over the compact Δdata),
// slot_of: [B] int32, row: [8] int64, tick_new: int32 scalar (K9's
// tick_out); updated in place: parity [n_slots, mw, words] u32, tick
// int32 scalar (= tick_new), totals [8] int64 (+= row).
int online_stripe_commit(const void* dpar, const void* slot_of, void* parity, const void* row,
                         const void* tick_new, void* tick, void* totals, int B, int mw,
                         int words, void* stream) {
  cudaGetLastError();
  if (B < 0 || mw < 0 || words <= 0) return (int)cudaErrorInvalidValue;
  stripe_commit_kernel<<<B > 0 ? B : 1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dpar), static_cast<const int*>(slot_of),
      static_cast<uint32_t*>(parity), static_cast<const long long*>(row),
      static_cast<const int*>(tick_new), static_cast<int*>(tick),
      static_cast<long long*>(totals), B, mw, words);
  return (int)cudaGetLastError();
}

}  // extern "C"
