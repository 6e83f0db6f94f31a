"""How fast a warp reads rows on the card, by the shape of its loads.

    python -m ceph_tpu_torch.testing.read_patterns

Times five read-only kernels over K8's scrub-pass shape, ``[90112,
32768]`` u8 (2.95 GB, a warp a row, 1 KiB a lane as K8 cuts it): each
reads every byte once with 16-byte loads and XORs it into a register,
differing only in which bytes the 32 lanes of one load take:

- ``own_16``: each lane its own segment, 16 bytes a load (K8's first
  design: 32 places 1 KiB apart a load);
- ``pair_32``: two lanes a 32-byte sector of one segment (16 places);
- ``quad_64``: four lanes 64 bytes of one segment (8 places);
- ``octet_128``: eight lanes a whole 128-byte line of one segment (4
  places; K8's staged reads);
- ``coalesced``: the warp 512 contiguous bytes a load.

Each kernel runs one 512-thread block an SM with 200 KiB of shared
memory reserved, as K8 does.  Prints one JSON line: the card and its
power limit, and each
pattern's milliseconds (CUDA events around one launch, median of 10,
twice) beside the bytes' bound at 3.35 TB/s.  The source is compiled by
``nvcc`` into ``ceph_tpu_torch/_build/`` at run time.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from .. import _cuda

PATTERNS = ("own_16", "pair_32", "quad_64", "octet_128", "coalesced")
ROWS, L = 90112, 32768
SMEM = 204800

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
// a warp a row, 1 KiB a lane; G lanes take 16 G contiguous bytes of one segment a load
template <int G>
__global__ void __launch_bounds__(512, 1) rd(const uint8_t* __restrict__ data, long long n,
                                            long long L, uint32_t* out) {
  extern __shared__ uint32_t sm[];
  const int lane = threadIdx.x & 31, q = lane & (G - 1), b = lane & ~(G - 1);
  uint32_t acc = 0;
  for (long long r0 = (long long)blockIdx.x * 16; r0 < n; r0 += (long long)gridDim.x * 16) {
    const long long r = r0 + (threadIdx.x >> 5);
    if (r >= n) continue;
    if (G == 32) {  // coalesced: the warp takes 512 contiguous bytes a load
      const uint4* p = reinterpret_cast<const uint4*>(data + r * L);
      for (int s = 0; s < 2048; s += 128) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint4 v = __ldg(p + s + 32 * u + lane);
          acc ^= v.x ^ v.y ^ v.z ^ v.w;
        }
      }
    } else {
      const uint8_t* base = data + r * L + b * 1024 + 16 * q;
      for (int s = 0; s < 1024; s += 16 * G) {
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(base + k * 1024 + s));
          acc ^= v.x ^ v.y ^ v.z ^ v.w;
        }
      }
    }
  }
  if (acc == 0x9E3779B9u) out[blockIdx.x] = acc;
  if (threadIdx.x == 0 && acc == 7u) sm[0] = acc;
}
extern "C" int read_pattern(int g, const void* d, long long n, long long L, void* out, int smem,
                            void* stream) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  auto k = g == 1 ? rd<1> : g == 2 ? rd<2> : g == 4 ? rd<4> : g == 8 ? rd<8> : rd<32>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  k<<<sms, 512, smem, (cudaStream_t)stream>>>((const uint8_t*)d, n, L, (uint32_t*)out);
  return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    src = os.path.join(_cuda.BUILD_DIR, "read_patterns.cu")
    lib = os.path.join(_cuda.BUILD_DIR, "libread_patterns.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(lib)
    dll.read_pattern.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    return dll


def time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main() -> dict:
    dll = build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20261016)
    data = torch.randint(0, 256, (ROWS, L), generator=g, device=dev, dtype=torch.uint8)
    out = torch.zeros(1024, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    res: dict = {}
    for _ in range(2):
        for name, lanes in zip(PATTERNS, (1, 2, 4, 8, 32)):
            def call(lanes=lanes):
                rc = dll.read_pattern(lanes, data.data_ptr(), ROWS, L, out.data_ptr(), SMEM,
                                      stream)
                if rc:
                    raise RuntimeError(f"read_pattern {name}: CUDA error {rc}")
            res.setdefault(name + "_ms", []).append(time_ms(call))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    res.update(card=card, shape=[ROWS, L],
               bound_ms=ROWS * L / 3.35e12 * 1e3)
    return res


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
