// Hand-written Hopper (sm_90a) external sums: the compact rank-1 inbox
// summed over the neighbour slots and written straight into the hot planes
// the slot kernels read.
//
// What it replaces
//   ext_sum_kernel  <- no TPU kernel. magics_tpu/kernels/hot.py:_ext_sum_hot
//                      is plain XLA there (rank1_sum, a transpose, a pad),
//                      which XLA fuses. The port ran the same plain
//                      operations through PyTorch: eight strided multiplies
//                      over the inbox, five sums over k, the dense 4x4
//                      precision stacked from zeros, two pads and two
//                      transposes, some 25 device operations a call, 11
//                      calls a tick (once before the schedule, once after
//                      each external slot's exchange).
//
// What it computes. For the inbox [R, K, V1, 4] of (gx, gy, t, s) words
// (robot, neighbour slot, chain position i = variable i + 1), the planes
// eta [4, V, R] and lam [4, 4, V, R], V = V1 + 1, robots last:
//   eta[0, i+1, r] = sum_k gx t            eta[1, i+1, r] = sum_k gy t
//   lam[0, 0, i+1, r] = sum_k (s gx) gx    lam[0, 1, i+1, r] = lam[1, 0, i+1, r]
//                                                            = sum_k (s gx) gy
//   lam[1, 1, i+1, r] = sum_k (s gy) gy
// and every other entry 0, variable 0's planes included: exactly what
// factors.rank1_sum, pad_vars and hot give (kernels/ext_sum.py).
//
// Rounding. Each product is rounded as the plain version rounds it ((s gx)
// gx, never an FMA: the build's --fmad=false), and each sum is taken in the
// order PyTorch's CUDA reduction takes the plain version's sum over k (ATen's
// Reduce.cuh, thread_reduce_impl, vt0 = 4): four partial sums from +0.0, the
// j-th over k = j, j + 4, j + 8, ... in ascending order, then combined as
// ((p0 + p1) + p2) + p3. PyTorch keeps one thread per output, and so that
// order, while a thread's share of a sum stays under 64 terms (K < 64 at
// these shapes: no split across warps); there the kernel gives the plain
// version's bits (checked on an H100 against PyTorch 2.11.0+cu128; another
// PyTorch may reduce in another order, and the card test that pins the bits
// then fails for that reason), and a run through the kernel follows the
// plain sums' trajectory. A single running sum over k rounds differently, and the Circle
// Experiment's symmetric crossing is sensitive to it: on an H100, with one
// running sum, its 30-robot rows ran past 200 ticks for 12 of 20 seeds and
// left robots unfinished for 2 (the plain sums: 3 and 0). The order is fixed by K
// alone, whatever R, the tile or the grid: a graph replay, an eager tick and
// a shard of the swarm give the same bits. No atomics.
//
// What bounds it on the H100. It reads the inbox once and writes both planes
// once: 16 R K V1 + 80 R V bytes and 12 R K V1 operations. At the swarm's
// shape (R=16384, K=24, V=21) that is 125.8 + 27.5 = 153.35 MB, 45.8 us at
// 3.35 TB/s (0.07 us of float32 operations): memory-bound. At the Circle
// Experiment's (R=50, K=49, V=21) it is 0.87 MB, 0.26 us, so the launch and
// the latency of 49 dependent loads a thread set its time.
//
// What the design does about it. A block owns a tile of TR robots times TV
// chain positions, one thread a (robot, position): the threads of a warp sit
// on neighbouring 16-byte words, so one robot's positions of slot k are one
// run of 16 TV bytes, and every 32-byte sector a warp loads is used whole.
// Each thread loads its K words in batches of kUnroll, all of a batch in
// flight before the first add. The tile's five sums go to shared memory; the
// block then writes every plane row of its tile, component by component (the
// loop unrolled, so no thread branches on which sum a plane holds), the zero
// planes included, TR robots contiguous: both the reads and the writes are
// coalesced, and the 14 zero planes of 20 cost only their stores. TV is
// min(V1, 32) and TR 16, so the grid follows R and V1: 1,024 blocks at the
// swarm, 4 at the Circle, where the 49 dependent loads a thread, not the
// block count, set the time.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTV = 32;    // chain positions a tile
constexpr int TR = 16;        // robots a tile
constexpr int kUnroll = 8;    // loads in flight a thread
constexpr int kParts = 4;     // partial sums a sum (PyTorch's vt0)
constexpr int kComps = 20;    // the 4 eta and 16 lam components of a variable
constexpr int kSums = 5;      // sum_k gx t, gy t, (s gx) gx, (s gx) gy, (s gy) gy

// The sum a component holds (-1: a zero plane). eta c -> c; lam (a, b) -> 4 + 4 a + b.
__host__ __device__ constexpr int sum_of(int comp) {
  return comp == 0 ? 0 : comp == 1 ? 1 : comp == 4 ? 2 : (comp == 5 || comp == 8) ? 3
       : comp == 9 ? 4 : -1;
}

// Block (x, y): robots [x TR, (x + 1) TR), positions [y TV, (y + 1) TV),
// TR TV threads. Shared memory holds the tile's sums at [q][robot][position],
// a robot's row TV | 1 floats long (odd: the transposed reads hit 32 banks).
__global__ void __launch_bounds__(TR * kMaxTV) ext_sum_kernel(
    const float4* __restrict__ inbox, float* __restrict__ eta, float* __restrict__ lam,
    long long R, int K, int V1, int TV) {
  __shared__ float sums[kSums * TR * (kMaxTV + 1)];
  const int SV = TV | 1;
  const long long r0 = (long long)blockIdx.x * TR;
  const int i0 = blockIdx.y * TV;
  const int tv = min(TV, V1 - i0);   // positions of this tile

  // 1. the sums over k of each (robot, position) of the tile
  const int t = threadIdx.x, rl = t / TV, il = t - rl * TV;
  if (il < tv && r0 + rl < R) {
    const float4* p = inbox + ((r0 + rl) * K) * V1 + i0 + il;
    float ex[kParts], ey[kParts], lxx[kParts], lxy[kParts], lyy[kParts];
#pragma unroll
    for (int j = 0; j < kParts; ++j) ex[j] = ey[j] = lxx[j] = lxy[j] = lyy[j] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kUnroll) {
      float4 w[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (k0 + j < K) w[j] = __ldg(p + (long long)(k0 + j) * V1);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (k0 + j < K) {   // k0 is a multiple of kParts: term k goes to part k % 4
          const int a = j % kParts;
          const float gx = w[j].x, gy = w[j].y, tt = w[j].z, s = w[j].w;
          ex[a] = ex[a] + gx * tt;
          ey[a] = ey[a] + gy * tt;
          const float sx = s * gx, sy = s * gy;
          lxx[a] = lxx[a] + sx * gx;
          lxy[a] = lxy[a] + sx * gy;
          lyy[a] = lyy[a] + sy * gy;
        }
      }
    }
#pragma unroll
    for (int j = 1; j < kParts; ++j) {
      ex[0] = ex[0] + ex[j];
      ey[0] = ey[0] + ey[j];
      lxx[0] = lxx[0] + lxx[j];
      lxy[0] = lxy[0] + lxy[j];
      lyy[0] = lyy[0] + lyy[j];
    }
    float* own = sums + rl * SV + il;
    own[0 * TR * SV] = ex[0];
    own[1 * TR * SV] = ey[0];
    own[2 * TR * SV] = lxx[0];
    own[3 * TR * SV] = lxy[0];
    own[4 * TR * SV] = lyy[0];
  }
  __syncthreads();

  // 2. every plane row of the tile, TR robots contiguous: variables
  // [v0, v0 + nv), variable 0 (all zero) with the first position tile
  const int v0 = blockIdx.y == 0 ? 0 : i0 + 1;
  const int nv = blockIdx.y == 0 ? tv + 1 : tv;
  const long long plane = (long long)(V1 + 1) * R;
#pragma unroll
  for (int comp = 0; comp < kComps; ++comp) {
    const int q = sum_of(comp);
    float* dst = comp < 4 ? eta + comp * plane : lam + (comp - 4) * plane;
    for (int f = t; f < nv * TR; f += blockDim.x) {
      const int l = f % TR, v = v0 + f / TR;
      const long long r = r0 + l;
      if (r >= R) continue;
      dst[(long long)v * R + r] =
          (q >= 0 && v > 0) ? sums[(q * TR + l) * SV + (v - 1 - i0)] : 0.0f;
    }
  }
}

}  // namespace

// C entry point, loaded with ctypes (kernels/ext_sum.py). `inbox` is a
// contiguous, 16-byte aligned [R, K, V1, 4] float32 array, `eta` and `lam`
// contiguous [4, V1 + 1, R] and [4, 4, V1 + 1, R] float32 arrays, every entry
// of which is written. The kernel runs on `stream` and is not waited for.
// Returns cudaGetLastError() after the launch; launches nothing where R, K
// or V1 is not positive (the wrapper fills zeros there).
extern "C" int ext_sum_hot(const void* inbox, float* eta, float* lam, long long R, int K,
                           int V1, void* stream) {
  if (R <= 0 || K <= 0 || V1 <= 0) return 0;
  const int TV = V1 < kMaxTV ? V1 : kMaxTV;
  const long long blocks = (R + TR - 1) / TR;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), (V1 + TV - 1) / TV);
  ext_sum_kernel<<<grid, TR * TV, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(inbox), eta, lam, R, K, V1, TV);
  return static_cast<int>(cudaGetLastError());
}
