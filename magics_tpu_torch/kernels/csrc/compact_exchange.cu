// Hand-written Hopper (sm_90a) kernels for one external slot of the
// receiver-computes compact exchange ("receiver_compact").
//
// What they replace
//   compact_table_kernel   <- no TPU kernel. magics_tpu/graph/factors.py:397
//                             compact_snap_tables is plain XLA there. The port
//                             ran it as plain PyTorch: the row-scaled cofactor
//                             inverse of every robot's snapshot precision, its
//                             checks, C^-1 eta and the table's concatenation,
//                             some 168 device operations a slot. The kernel
//                             also forms the send gates and adds them to the
//                             factor-pass counter (5 more operations).
//   compact_message_kernel <- no TPU kernel. magics_tpu/graph/factors.py:434
//                             interrobot_rank1_messages_compact (and its hot
//                             twin, :505) is plain XLA there. The port ran the
//                             index clip, a row gather (K4) of the peers'
//                             tables into an [R, K, V-1, 8] tensor, the tiny
//                             offsets, the safety distances, the
//                             Sherman-Morrison message with its guards, and
//                             the inbox `where`: some 91 device operations a
//                             slot.
//
// What they compute (magics_tpu_torch/kernels/compact_exchange.py holds the
// plain version, operation for operation):
//   tables [R, V1, 8] = (snap position 2, mc 2, S 3, valid 1) of variables
//   1..V-1, with C the snapshot precision, S the position block of C^-1
//   (xx, xy, yy) and mc = (C^-1 eta)[:2], zero where |det| <= 1e-6 or C^-1
//   is not finite; gate [R] = active & antenna & (mission_active |
//   completed) and count_out = count_in + gate. Then for every (robot r,
//   neighbour slot k, chain position i), with j = nbr_idx[r, k] clipped to
//   the robots: where gate[r], nbr_mask, gate_all[j] and nbr_has_back all
//   hold, the compact rank-1 message (gx, gy, t, s) of the factor from j's
//   table row i, r's mirrors (seeded flag, the position of r's variable as
//   j holds it), j's safety distance and the slot's tiny offset; elsewhere
//   the old inbox row. The output is a fresh inbox: the old one may belong
//   to the caller's state.
//
// Rounding. Built with --fmad=false (kernels/build.py): no product is fused
// into a sum, as none is in the plain version's separate PyTorch kernels.
// Every operation follows the plain version's order and its constants are
// rounded as PyTorch rounds a Python scalar against a float32 tensor: the
// row-scaled cofactor inverse of core/linalg.py:inv4_rowscaled term for
// term (inv4.cuh); alpha / den is `den.reciprocal() * alpha`, as Python
// evaluates a scalar over a tensor; 1e-6, alpha and rtol alpha are doubles
// rounded to float. The sums follow PyTorch's CUDA reduction over a
// contiguous last dimension of n = 2 or 4 terms (ATen's Reduce.cuh: one
// thread a term, each starting from +0.0, then a warp shuffle tree with the
// offset halving, n/2 first): a + b as (0 + a) + (0 + b), and the four
// terms of C^-1 eta as ((0 + a) + (0 + c)) + ((0 + b) + (0 + d)). The
// maxima (amax) take fmaxf, which differs from PyTorch only on a NaN: a
// precision row holding one leaves the inverse NaN in both versions, so the
// table entry invalid and zero, and a NaN g makes s NaN, so the message
// invalid. Divisions and square roots round correctly in both. So
// the kernels give the plain version's bits (checked on an H100 by
// tests/test_torch_kernels_cuda.py and chip_smoke.py).
//
// What bounds them on the H100. Per robot and variable the table kernel
// reads the snapshot's 24 floats (it needs 22) and writes 8; per robot 4
// gate bytes and the counter. Per (robot, slot) the message kernel reads
// the neighbour tables (10 bytes) and per (robot, slot, position) writes
// the 16-byte inbox row, reading the old one where nothing is delivered and
// else the seeded flag, the mirrored position (8 bytes) and the peer's
// 32-byte table row (the tables, 0.66 MB at the bench shape, stay in L2).
// At the bench shape (R=1024, K=32, V1=20) that is about 2.3 MB and 12-17
// MB: 4-6 us at 3.35 TB/s, memory-bound (the arithmetic, some 250
// operations a table entry and 70 a message, is under 1 us at 67 TFLOP/s).
//
// What the design does about it. One thread a table entry, threads of a warp
// on consecutive (robot, variable) entries, so the snapshot's 16-byte words
// and the table's are read and written in whole sectors; the thread of
// variable 1 also writes its robot's gate and counter. One thread a message,
// chain position fastest: a warp's inbox rows, seeded flags and mirrored
// positions are consecutive, its V1 threads of one (r, k) read the same
// neighbour-table words (one broadcast load each), and a peer's table row i
// is the i-th 32-byte word of its table, so the V1 threads of one slot read
// one run of 32 V1 bytes. A thread with nothing delivered only copies its
// old row. Grids follow R V1 and R K V1; no shared memory, no atomics, no
// barrier, so the order of blocks changes no bit.

#include <cuda_runtime.h>
#include <math.h>

#include "inv4.cuh"

namespace {

constexpr int kTableThreads = 64;     // a table block: small, so that R=1024 fills the SMs
constexpr int kMessageThreads = 256;

// A PyTorch CUDA sum over a contiguous last dimension of two terms.
__device__ __forceinline__ float sum2(float a, float b) { return (0.f + a) + (0.f + b); }

// ... and of four: the warp tree pairs term 0 with 2 and 1 with 3 first.
__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return ((0.f + a) + (0.f + c)) + ((0.f + b) + (0.f + d));
}

__global__ void __launch_bounds__(kTableThreads) compact_table_kernel(
    const float2* __restrict__ snap_mu, const float4* __restrict__ snap_eta,
    const float4* __restrict__ snap_lam, const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ antenna, const unsigned char* __restrict__ mission,
    const unsigned char* __restrict__ completed, const int* __restrict__ count_in,
    float4* __restrict__ tables, unsigned char* __restrict__ gate, int* __restrict__ count_out,
    long long R, int V) {
  const int V1 = V - 1;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;   // (r, i)
  if (e >= R * V1) return;
  const long long r = e / V1;
  const int i = (int)(e - r * V1);
  const long long var = r * V + i + 1;

  if (i == 0) {
    const bool g = active[r] && antenna[r] && (mission[r] || completed[r]);
    gate[r] = g;
    count_out[r] = count_in[r] + (g ? 1 : 0);
  }

  const float2 pos = __ldg(snap_mu + 2 * var);
  const float4 eta = __ldg(snap_eta + var);
  float m[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float4 row = __ldg(snap_lam + 4 * var + a);
    m[a][0] = row.x;
    m[a][1] = row.y;
    m[a][2] = row.z;
    m[a][3] = row.w;
  }
  float c[4][4];
  const float det = inv4_rowscaled(m, c);
  bool finite = true;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) finite = finite && isfinite(c[a][b]);
  const bool valid = fabsf(det) > static_cast<float>(1e-6) && finite;
  const float mcx = sum4(c[0][0] * eta.x, c[0][1] * eta.y, c[0][2] * eta.z, c[0][3] * eta.w);
  const float mcy = sum4(c[1][0] * eta.x, c[1][1] * eta.y, c[1][2] * eta.z, c[1][3] * eta.w);
  tables[2 * e] = valid ? make_float4(pos.x, pos.y, mcx, mcy) : make_float4(pos.x, pos.y, 0.f, 0.f);
  tables[2 * e + 1] = valid ? make_float4(c[0][0], c[0][1], c[1][1], 1.f)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
}

struct MessageArgs {
  const float4* tables;            // [R_all, V1, 8] as 2 float4 an entry
  const unsigned char* gate;       // [R]
  const unsigned char* gate_all;   // [R_all]
  const float* radius_all;         // [R_all]
  const int* nbr_idx;              // [R, K]
  const int* nbr_back;             // [R, K]
  const unsigned char* nbr_mask;   // [R, K]
  const unsigned char* has_back;   // [R, K]
  const unsigned char* seeded;     // [R, K, V1]
  const float2* p_ext;             // [R, K, V1]
  const float4* inbox;             // [R, K, V1]
  float4* out;                     // [R, K, V1]
  long long R, R_all;
  int K, V1;
  float safety_mult, alpha, rtol_alpha;
};

__global__ void __launch_bounds__(kMessageThreads) compact_message_kernel(MessageArgs A) {
  const int K = A.K, V1 = A.V1;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;   // (r, k, i)
  if (e >= A.R * K * V1) return;
  const long long rk = e / V1;
  const int i = (int)(e - rk * V1);
  const long long r = rk / K;
  const int k = (int)(rk - r * K);

  const int idx = __ldg(A.nbr_idx + rk);
  const long long j = idx < 0 ? 0 : (idx >= A.R_all ? A.R_all - 1 : idx);
  const bool deliver = A.gate[r] && __ldg(A.nbr_mask + rk) && A.gate_all[j] &&
                       __ldg(A.has_back + rk);
  if (!deliver) {
    A.out[e] = __ldg(A.inbox + e);
    return;
  }

  const float4 t0 = __ldg(A.tables + 2 * (j * V1 + i));
  const float4 t1 = __ldg(A.tables + 2 * (j * V1 + i) + 1);
  const bool cav_valid = t1.w > 0.5f && __ldg(A.seeded + e) != 0;
  const float2 p = __ldg(A.p_ext + e);
  const float safety = A.safety_mult * __ldg(A.radius_all + j);

  // the tiny offset (tick.py): 1e-6 (((j (K V1) + back V1) + i) + 1)
  const float back = static_cast<float>(__ldg(A.nbr_back + rk));
  const float tiny = static_cast<float>(1e-6) *
                     (((static_cast<float>(j) * static_cast<float>(K * V1) +
                        back * static_cast<float>(V1)) + static_cast<float>(i)) + 1.f);

  // the measurement (factors._interrobot_measurement)
  const float dx = t0.x - p.x, dy = t0.y - p.y;
  const bool skipped = sum2(dx * dx, dy * dy) >= safety * safety;
  const float ox = dx + tiny, oy = dy + tiny;
  const float dist = sqrtf(sum2(ox * ox, oy * oy));
  const bool within = dist <= safety;
  const float h0 = within ? 1.f - dist / safety : 0.f;
  const float scale = safety * (dist > 0.f ? dist : 1.f);
  const float gx = within ? -ox / scale : 0.f;
  const float gy = within ? -oy / scale : 0.f;

  // Sherman-Morrison on the peer's covariance block
  // (factors.interrobot_rank1_messages_compact)
  const float alpha = A.alpha;
  const float resid = sum2(gx * dx, gy * dy) - h0;
  const float u = ((gx * gx) * t1.x + ((2.f * gx) * gy) * t1.y) + (gy * gy) * t1.z;
  const float den = alpha * u + 1.f;
  const float s = (1.f / den) * alpha;
  const float t = (alpha * (sum2(gx * t0.z, gy * t0.w) - resid)) / den;

  const float gmax = fmaxf(fabsf(gx), fabsf(gy));
  const float gmax2 = gmax * gmax;
  const bool negligible = fabsf(s) * gmax2 <= A.rtol_alpha * gmax2;
  const bool valid = cav_valid && isfinite(s) && isfinite(t) && !negligible && !skipped;
  const float ok = valid ? 1.f : 0.f;
  A.out[e] = make_float4(gx * ok, gy * ok, t * ok, s * ok);
}

}  // namespace

// C entry points, loaded with ctypes (kernels/compact_exchange.py). Every
// pointer is a contiguous device buffer (float4 arrays 16-byte aligned,
// float2 arrays 8-byte); bools are one byte. The kernels run on `stream` and
// are not waited for. Each returns cudaGetLastError() after its launch and
// launches nothing for an empty output (the wrapper then makes none).

// snap_* [R, V, ...] float32, active / antenna / mission / completed [R]
// bool, count_in [R] int32 -> tables [R, V-1, 8] float32, gate [R] bool,
// count_out [R] int32.
extern "C" int compact_tables(const void* snap_mu, const void* snap_eta, const void* snap_lam,
                              const void* active, const void* antenna, const void* mission,
                              const void* completed, const void* count_in, void* tables,
                              void* gate, void* count_out, long long R, int V, void* stream) {
  const long long n = R * (V - 1);
  if (R <= 0 || V <= 1) return 0;
  const long long blocks = (n + kTableThreads - 1) / kTableThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  compact_table_kernel<<<static_cast<unsigned>(blocks), kTableThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(snap_mu), static_cast<const float4*>(snap_eta),
      static_cast<const float4*>(snap_lam), static_cast<const unsigned char*>(active),
      static_cast<const unsigned char*>(antenna), static_cast<const unsigned char*>(mission),
      static_cast<const unsigned char*>(completed), static_cast<const int*>(count_in),
      static_cast<float4*>(tables), static_cast<unsigned char*>(gate),
      static_cast<int*>(count_out), R, V);
  return static_cast<int>(cudaGetLastError());
}

// tables [R_all, V1, 8] float32, gate [R] and gate_all [R_all] bool,
// radius_all [R_all] float32, nbr_idx / nbr_back [R, K] int32, nbr_mask /
// nbr_has_back [R, K] bool, seeded [R, K, V1] bool, p_ext [R, K, V1, 2] and
// inbox [R, K, V1, 4] float32 -> out [R, K, V1, 4]. safety_mult, alpha =
// 1/sigma^2 and rtol_alpha = rtol alpha, each rounded from double to float.
extern "C" int compact_messages(const void* tables, const void* gate, const void* gate_all,
                                const void* radius_all, const void* nbr_idx,
                                const void* nbr_back, const void* nbr_mask,
                                const void* has_back, const void* seeded, const void* p_ext,
                                const void* inbox, void* out, long long R, long long R_all,
                                int K, int V1, float safety_mult, float alpha, float rtol_alpha,
                                void* stream) {
  const long long n = R * K * V1;
  if (R <= 0 || K <= 0 || V1 <= 0) return 0;
  if (R_all <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kMessageThreads - 1) / kMessageThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  MessageArgs a;
  a.tables = static_cast<const float4*>(tables);
  a.gate = static_cast<const unsigned char*>(gate);
  a.gate_all = static_cast<const unsigned char*>(gate_all);
  a.radius_all = static_cast<const float*>(radius_all);
  a.nbr_idx = static_cast<const int*>(nbr_idx);
  a.nbr_back = static_cast<const int*>(nbr_back);
  a.nbr_mask = static_cast<const unsigned char*>(nbr_mask);
  a.has_back = static_cast<const unsigned char*>(has_back);
  a.seeded = static_cast<const unsigned char*>(seeded);
  a.p_ext = static_cast<const float2*>(p_ext);
  a.inbox = static_cast<const float4*>(inbox);
  a.out = static_cast<float4*>(out);
  a.R = R;
  a.R_all = R_all;
  a.K = K;
  a.V1 = V1;
  a.safety_mult = safety_mult;
  a.alpha = alpha;
  a.rtol_alpha = rtol_alpha;
  compact_message_kernel<<<static_cast<unsigned>(blocks), kMessageThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
