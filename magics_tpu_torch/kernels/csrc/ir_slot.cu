// Hand-written Hopper (sm_90a) kernel for the sender exchange's inter-robot
// message table.
//
// What it replaces
//   interrobot_slot_kernel <- magics_tpu/kernels/ir_slot.py:interrobot_slot
//                             (Pallas body _ir_kernel): for every factor
//                             (r, k, i) -- robot r, neighbour slot k, chain
//                             position i (variable i+1) -- the compact rank-1
//                             message (gx, gy, t, s) to its external
//                             variable, as magics_tpu_torch/graph/factors.py:
//                             interrobot_rank1_messages computes it.
//
// Layout. It reads the state's own layout, no plane transposes (those exist
// for the TPU's lanes): ir_int_seeded [R, K, V1] bool, ir_v2f_ext_pos
// [R, K, V1, 2], rows 1..V-1 of snap_mu / snap_eta [R, V, 4] and snap_lam
// [R, V, 4, 4], safety [R] and the global ids [R]; it writes [R, K, V1, 4].
//
// Threads. One thread per (r, i), looping over the K slots: the cavity of
// variable i+1 (snapshot mean, eta and the 4x4 precision, 22 floats) is
// loaded once and shared by the K factors of that variable, as the Pallas
// kernel reads one snapshot block for every k. An unseeded slot selects a
// zero cavity. Neighbouring threads take neighbouring i, so a warp's
// loads and its 16-byte stores per k fall on consecutive addresses.
// ptxas (nvcc 12.9, sm_90a): 91 registers, no spills.
//
// What bounds it on the H100. Per factor it reads 9 bytes (seeded, p_ext)
// and writes 16; per variable it reads 88 bytes of cavity. At the bench
// shapes (R=1024, K=32, V1=20, float32) that is 5.9 + 10.5 + 1.8 MB: 5.4 us
// at 3.35 TB/s. The arithmetic is one row-scaled 4x4 inverse and a few dot
// products per factor, some 400 flops: 0.26 GFLOP per launch, 3.9 us at
// 67 TFLOP/s of float32. So bytes and flops bound it alike: about 5 us at
// best. Speed is later work; this kernel
// is the simple, right one: at the bench shapes its 20,480 threads (160
// blocks, about one per SM) each run 32 dependent inverses, and it takes
// 86 us on an H100 (torch.profiler).
//
// Maths and rounding. The guards are knife edges (|det| > 1e-6, sane,
// negligible), so the float order is that of the plain version: the tiny
// offset 1e-6 * (((gid * (K*V1) + k * V1) + i) + 1), as tick.py and the
// Pallas kernel compute it (in float32 at R=1024 the offset reaches ~0.65,
// so its last bit decides ties); the constants alpha, 4 alpha and
// rtol alpha rounded from double to float as PyTorch rounds a Python
// scalar; and --fmad=false (kernels/build.py), so that no product is fused
// into a sum. The 4-term dot products sum left to right, PyTorch's
// reductions may not: kernel and plain version agree to float32 roundoff,
// and chip_smoke.py counts the entries whose zero pattern flips. An entry
// that fails a guard is a select of 0, not a product with the mask: the
// empty cavity with g = 0 makes M = 0, which the shared inverse (inv4.cuh)
// divides by 1 instead of 0.

#include <cuda_runtime.h>
#include <math.h>

#include "inv4.cuh"

namespace {

constexpr int kThreads = 128;

struct IrArgs {
  const unsigned char* seeded;  // [R, K, V1] bool
  const float* p_ext;           // [R, K, V1, 2]
  const float* snap_mu;         // [R, V, 4]
  const float* snap_eta;        // [R, V, 4]
  const float* snap_lam;        // [R, V, 4, 4]
  const float* safety;          // [R]
  const float* gids;            // [R]
  float* out;                   // [R, K, V1, 4]
  int R, K, V;
  float alpha, four_alpha, rtol_alpha;
};

__global__ void __launch_bounds__(kThreads) interrobot_slot_kernel(IrArgs A) {
  const int V1 = A.V - 1;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)A.R * V1) return;
  const int r = static_cast<int>(t / V1);
  const int i = static_cast<int>(t - (long long)r * V1);

  // the cavity of variable i+1, read once for all K slots
  const size_t var = (size_t)r * A.V + i + 1;
  const float mu0 = __ldg(A.snap_mu + 4 * var), mu1 = __ldg(A.snap_mu + 4 * var + 1);
  float eta[4], lam[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    eta[a] = __ldg(A.snap_eta + 4 * var + a);
#pragma unroll
    for (int b = 0; b < 4; ++b) lam[a][b] = __ldg(A.snap_lam + 16 * var + 4 * a + b);
  }
  const float safety = __ldg(A.safety + r);
  const float safety2 = safety * safety;
  const float gid_base = __ldg(A.gids + r) * static_cast<float>(A.K * V1);
  const float alpha = A.alpha;

  for (int k = 0; k < A.K; ++k) {
    const size_t e = ((size_t)r * A.K + k) * V1 + i;
    const bool seeded = __ldg(A.seeded + e) != 0;
    const float px = __ldg(A.p_ext + 2 * e), py = __ldg(A.p_ext + 2 * e + 1);

    // distance, skip, tiny offset, h0 and g (factors._interrobot_measurement)
    const float dx = (seeded ? mu0 : 0.f) - px;
    const float dy = (seeded ? mu1 : 0.f) - py;
    const bool skipped = dx * dx + dy * dy >= safety2;
    const float tiny =
        1e-6f * (((gid_base + static_cast<float>(k) * static_cast<float>(V1)) +
                  static_cast<float>(i)) + 1.f);
    const float ox = dx + tiny, oy = dy + tiny;
    const float dist = sqrtf(ox * ox + oy * oy);
    const bool within = dist <= safety;
    const float h0 = within ? 1.f - dist / safety : 0.f;
    const float scale = safety * (dist > 0.f ? dist : 1.f);
    const float gx = within ? -ox / scale : 0.f;
    const float gy = within ? -oy / scale : 0.f;
    const float resid = (gx * dx + gy * dy) - h0;

    // M = alpha g g^T + cavity and the rank-1 marginal onto the external
    // variable (factors.interrobot_rank1_messages)
    const float g4[4] = {gx, gy, 0.f, 0.f};
    float m[4][4], minv[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) m[a][b] = alpha * g4[a] * g4[b] + (seeded ? lam[a][b] : 0.f);
    const float det = inv4_rowscaled(m, minv);
    const float ar = alpha * resid;
    float q = 0.f, w = 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mg = minv[a][0] * g4[0];
#pragma unroll
      for (int b = 1; b < 4; ++b) mg += minv[a][b] * g4[b];
      q += g4[a] * mg;
      w += mg * (ar * g4[a] + (seeded ? eta[a] : 0.f));
    }
    const float s = alpha * (1.f - alpha * q);
    const float tt = alpha * (w - resid);

    const float gmax = fmaxf(fabsf(gx), fabsf(gy));
    const float gmax2 = gmax * gmax;
    const float sg = fabsf(s) * gmax2;
    const bool valid = fabsf(det) > 1e-6f && isfinite(s) && isfinite(tt) &&
                       sg <= A.four_alpha * gmax2 + 1.f && !(sg <= A.rtol_alpha * gmax2) &&
                       !skipped;
    float* o = A.out + 4 * e;
    o[0] = valid ? gx : 0.f;
    o[1] = valid ? gy : 0.f;
    o[2] = valid ? tt : 0.f;
    o[3] = valid ? s : 0.f;
  }
}

}  // namespace

// C entry point, loaded with ctypes (kernels/ir_slot.py). Pointers are the
// contiguous device buffers listed in IrArgs; alpha = 1/sigma^2, four_alpha
// = 4 alpha and rtol_alpha = rtol alpha, each rounded from double to float.
// The kernel runs on `stream` and is not waited for. Returns
// cudaGetLastError() after the launch; launches nothing for an empty table.
extern "C" int ir_interrobot_slot(const void* seeded, const void* p_ext, const void* snap_mu,
                                  const void* snap_eta, const void* snap_lam,
                                  const void* safety, const void* gids, void* out, int R,
                                  int K, int V, float alpha, float four_alpha,
                                  float rtol_alpha, void* stream) {
  const long long n = (long long)R * (V - 1);
  if (n <= 0 || K <= 0) return 0;
  IrArgs a;
  a.seeded = static_cast<const unsigned char*>(seeded);
  a.p_ext = static_cast<const float*>(p_ext);
  a.snap_mu = static_cast<const float*>(snap_mu);
  a.snap_eta = static_cast<const float*>(snap_eta);
  a.snap_lam = static_cast<const float*>(snap_lam);
  a.safety = static_cast<const float*>(safety);
  a.gids = static_cast<const float*>(gids);
  a.out = static_cast<float*>(out);
  a.R = R;
  a.K = K;
  a.V = V;
  a.alpha = alpha;
  a.four_alpha = four_alpha;
  a.rtol_alpha = rtol_alpha;
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  interrobot_slot_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
