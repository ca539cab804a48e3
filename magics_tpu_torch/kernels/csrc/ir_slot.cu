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
//                             interrobot_rank1_messages computes it,
//                             and the sender exchange's select of that
//                             table with the old outbox.
//
// Layout. It reads the state's own layout, no plane transposes (those exist
// for the TPU's lanes): ir_int_seeded [R, K, V1] bool, ir_v2f_ext_pos
// [R, K, V1, 2], rows 1..V-1 of snap_mu / snap_eta [R, V, 4] and snap_lam
// [R, V, 4, 4], safety [R], the global ids [R], the old outbox [R, K, V1,
// 4], the send gates [R] and the live-slot mask [R, K]; it writes the new
// outbox [R, K, V1, 4].
//
// The outbox select. Given the old outbox [R, K, V1, 4], the send gates [R]
// and the live-slot mask [R, K], it writes the whole new outbox: a factor's
// message where its robot's gate and its slot's mask hold, the old entry
// elsewhere (the sender exchange's `where(gate & mask, table, old)`, a
// select, so bit for bit). A factor it does not take copies its old 16
// bytes and joins no skip test: its seeded flag, peer and own position are
// not read. At the swarm's
// shapes (R=16384, K=24, V1=20) the select reads the old entry of each
// untaken factor and a mask byte a slot; the plain select it replaces read
// the table and the old outbox whole and wrote the new one, 377 MB.
//
// Threads (redesigned for this card). One thread per factor (r, k, i):
// thread t = (r K + k) V1 + i of the table (655,360 at the bench shapes),
// each writing its 16-byte message at out + 16 t, so a warp's stores and its
// seeded / p_ext loads fall on consecutive addresses. A block covers part of
// one robot's K V1 factors (blockIdx.x is the robot; at the bench shapes two
// blocks of 320 threads a robot). Each thread first reads its slot's seeded
// flag, the peer's position and its own snapshot position, and decides
// whether the factor can give a message at all: an unseeded slot (empty
// cavity, so M = alpha g g^T has rank 1 and det = 0) or a pair at or beyond
// the safety distance gives an empty one whatever the inverse says, so it
// writes zeros and stops. A block with no live factor stops there (on the
// bench ring most do: 7,712 of 655,360 messages are live after 100 ticks).
// Otherwise the factors of one chain position share their cavity (the
// snapshot of variable i+1), as the Pallas kernel reads one snapshot block
// for every k: the block reads the robot's snapshot rows once into shared
// memory (coalesced 16-byte words, issued with the skip test's loads), and
// its first V1 threads tabulate them with what of the inverse does not
// depend on k. The measurement g = (gx, gy, 0, 0) only touches rows and columns 0-1
// of M = alpha g g^T + cavity, so rows 2-3 of the row-scaled matrix, and
// with them the six 2x2 minors of those rows, are the cavity's own; they
// are computed once per (r, i) with the same operations the per-factor
// inverse would use, so every factor gets the same bits. Only columns 0-1
// of M^-1 are formed: M^-1 g needs no others (g's last two entries are 0;
// the plain version would also empty a message whose columns 2-3 overflow,
// which needs a cavity row below ~1e-30, and a seeded cavity's velocity
// rows carry the dynamics' precision). Shared memory, not L1, holds the
// cavities: a warp's threads span 20 chain positions, so through L1 each
// cavity load would touch ~10 cache lines a warp instruction against one
// conflict-free wavefront from the component-major table here, and the
// block shares the k-independent minors too. An L1 variant was not
// measured.
//
// What bounds it on the H100. Per factor it writes 16 bytes and reads its
// seeded flag, and a seeded one also the peer's position (8 bytes); per
// chain position the own position where a slot is seeded and the cavity
// (80 bytes) where a factor is live. At the bench shapes (R=1024, K=32,
// V1=20, float32) the writes alone are 10.5 MB, 3.1 us at 3.35 TB/s, and
// every input in full 18.5 MB, 5.5 us; chip_smoke.py counts the bytes at its
// run's inputs. The arithmetic of a live factor is a 4x4 determinant, two
// columns of the adjugate, 13 divisions and a square root, some 250
// operations: 0.16 GOP per launch if every factor were live (2.4 us at
// 67 TFLOP/s of float32), far less on the main path. Bytes bound it. The
// earlier design (one thread per (r, i) looping over the K slots, 20,480
// threads) took 86 us on an H100 (torch.profiler).
//
// Maths and rounding. The guards are knife edges (|det| > 1e-6, sane,
// negligible), so the float order is that of the plain version: the tiny
// offset 1e-6 * (((gid * (K*V1) + k * V1) + i) + 1), as tick.py and the
// Pallas kernel compute it (in float32 at R=1024 the offset reaches ~0.65,
// so its last bit decides ties); the constants alpha, 4 alpha and
// rtol alpha rounded from double to float as PyTorch rounds a Python
// scalar; the row-scaled cofactor inverse of core/linalg.py:inv4_rowscaled
// term for term (inv4.cuh); and --fmad=false (kernels/build.py), so that no
// product is fused into a sum. Of the dot products, M^-1 g and q have two
// nonzero terms (g's last two entries are 0), and w's four terms sum left to
// right here and in the plain version, which spells that order out: summed
// by a PyTorch reduction, w's cancellation on ill-conditioned cavities put
// the two versions 5.07e-5 of a message's scale apart on an H100. The
// divisions and square root round correctly in both, so the two agree bit
// for bit (measured on an H100); chip_smoke.py states the tolerance it
// allows and counts the entries whose zero pattern flips.
// An entry that fails a guard is a select of 0, not a product with the
// mask, and a zero determinant divides by 1 instead of 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 512;

// The per-(robot, chain position) cavity table in shared memory, component-
// major [kCav][V1]: eta, rows 0-1 of the precision, and the six 2x2 minors of
// rows 2-3 of the row-scaled precision.
enum Cav { C_ETA, C_LAM01 = C_ETA + 4, C_MINOR = C_LAM01 + 8, kCav = C_MINOR + 6 };

struct IrArgs {
  const unsigned char* seeded;  // [R, K, V1] bool
  const float* p_ext;           // [R, K, V1, 2]
  const float* snap_mu;         // [R, V, 4]
  const float* snap_eta;        // [R, V, 4]
  const float* snap_lam;        // [R, V, 4, 4]
  const float* safety;          // [R]
  const float* gids;            // [R]
  const float* old;             // [R, K, V1, 4]
  const unsigned char* gate;    // [R] bool
  const unsigned char* nbr_mask;  // [R, K] bool
  float* out;                   // [R, K, V1, 4]
  int R, K, V;
  float alpha, four_alpha, rtol_alpha;
};

// Row 2 or 3 of the cavity precision scaled by its largest entry, as
// inv4_rowscaled scales a row of M (those rows of M are the cavity's).
__device__ __forceinline__ void scaled_row(const float* lam, float a[4]) {
  const float rm = fmaxf(fmaxf(fabsf(lam[0]), fabsf(lam[1])), fmaxf(fabsf(lam[2]), fabsf(lam[3])));
  const float d = rm > 0.f ? 1.f / rm : 1.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = lam[j] * d;
}

// Piece j of robot r's snapshot rows 1..V1 as 16-byte words: j < V1 is eta
// of variable j+1, then the four rows of each variable's precision.
__device__ __forceinline__ float4 cavity_piece(const IrArgs& A, int r, int V1, int j) {
  const size_t var0 = (size_t)r * A.V + 1;
  return j < V1 ? __ldg(reinterpret_cast<const float4*>(A.snap_eta) + var0 + j)
                : __ldg(reinterpret_cast<const float4*>(A.snap_lam) + 4 * var0 + (j - V1));
}

__global__ void __launch_bounds__(kMaxThreads) interrobot_slot_kernel(IrArgs A) {
  // the robot's snapshot rows as read, then the cavity table [kCav][V1]
  extern __shared__ float4 raw[];
  const int V1 = A.V - 1, KV1 = A.K * V1, n_raw = 5 * V1;
  float* cav = reinterpret_cast<float*>(raw + n_raw);
  const int r = blockIdx.x;
  const int local = blockIdx.y * blockDim.x + threadIdx.x;
  const bool in = local < KV1;
  const int k = local / V1, i = local - k * V1;
  const size_t e = (size_t)r * KV1 + local;

  // Whether the factor is taken (its robot's gate and its slot hold) and
  // what an untaken one writes: its old entry.
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool take = in && __ldg(A.gate + r) != 0 && __ldg(A.nbr_mask + (size_t)r * A.K + k) != 0;
  const float4 keep = in && !take ? __ldg(reinterpret_cast<const float4*>(A.old) + e) : zero4;

  // The skip test first: an unseeded slot (empty cavity: M = alpha g g^T
  // has rank 1, so det = 0) or a pair at or beyond the safety distance gives
  // an empty message whatever the inverse says. Its loads and the block's
  // first snapshot words are issued together, before any waits for another.
  const float2 zero2 = make_float2(0.f, 0.f);
  const bool seeded = take && __ldg(A.seeded + e) != 0;
  const float2 p = take ? __ldg(reinterpret_cast<const float2*>(A.p_ext) + e) : zero2;
  const float2 own = take ? __ldg(reinterpret_cast<const float2*>(A.snap_mu) + 2 * ((size_t)r * A.V + i + 1))
                          : zero2;
  const float4 first = threadIdx.x < n_raw ? cavity_piece(A, r, V1, threadIdx.x)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
  const float2 mu = seeded ? own : zero2;
  const float safety = __ldg(A.safety + r);
  const float dx = mu.x - p.x;
  const float dy = mu.y - p.y;
  const bool skipped = dx * dx + dy * dy >= safety * safety;
  const bool work = seeded && !skipped;
  float4* out = reinterpret_cast<float4*>(A.out) + e;
  if (!__syncthreads_or(work)) {   // no live factor in the block
    if (in) *out = keep;
    return;
  }

  // the robot's cavities, once per block: the snapshot rows (coalesced
  // 16-byte words), then per chain position the table's entries
  if (threadIdx.x < n_raw) raw[threadIdx.x] = first;
  for (int j = threadIdx.x + blockDim.x; j < n_raw; j += blockDim.x) raw[j] = cavity_piece(A, r, V1, j);
  __syncthreads();
  for (int c = threadIdx.x; c < V1; c += blockDim.x) {
    const float4 eta = raw[c];
    const float4* rows = raw + V1 + 4 * c;
    const float lam0[4] = {rows[0].x, rows[0].y, rows[0].z, rows[0].w};
    const float lam1[4] = {rows[1].x, rows[1].y, rows[1].z, rows[1].w};
    const float lam2[4] = {rows[2].x, rows[2].y, rows[2].z, rows[2].w};
    const float lam3[4] = {rows[3].x, rows[3].y, rows[3].z, rows[3].w};
    cav[(C_ETA + 0) * V1 + c] = eta.x;
    cav[(C_ETA + 1) * V1 + c] = eta.y;
    cav[(C_ETA + 2) * V1 + c] = eta.z;
    cav[(C_ETA + 3) * V1 + c] = eta.w;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      cav[(C_LAM01 + b) * V1 + c] = lam0[b];
      cav[(C_LAM01 + 4 + b) * V1 + c] = lam1[b];
    }
    float a2[4], a3[4];
    scaled_row(lam2, a2);
    scaled_row(lam3, a3);
    const float minors[6] = {
        a2[0] * a3[1] - a2[1] * a3[0], a2[0] * a3[2] - a2[2] * a3[0],
        a2[0] * a3[3] - a2[3] * a3[0], a2[1] * a3[2] - a2[2] * a3[1],
        a2[1] * a3[3] - a2[3] * a3[1], a2[2] * a3[3] - a2[3] * a3[2]};
#pragma unroll
    for (int m = 0; m < 6; ++m) cav[(C_MINOR + m) * V1 + c] = minors[m];
  }
  __syncthreads();
  if (!work) {
    if (in) *out = keep;
    return;
  }
  auto cv = [&](int f) { return cav[f * V1 + i]; };   // the (seeded) cavity

  // tiny offset, h0 and g (factors._interrobot_measurement)
  const float gid_base = __ldg(A.gids + r) * static_cast<float>(KV1);
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

  // M = alpha g g^T + cavity (factors.interrobot_rank1_messages): rows 0-1
  // here, rows 2-3 the cavity's; the row-scaled cofactor inverse
  // (inv4_rowscaled), columns 0-1 only
  const float alpha = A.alpha;
  const float g4[4] = {gx, gy, 0.f, 0.f};
  float a0[4], a1[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    a0[b] = alpha * gx * g4[b] + cv(C_LAM01 + b);
    a1[b] = alpha * gy * g4[b] + cv(C_LAM01 + 4 + b);
  }
  float d[2];
  {
    const float rm0 = fmaxf(fmaxf(fabsf(a0[0]), fabsf(a0[1])), fmaxf(fabsf(a0[2]), fabsf(a0[3])));
    const float rm1 = fmaxf(fmaxf(fabsf(a1[0]), fabsf(a1[1])), fmaxf(fabsf(a1[2]), fabsf(a1[3])));
    d[0] = rm0 > 0.f ? 1.f / rm0 : 1.f;
    d[1] = rm1 > 0.f ? 1.f / rm1 : 1.f;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    a0[b] *= d[0];
    a1[b] *= d[1];
  }
  const float d01 = cv(C_MINOR), d02 = cv(C_MINOR + 1), d03 = cv(C_MINOR + 2);
  const float d12 = cv(C_MINOR + 3), d13 = cv(C_MINOR + 4), d23 = cv(C_MINOR + 5);
  const float c01 = a0[0] * a1[1] - a0[1] * a1[0];
  const float c02 = a0[0] * a1[2] - a0[2] * a1[0];
  const float c03 = a0[0] * a1[3] - a0[3] * a1[0];
  const float c12 = a0[1] * a1[2] - a0[2] * a1[1];
  const float c13 = a0[1] * a1[3] - a0[3] * a1[1];
  const float c23 = a0[2] * a1[3] - a0[3] * a1[2];
  const float det = c01 * d23 - c02 * d13 + c03 * d12 + c12 * d03 - c13 * d02 + c23 * d01;
  const float adj[4][2] = {
      {a1[1] * d23 - a1[2] * d13 + a1[3] * d12, -a0[1] * d23 + a0[2] * d13 - a0[3] * d12},
      {-a1[0] * d23 + a1[2] * d03 - a1[3] * d02, a0[0] * d23 - a0[2] * d03 + a0[3] * d02},
      {a1[0] * d13 - a1[1] * d03 + a1[3] * d01, -a0[0] * d13 + a0[1] * d03 - a0[3] * d01},
      {-a1[0] * d12 + a1[1] * d02 - a1[2] * d01, a0[0] * d12 - a0[1] * d02 + a0[2] * d01}};
  const float safe_det = det == 0.f ? 1.f : det;

  // q = g^T M^-1 g, w = g^T M^-1 (alpha g (J x0 - h) + cavity eta)
  const float ar = alpha * resid;
  float q = 0.f, w = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float mg = (adj[a][0] / safe_det * d[0]) * gx + (adj[a][1] / safe_det * d[1]) * gy;
    if (a < 2) q += g4[a] * mg;
    w += mg * (ar * g4[a] + cv(C_ETA + a));
  }
  const float s = alpha * (1.f - alpha * q);
  const float tt = alpha * (w - resid);

  const float gmax = fmaxf(fabsf(gx), fabsf(gy));
  const float gmax2 = gmax * gmax;
  const float sg = fabsf(s) * gmax2;
  const bool valid = fabsf(det) > 1e-6f && isfinite(s) && isfinite(tt) &&
                     sg <= A.four_alpha * gmax2 + 1.f && !(sg <= A.rtol_alpha * gmax2);
  *out = valid ? make_float4(gx, gy, tt, s) : zero4;
}

}  // namespace

// C entry point, loaded with ctypes (kernels/ir_slot.py). Pointers are the
// contiguous device buffers listed in IrArgs (snap_eta, snap_lam, old and out
// 16-byte aligned, p_ext and snap_mu 8-byte); alpha = 1/sigma^2, four_alpha = 4 alpha and rtol_alpha =
// rtol alpha, each rounded from double to float. The kernel runs on `stream`
// and is not waited for. Returns cudaGetLastError() after the launch;
// launches nothing for an empty table.
extern "C" int ir_interrobot_slot(const void* seeded, const void* p_ext, const void* snap_mu,
                                  const void* snap_eta, const void* snap_lam,
                                  const void* safety, const void* gids, const void* old,
                                  const void* gate, const void* nbr_mask, void* out, int R,
                                  int K, int V, float alpha, float four_alpha,
                                  float rtol_alpha, void* stream) {
  const int V1 = V - 1, KV1 = K * V1;
  if (R <= 0 || V1 <= 0 || K <= 0) return 0;
  IrArgs a;
  a.seeded = static_cast<const unsigned char*>(seeded);
  a.p_ext = static_cast<const float*>(p_ext);
  a.snap_mu = static_cast<const float*>(snap_mu);
  a.snap_eta = static_cast<const float*>(snap_eta);
  a.snap_lam = static_cast<const float*>(snap_lam);
  a.safety = static_cast<const float*>(safety);
  a.gids = static_cast<const float*>(gids);
  a.old = static_cast<const float*>(old);
  a.gate = static_cast<const unsigned char*>(gate);
  a.nbr_mask = static_cast<const unsigned char*>(nbr_mask);
  a.out = static_cast<float*>(out);
  a.R = R;
  a.K = K;
  a.V = V;
  a.alpha = alpha;
  a.four_alpha = four_alpha;
  a.rtol_alpha = rtol_alpha;
  // a robot's K V1 factors in as few blocks of at most kMaxThreads as cover
  // them, each a whole number of warps
  const int chunks = (KV1 + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((KV1 + chunks - 1) / chunks + 31) / 32 * 32;
  const size_t smem = (sizeof(float4) * 5 + sizeof(float) * kCav) * V1;
  static size_t smem_set = 48 * 1024;   // the attribute, once it exceeds the default
  if (smem > smem_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        interrobot_slot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    smem_set = smem;
  }
  interrobot_slot_kernel<<<dim3(R, chunks), threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
