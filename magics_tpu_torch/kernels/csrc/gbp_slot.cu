// Hand-written Hopper (sm_90a) kernels for one GBP slot of the whole swarm.
//
// What they replace
//   internal_slot_kernel  <- magics_tpu/kernels/gbp_slot.py:internal_slot
//                            (Pallas body _slot_kernel): one internal GBP slot,
//                            fused: dynamic / obstacle / tracking factor
//                            messages, then the variable pass (belief update,
//                            snapshot, responses to the internal factors).
//   variable_slot_kernel  <- magics_tpu/kernels/gbp_slot.py:variable_slot
//                            (Pallas body _variable_kernel): the belief update
//                            of an external slot, no responses, no snapshot.
//
// Layout. Both read and write the TPU kernels' "hot layout": every field is a
// contiguous [c..., P, R] plane stack, robots last (magics_tpu_torch
// kernels/gbp_slot.py lists the fields and shapes). Element (c, p, r) lives
// at (c * P + p) * R + r, so threadIdx.x -> robot gives coalesced loads. The
// ragged robot edge is masked here: R need not be a multiple of anything.
//
// What bounds them on the H100. Per robot, at V chain variables and W path
// points (V1 = V-1, V2 = V-2), float32:
//   internal slot reads  3 + 49 V + 89 V1 + 56 V2 + 2 W floats
//                 writes     48 V + 88 V1 + 53 V2     floats
//   variable slot reads  1 + 49 V + 40 V1 + 40 V2     floats, writes 24 V.
// At the bench shape (V=21, W=2, R=1024) that is 15,520 + 15,100 B per robot,
// 31.4 MB per internal-slot launch, and 12.7 MB per variable-slot launch.
// The arithmetic is some 2,000 flops per robot and variable (two 4x4 inverses
// and six 4x4 products per dynamic factor, one inverse and a residual check
// per variable), about 0.04 GFLOP per launch: at 67 TFLOP/s of float32 that
// is under a microsecond, against 9.4 us (internal) and 3.8 us (variable)
// for the bytes at 3.35 TB/s. Both kernels are memory-bound.
//
// What the design does about it. Each value is loaded from device memory
// once and every output written once; all 4x4 algebra stays in registers.
// One block owns a tile of kRobotTile robots times all V chain positions and
// runs the slot in two phases split by __syncthreads(): (1) each (robot,
// position) thread computes the factor messages that sit at that position
// and writes them to the output planes; (2) each (robot, variable) thread
// sums its prior, the <= 2 dynamic messages, the interior obstacle+tracking
// message and the external sum, runs the guarded row-scaled inverse, and
// writes belief, snapshot and responses. Phase 2 reads phase 1's messages
// back from the output planes (written by threads of the same block, made
// visible by the barrier, and still in L1/L2). Outputs never alias inputs:
// phase 1 reads the v2f planes that phase 2 of a neighbouring thread writes.
// Staging through shared memory, TMA, one launch per tick and CUDA graphs
// are for later work.
//
// Maths. It is that of the Pallas kernels, guards included: the row-scaled
// cofactor inverse with det == 0 -> 1 in the division (inv4.cuh, shared
// with ir_slot.cu), the finite check on
// each dynamic message, and the variable pass's "precision not zero" (any
// entry > 1e-6), det != 0, finite and residual ||Lam Sigma - I|| < 1e-4
// guards. The dynamic messages use the cancellation-free Schur form, which
// needs no sane/negligible guard. The tracking factor follows
// magics_tpu/graph/factors.py:tracking_factor_messages, which carries the
// corner fix (segment-clamped projections, capped blend window); the Pallas
// kernel lacks it (ROADMAP fault F1).
//
// Rounding. Built with --fmad=false: nvcc would otherwise contract a*b+c
// into one FMA, while the plain PyTorch version rounds each product, and the
// knife-edge guards (residual, "precision not zero") could flip on entries
// whose last bits differ. Sums still run in another order than PyTorch's
// reductions, so kernel and plain version agree to float32 roundoff, not
// bit for bit; chip_smoke.py states the tolerances.
//
// Registers (-Xptxas -v, nvcc 12.9, sm_90a): internal_slot_kernel 110,
// variable_slot_kernel 76, no spills, no stack frame. kernels/build.py keeps
// the report beside the library and chip_smoke.py prints it.
// __launch_bounds__(256) caps a thread at 255 registers, so any block the
// wrappers launch (<= 256 threads) fits an SM.

#include <cuda_runtime.h>
#include <math.h>

#include "inv4.cuh"

namespace {

constexpr int kRobotTile = 16;   // robots per block (threadIdx.x)
constexpr int kMaxThreads = 256;

// Field order of magics_tpu_torch/kernels/gbp_slot.py:_IN_FIELDS.
enum In {
  GATE, TGATE, BELIEF_ETA, BELIEF_LAM, BELIEF_MEAN, PRIOR_MEAN, PRIOR_SIGMA,
  DELTA_T, DYN_V2F_ETA, DYN_V2F_LAM, DYN_V2F_MU, DYN_F2V_ETA, DYN_F2V_LAM,
  OBS_H0, OBS_HX, OBS_HY, OBS_V2F_MU, OBS_F2V_ETA, OBS_F2V_LAM,
  TRK_V2F_MU, TRK_F2V_ETA, TRK_F2V_LAM, TRK_RECORD, TRK_TIMEOUT,
  TRK_LAST_POS, TRK_LAST_VAL, PATH_X, PATH_Y, PATH_LEN,
  EXT_SUM_ETA, EXT_SUM_LAM, N_IN
};
// Field order of _OUT_FIELDS.
enum Out {
  O_BELIEF_ETA, O_BELIEF_LAM, O_BELIEF_MEAN, O_SNAP_ETA, O_SNAP_LAM, O_SNAP_MU,
  O_DYN_V2F_ETA, O_DYN_V2F_LAM, O_DYN_V2F_MU, O_DYN_F2V_ETA, O_DYN_F2V_LAM,
  O_OBS_V2F_MU, O_OBS_F2V_ETA, O_OBS_F2V_LAM,
  O_TRK_V2F_MU, O_TRK_F2V_ETA, O_TRK_F2V_LAM,
  O_TRK_RECORD, O_TRK_TIMEOUT, O_TRK_LAST_POS, O_TRK_LAST_VAL, N_OUT
};
// Field order of _VAR_IN_FIELDS / _VAR_OUT_FIELDS.
enum VarIn {
  V_GATE, V_BELIEF_ETA, V_BELIEF_LAM, V_BELIEF_MEAN, V_PRIOR_MEAN,
  V_PRIOR_SIGMA, V_DYN_F2V_ETA, V_DYN_F2V_LAM, V_OBS_F2V_ETA, V_OBS_F2V_LAM,
  V_TRK_F2V_ETA, V_TRK_F2V_LAM, V_EXT_SUM_ETA, V_EXT_SUM_LAM, N_VAR_IN
};
enum VarOut { VO_BELIEF_ETA, VO_BELIEF_LAM, VO_BELIEF_MEAN, N_VAR_OUT };

struct SlotScalars {
  int R, V, W;
  float dyn_c11, dyn_c12, dyn_c22;   // 12/s^2, -6/s^2, 4/s^2 (dynamics sigma)
  float obs_delta, obs_lam;          // finite-difference step, 1/s^2
  float trk_lam, switch_padding, switch_lo, attraction_distance;
  int dynamic_enabled, obstacle_enabled, tracking_enabled;
};

struct SlotArgs {
  const void* in[N_IN];
  void* out[N_OUT];
  SlotScalars s;
};

struct VarArgs {
  const void* in[N_VAR_IN];
  void* out[N_VAR_OUT];
  SlotScalars s;
};

// ---------------------------------------------------------------- planes ---

// A [c..., P, R] plane stack seen from one robot r.
struct Plane {
  const float* a;
  int P, R, r;
  __device__ float operator()(int c, int p) const {
    return __ldg(a + ((size_t)c * P + p) * R + r);
  }
};

// Output planes; also read back after the phase barrier, so plain loads
// (never the read-only __ldg path, which may not see this kernel's writes).
struct OutPlane {
  float* a;
  int P, R, r;
  __device__ float& operator()(int c, int p) const {
    return a[((size_t)c * P + p) * R + r];
  }
};

__device__ __forceinline__ Plane in_plane(const void* p, int P, const SlotScalars& s, int r) {
  return Plane{static_cast<const float*>(p), P, s.R, r};
}
__device__ __forceinline__ OutPlane out_plane(void* p, int P, const SlotScalars& s, int r) {
  return OutPlane{static_cast<float*>(p), P, s.R, r};
}
__device__ __forceinline__ int ld_int(const void* p, const SlotScalars& s, int pos, int r) {
  return __ldg(static_cast<const int*>(p) + (size_t)pos * s.R + r);
}

// ------------------------------------------------------------ 4x4 algebra ---

__device__ __forceinline__ void matmul4(const float a[4][4], const float b[4][4], float c[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = a[i][0] * b[0][j];
#pragma unroll
      for (int k = 1; k < 4; ++k) acc += a[i][k] * b[k][j];
      c[i][j] = acc;
    }
}

__device__ __forceinline__ void matvec4(const float a[4][4], const float v[4], float out[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float acc = a[i][0] * v[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) acc += a[i][k] * v[k];
    out[i] = acc;
  }
}

// One cancellation-free dynamic-factor message (factors.dynamic_factor_
// messages): S = front (mid + C)^-1, lam = S C tail, eta = S eta_c,
// symmetrised; a message with any non-finite entry is empty.
__device__ __forceinline__ void dyn_message(
    const float front[4][4], const float mid[4][4], const float cav_eta[4],
    const float cav_lam[4][4], const float tail[4][4], float eta[4], float lam[4][4]) {
  float m[4][4], t[4][4], s[4][4], ct[4][4], l[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) m[i][j] = mid[i][j] + cav_lam[i][j];
  inv4_rowscaled(m, t);
  matmul4(front, t, s);
  matmul4(cav_lam, tail, ct);
  matmul4(s, ct, l);
  matvec4(s, cav_eta, eta);
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    finite = finite && isfinite(eta[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lam[i][j] = 0.5f * (l[i][j] + l[j][i]);
      finite = finite && isfinite(lam[i][j]);
    }
  }
  if (!finite) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      eta[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) lam[i][j] = 0.f;
    }
  }
}

// Expand 2x2 scalar blocks b to a 4x4 matrix (b (x) I2).
__device__ __forceinline__ void expand2(float b00, float b01, float b10, float b11, float m[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) m[i][j] = 0.f;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    m[c][c] = b00;
    m[c][2 + c] = b01;
    m[2 + c][c] = b10;
    m[2 + c][2 + c] = b11;
  }
}

// ------------------------------------------------ phase 1: factor messages ---

// Dynamic factor e (variables e, e+1): both messages, gated per robot.
__device__ void dynamic_factor(const SlotArgs& A, int r, int e, bool gate) {
  const SlotScalars& S = A.s;
  const int V1 = S.V - 1;
  Plane f2v_eta = in_plane(A.in[DYN_F2V_ETA], V1, S, r);
  Plane f2v_lam = in_plane(A.in[DYN_F2V_LAM], V1, S, r);
  OutPlane o_eta = out_plane(A.out[O_DYN_F2V_ETA], V1, S, r);
  OutPlane o_lam = out_plane(A.out[O_DYN_F2V_LAM], V1, S, r);
  if (!(S.dynamic_enabled && gate)) {
#pragma unroll
    for (int c = 0; c < 8; ++c) o_eta(c, e) = f2v_eta(c, e);
#pragma unroll
    for (int c = 0; c < 32; ++c) o_lam(c, e) = f2v_lam(c, e);
    return;
  }
  const float dt = in_plane(A.in[DELTA_T], V1, S, r)(0, e);
  const float q11 = S.dyn_c11 / (dt * dt * dt);
  const float q12 = S.dyn_c12 / (dt * dt);
  const float q22 = S.dyn_c22 / dt;
  const float s1 = dt * q11 + q12;
  const float s2 = dt * q12 + q22;
  float laa[4][4], qinv[4][4], qinv_phi[4][4], phi_qinv[4][4], phi[4][4], phi_inv[4][4];
  expand2(q11, q11 * dt + q12, s1, s1 * dt + s2, laa);   // Phi^T Q^-1 Phi
  expand2(q11, q12, q12, q22, qinv);                     // Q^-1
  expand2(q11, q11 * dt + q12, q12, q12 * dt + q22, qinv_phi);
  expand2(q11, q12, q11 * dt + q12, q12 * dt + q22, phi_qinv);
  expand2(1.f, dt, 0.f, 1.f, phi);
  expand2(1.f, -dt, 0.f, 1.f, phi_inv);

  Plane v2f_eta = in_plane(A.in[DYN_V2F_ETA], V1, S, r);
  Plane v2f_lam = in_plane(A.in[DYN_V2F_LAM], V1, S, r);
  float cav_eta[4], cav_lam[4][4], eta[4], lam[4][4];
  // slot 0 (to variable e): cavity on variable e+1 (v2f slot 1)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cav_eta[i] = v2f_eta(4 + i, e);
#pragma unroll
    for (int j = 0; j < 4; ++j) cav_lam[i][j] = v2f_lam(16 + 4 * i + j, e);
  }
  dyn_message(phi_qinv, qinv, cav_eta, cav_lam, phi, eta, lam);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o_eta(i, e) = eta[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) o_lam(4 * i + j, e) = lam[i][j];
  }
  // slot 1 (to variable e+1): cavity on variable e (v2f slot 0)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cav_eta[i] = v2f_eta(i, e);
#pragma unroll
    for (int j = 0; j < 4; ++j) cav_lam[i][j] = v2f_lam(4 * i + j, e);
  }
  dyn_message(qinv_phi, laa, cav_eta, cav_lam, phi_inv, eta, lam);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o_eta(4 + i, e) = eta[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) o_lam(16 + 4 * i + j, e) = lam[i][j];
  }
}

// Obstacle factor k (on variable k+1), from the three SDF taps.
__device__ void obstacle_factor(const SlotArgs& A, int r, int k, bool gate) {
  const SlotScalars& S = A.s;
  const int V2 = S.V - 2;
  OutPlane o_eta = out_plane(A.out[O_OBS_F2V_ETA], V2, S, r);
  OutPlane o_lam = out_plane(A.out[O_OBS_F2V_LAM], V2, S, r);
  if (!(S.obstacle_enabled && gate)) {
    Plane f2v_eta = in_plane(A.in[OBS_F2V_ETA], V2, S, r);
    Plane f2v_lam = in_plane(A.in[OBS_F2V_LAM], V2, S, r);
#pragma unroll
    for (int c = 0; c < 4; ++c) o_eta(c, k) = f2v_eta(c, k);
#pragma unroll
    for (int c = 0; c < 16; ++c) o_lam(c, k) = f2v_lam(c, k);
    return;
  }
  const float h0 = in_plane(A.in[OBS_H0], V2, S, r)(0, k);
  const float jx = (in_plane(A.in[OBS_HX], V2, S, r)(0, k) - h0) / S.obs_delta;
  const float jy = (in_plane(A.in[OBS_HY], V2, S, r)(0, k) - h0) / S.obs_delta;
  Plane mu = in_plane(A.in[OBS_V2F_MU], V2, S, r);
  const float jx0 = jx * mu(0, k) + jy * mu(1, k);
  const float scale = S.obs_lam * (jx0 - h0);
  const float J[4] = {jx, jy, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o_eta(i, k) = J[i] * scale;
#pragma unroll
    for (int j = 0; j < 4; ++j) o_lam(4 * i + j, k) = S.obs_lam * J[i] * J[j];
  }
}

// Tracking factor k (on variable k+1): factors.tracking_factor_messages.
__device__ void tracking_factor(const SlotArgs& A, int r, int k, bool tgate) {
  const SlotScalars& S = A.s;
  const int V2 = S.V - 2;
  Plane f2v_eta = in_plane(A.in[TRK_F2V_ETA], V2, S, r);
  Plane f2v_lam = in_plane(A.in[TRK_F2V_LAM], V2, S, r);
  Plane last_pos = in_plane(A.in[TRK_LAST_POS], V2, S, r);
  OutPlane o_eta = out_plane(A.out[O_TRK_F2V_ETA], V2, S, r);
  OutPlane o_lam = out_plane(A.out[O_TRK_F2V_LAM], V2, S, r);
  OutPlane o_last_pos = out_plane(A.out[O_TRK_LAST_POS], V2, S, r);
  float& o_last_val = out_plane(A.out[O_TRK_LAST_VAL], V2, S, r)(0, k);
  int* o_record = static_cast<int*>(A.out[O_TRK_RECORD]) + (size_t)k * S.R + r;
  int* o_timeout = static_cast<int*>(A.out[O_TRK_TIMEOUT]) + (size_t)k * S.R + r;
  const int rec_in = ld_int(A.in[TRK_RECORD], S, k, r);
  const int timeout = ld_int(A.in[TRK_TIMEOUT], S, k, r);
  const float old_val = in_plane(A.in[TRK_LAST_VAL], V2, S, r)(0, k);

  if (!(S.tracking_enabled && tgate)) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o_eta(c, k) = f2v_eta(c, k);
#pragma unroll
    for (int c = 0; c < 16; ++c) o_lam(c, k) = f2v_lam(c, k);
    *o_record = rec_in;
    *o_timeout = timeout;
    o_last_pos(0, k) = last_pos(0, k);
    o_last_pos(1, k) = last_pos(1, k);
    o_last_val = old_val;
    return;
  }

  Plane mu = in_plane(A.in[TRK_V2F_MU], V2, S, r);
  const float x = mu(0, k), y = mu(1, k), vx = mu(2, k), vy = mu(3, k);
  const int plen = ld_int(A.in[PATH_LEN], S, 0, r);
  const int max_record = max(plen - 2, 0);
  const int rec = min(max(rec_in, 0), max_record);
  const float* px = static_cast<const float*>(A.in[PATH_X]);
  const float* py = static_cast<const float*>(A.in[PATH_Y]);
  auto pt_x = [&](int w) { return __ldg(px + (size_t)min(max(w, 0), S.W - 1) * S.R + r); };
  auto pt_y = [&](int w) { return __ldg(py + (size_t)min(max(w, 0), S.W - 1) * S.R + r); };

  const float csx = pt_x(rec), csy = pt_y(rec);
  const float cex = pt_x(rec + 1), cey = pt_y(rec + 1);
  const float lx = cex - csx, ly = cey - csy;
  const float line_dot = lx * lx + ly * ly;
  const float safe_dot = line_dot > 0.f ? line_dot : 1.f;
  const float t_cur = fminf(fmaxf(((x - csx) * lx + (y - csy) * ly) / safe_dot, 0.f), 1.f);
  const float pcx = csx + t_cur * lx, pcy = csy + t_cur * ly;
  const float d_pad = S.switch_padding, d_lo = S.switch_lo;
  const float cur_to_end = sqrtf((cex - pcx) * (cex - pcx) + (cey - pcy) * (cey - pcy));

  const int rec_prev = max(rec - 1, 0);
  const float psx = pt_x(rec_prev), psy = pt_y(rec_prev);
  const float plx = csx - psx, ply = csy - psy;   // previous segment ends at cur_s
  const float pline_dot = plx * plx + ply * ply;
  const float psafe = pline_dot > 0.f ? pline_dot : 1.f;
  const float t_prev = fminf(fmaxf(((x - psx) * plx + (y - psy) * ply) / psafe, 0.f), 1.f);
  const float ppx = psx + t_prev * plx, ppy = psy + t_prev * ply;
  const float cur_proj_to_prev_end = sqrtf((csx - pcx) * (csx - pcx) + (csy - pcy) * (csy - pcy));
  const float prev_proj_to_prev_end = sqrtf((csx - ppx) * (csx - ppx) + (csy - ppy) * (csy - ppy));
  const float win_prev = fminf(d_pad, 0.5f * sqrtf(pline_dot));
  const float win_cur = fminf(d_pad, 0.5f * sqrtf(line_dot));
  const bool use_prev = rec > 0 && cur_proj_to_prev_end < win_cur &&
                        cur_proj_to_prev_end > d_lo && prev_proj_to_prev_end > d_lo &&
                        prev_proj_to_prev_end < win_prev;
  const int new_record = cur_to_end < d_pad ? min(rec + 1, max_record) : rec;

  const float vel_norm = sqrtf(vx * vx + vy * vy);
  const float line_norm = sqrtf(lx * lx + ly * ly);
  const float ux = line_norm > 0.f ? lx / line_norm : 0.f;
  const float uy = line_norm > 0.f ? ly / line_norm : 0.f;
  const float mpx = use_prev ? x + (pcx - x) + (ppx - x) : pcx + ux * vel_norm / 5.f;
  const float mpy = use_prev ? y + (pcy - y) + (ppy - y) : pcy + uy * vel_norm / 5.f;

  const float dmx = mpx - x, dmy = mpy - y;
  const float h0 = fminf(sqrtf(dmx * dmx + dmy * dmy) / S.attraction_distance, 1.f);
  const float safe_h0 = h0 != 0.f ? h0 : 1.f;
  const float J[4] = {(x - mpx) / safe_h0, (y - mpy) / safe_h0, 0.f, 0.f};
  const float jx0 = J[0] * x + J[1] * y;
  const float scale = S.trk_lam * (jx0 - h0);

  const bool timed_out = timeout > 0;
  const bool path_done = plen < 2 || rec >= plen - 1;
  const bool skipped = timed_out || path_done || h0 == 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o_eta(i, k) = skipped ? 0.f : J[i] * scale;
#pragma unroll
    for (int j = 0; j < 4; ++j) o_lam(4 * i + j, k) = skipped ? 0.f : S.trk_lam * J[i] * J[j];
  }
  *o_record = skipped ? rec_in : new_record;
  *o_timeout = timed_out ? timeout - 1 : (timeout == 0 ? -1 : timeout);
  o_last_pos(0, k) = skipped ? last_pos(0, k) : mpx;
  o_last_pos(1, k) = skipped ? last_pos(1, k) : mpy;
  o_last_val = skipped ? old_val : h0;
}

// ---------------------------------------------- phase 2: the variable pass ---

// The belief update of one variable: prior + external sum + the factor
// messages in (dyn0, dyn1, interior) order, as the Pallas kernels add them;
// then the guarded row-scaled inverse and the mean update. Returns the new
// (or, for a gated-off robot, the old) belief in eta/lam/mean.
struct Belief {
  float eta[4], lam[4][4], mean[4];
};

template <class DynEta, class DynLam, class IntEta, class IntLam>
__device__ __forceinline__ Belief update_belief(
    const SlotScalars& S, int r, int v, bool gate,
    const void* belief_eta_p, const void* belief_lam_p, const void* belief_mean_p,
    const void* prior_mean_p, const void* prior_sigma_p,
    const void* ext_eta_p, const void* ext_lam_p,
    DynEta dyn_eta, DynLam dyn_lam, IntEta int_eta, IntLam int_lam) {
  const int V = S.V, V1 = V - 1;
  Plane belief_eta = in_plane(belief_eta_p, V, S, r);
  Plane belief_lam = in_plane(belief_lam_p, V, S, r);
  Plane belief_mean = in_plane(belief_mean_p, V, S, r);
  Belief b;
  if (!gate) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b.eta[i] = belief_eta(i, v);
      b.mean[i] = belief_mean(i, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) b.lam[i][j] = belief_lam(4 * i + j, v);
    }
    return b;
  }
  Plane prior_mean = in_plane(prior_mean_p, V, S, r);
  Plane ext_eta = in_plane(ext_eta_p, V, S, r);
  Plane ext_lam = in_plane(ext_lam_p, V, S, r);
  const float ps = in_plane(prior_sigma_p, V, S, r)(0, v);
  float eta[4], lam[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    eta[i] = ps * prior_mean(i, v) + ext_eta(i, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) lam[i][j] = (i == j ? ps : 0.f) + ext_lam(4 * i + j, v);
  }
  if (v < V1) {   // dynamic factor v, slot 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      eta[i] += dyn_eta(i, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) lam[i][j] += dyn_lam(4 * i + j, v);
    }
  }
  if (v >= 1) {   // dynamic factor v-1, slot 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      eta[i] += dyn_eta(4 + i, v - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) lam[i][j] += dyn_lam(16 + 4 * i + j, v - 1);
    }
  }
  if (v >= 1 && v <= V - 2) {   // obstacle + tracking factor v-1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      eta[i] += int_eta(i, v - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) lam[i][j] += int_lam(4 * i + j, v - 1);
    }
  }

  bool pnz = false;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) pnz = pnz || lam[i][j] > 1e-6f;
  float cov[4][4];
  const float det = inv4_rowscaled(lam, cov);
  float resid = 0.f;
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = lam[i][0] * cov[0][j];
#pragma unroll
      for (int k = 1; k < 4; ++k) acc += lam[i][k] * cov[k][j];
      resid = fmaxf(resid, fabsf(acc - (i == j ? 1.f : 0.f)));
      finite = finite && isfinite(cov[i][j]);
    }
  const bool valid = pnz && det != 0.f && finite && resid < 1e-4f;
  float mean[4];
  matvec4(cov, eta, mean);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b.eta[i] = eta[i];
    b.mean[i] = valid ? mean[i] : belief_mean(i, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) b.lam[i][j] = lam[i][j];
  }
  return b;
}

__device__ __forceinline__ void store_belief(const Belief& b, OutPlane eta, OutPlane lam,
                                             OutPlane mean, int v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    eta(i, v) = b.eta[i];
    mean(i, v) = b.mean[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) lam(4 * i + j, v) = b.lam[i][j];
  }
}

// Responses of variable v to its dynamic factors (belief - incoming message;
// the mean is the belief mean) and to its interior factors (the mean).
__device__ void responses(const SlotArgs& A, int r, int v, bool gate, const Belief& b) {
  const SlotScalars& S = A.s;
  const int V = S.V, V1 = V - 1, V2 = V - 2;
  Plane v2f_eta = in_plane(A.in[DYN_V2F_ETA], V1, S, r);
  Plane v2f_lam = in_plane(A.in[DYN_V2F_LAM], V1, S, r);
  Plane v2f_mu = in_plane(A.in[DYN_V2F_MU], V1, S, r);
  OutPlane f2v_eta = out_plane(A.out[O_DYN_F2V_ETA], V1, S, r);
  OutPlane f2v_lam = out_plane(A.out[O_DYN_F2V_LAM], V1, S, r);
  OutPlane o_eta = out_plane(A.out[O_DYN_V2F_ETA], V1, S, r);
  OutPlane o_lam = out_plane(A.out[O_DYN_V2F_LAM], V1, S, r);
  OutPlane o_mu = out_plane(A.out[O_DYN_V2F_MU], V1, S, r);
  const bool respond = S.dynamic_enabled && gate;
  // slot 0 of factor v (v < V1) and slot 1 of factor v-1 (v >= 1)
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    const int e = v - slot;
    if (e < 0 || e >= V1) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = 4 * slot + i;
      o_eta(ci, e) = respond ? b.eta[i] - f2v_eta(ci, e) : v2f_eta(ci, e);
      o_mu(ci, e) = respond ? b.mean[i] : v2f_mu(ci, e);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cij = 16 * slot + 4 * i + j;
        o_lam(cij, e) = respond ? b.lam[i][j] - f2v_lam(cij, e) : v2f_lam(cij, e);
      }
    }
  }
  if (v >= 1 && v <= V - 2) {
    const int k = v - 1;
    Plane obs_mu = in_plane(A.in[OBS_V2F_MU], V2, S, r);
    Plane trk_mu = in_plane(A.in[TRK_V2F_MU], V2, S, r);
    OutPlane o_obs = out_plane(A.out[O_OBS_V2F_MU], V2, S, r);
    OutPlane o_trk = out_plane(A.out[O_TRK_V2F_MU], V2, S, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o_obs(i, k) = (S.obstacle_enabled && gate) ? b.mean[i] : obs_mu(i, k);
      o_trk(i, k) = (S.tracking_enabled && gate) ? b.mean[i] : trk_mu(i, k);
    }
  }
}

// Sum of two interior (obstacle + tracking) message planes, added as one
// term like the Pallas kernels' `obs + trk`.
template <class P>
struct SumPlanes {
  P a, b;
  __device__ float operator()(int c, int p) const { return a(c, p) + b(c, p); }
};

// ----------------------------------------------------------------- kernels ---

__global__ void __launch_bounds__(kMaxThreads) internal_slot_kernel(SlotArgs A) {
  const SlotScalars& S = A.s;
  const int V = S.V, V1 = V - 1, V2 = V - 2;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < S.R;
  const int rr = live ? r : 0;   // a safe robot index for address arithmetic
  const bool gate = live && __ldg(static_cast<const float*>(A.in[GATE]) + rr) > 0.f;
  const bool tgate = live && __ldg(static_cast<const float*>(A.in[TGATE]) + rr) > 0.f;

  if (live) {
    for (int e = threadIdx.y; e < V; e += blockDim.y) {
      if (e < V1) dynamic_factor(A, rr, e, gate);
      if (e >= 1 && e <= V - 2) {
        obstacle_factor(A, rr, e - 1, gate);
        tracking_factor(A, rr, e - 1, tgate);
      }
    }
  }
  __syncthreads();   // phase 1's messages are visible to the whole block
  if (!live) return;

  OutPlane dyn_eta = out_plane(A.out[O_DYN_F2V_ETA], V1, S, rr);
  OutPlane dyn_lam = out_plane(A.out[O_DYN_F2V_LAM], V1, S, rr);
  SumPlanes<OutPlane> int_eta{out_plane(A.out[O_OBS_F2V_ETA], V2, S, rr),
                              out_plane(A.out[O_TRK_F2V_ETA], V2, S, rr)};
  SumPlanes<OutPlane> int_lam{out_plane(A.out[O_OBS_F2V_LAM], V2, S, rr),
                              out_plane(A.out[O_TRK_F2V_LAM], V2, S, rr)};
  for (int v = threadIdx.y; v < V; v += blockDim.y) {
    const Belief b = update_belief(
        S, rr, v, gate, A.in[BELIEF_ETA], A.in[BELIEF_LAM], A.in[BELIEF_MEAN],
        A.in[PRIOR_MEAN], A.in[PRIOR_SIGMA], A.in[EXT_SUM_ETA], A.in[EXT_SUM_LAM],
        dyn_eta, dyn_lam, int_eta, int_lam);
    store_belief(b, out_plane(A.out[O_BELIEF_ETA], V, S, rr),
                 out_plane(A.out[O_BELIEF_LAM], V, S, rr),
                 out_plane(A.out[O_BELIEF_MEAN], V, S, rr), v);
    store_belief(b, out_plane(A.out[O_SNAP_ETA], V, S, rr),
                 out_plane(A.out[O_SNAP_LAM], V, S, rr),
                 out_plane(A.out[O_SNAP_MU], V, S, rr), v);
    responses(A, rr, v, gate, b);
  }
}

__global__ void __launch_bounds__(kMaxThreads) variable_slot_kernel(VarArgs A) {
  const SlotScalars& S = A.s;
  const int V = S.V, V1 = V - 1, V2 = V - 2;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= S.R) return;
  const bool gate = __ldg(static_cast<const float*>(A.in[V_GATE]) + r) > 0.f;
  Plane dyn_eta = in_plane(A.in[V_DYN_F2V_ETA], V1, S, r);
  Plane dyn_lam = in_plane(A.in[V_DYN_F2V_LAM], V1, S, r);
  SumPlanes<Plane> int_eta{in_plane(A.in[V_OBS_F2V_ETA], V2, S, r),
                           in_plane(A.in[V_TRK_F2V_ETA], V2, S, r)};
  SumPlanes<Plane> int_lam{in_plane(A.in[V_OBS_F2V_LAM], V2, S, r),
                           in_plane(A.in[V_TRK_F2V_LAM], V2, S, r)};
  for (int v = threadIdx.y; v < V; v += blockDim.y) {
    const Belief b = update_belief(
        S, r, v, gate, A.in[V_BELIEF_ETA], A.in[V_BELIEF_LAM], A.in[V_BELIEF_MEAN],
        A.in[V_PRIOR_MEAN], A.in[V_PRIOR_SIGMA], A.in[V_EXT_SUM_ETA], A.in[V_EXT_SUM_LAM],
        dyn_eta, dyn_lam, int_eta, int_lam);
    store_belief(b, out_plane(A.out[VO_BELIEF_ETA], V, S, r),
                 out_plane(A.out[VO_BELIEF_LAM], V, S, r),
                 out_plane(A.out[VO_BELIEF_MEAN], V, S, r), v);
  }
}

// Block shape: kRobotTile robots x ny chain positions, ny spreading V evenly
// over as few passes as keep the block within kMaxThreads.
dim3 block_for(int V) {
  const int max_ny = kMaxThreads / kRobotTile;
  const int passes = (V + max_ny - 1) / max_ny;
  return dim3(kRobotTile, (V + passes - 1) / passes);
}

SlotScalars scalars(int R, int V, int W, const float* f, const int* flags) {
  SlotScalars s;
  s.R = R;
  s.V = V;
  s.W = W;
  s.dyn_c11 = f[0];
  s.dyn_c12 = f[1];
  s.dyn_c22 = f[2];
  s.obs_delta = f[3];
  s.obs_lam = f[4];
  s.trk_lam = f[5];
  s.switch_padding = f[6];
  s.switch_lo = f[7];
  s.attraction_distance = f[8];
  s.dynamic_enabled = flags[0];
  s.obstacle_enabled = flags[1];
  s.tracking_enabled = flags[2];
  return s;
}

}  // namespace

// C entry points, loaded with ctypes (kernels/build.py). `in` / `out` are host
// arrays of device pointers in the field order of kernels/gbp_slot.py;
// `f` holds the 9 float scalars in SlotScalars order (dyn_c11 ..
// attraction_distance) and `flags` the 3 enable flags. The kernel runs on
// `stream` and is not waited for. Returns cudaGetLastError() after the launch.
extern "C" int gbp_internal_slot(const void* const* in, void* const* out, int R, int V,
                                 int W, const float* f, const int* flags, void* stream) {
  SlotArgs a;
  for (int i = 0; i < N_IN; ++i) a.in[i] = in[i];
  for (int i = 0; i < N_OUT; ++i) a.out[i] = out[i];
  a.s = scalars(R, V, W, f, flags);
  const dim3 block = block_for(V);
  const dim3 grid((R + kRobotTile - 1) / kRobotTile);
  internal_slot_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gbp_variable_slot(const void* const* in, void* const* out, int R, int V,
                                 const float* f, const int* flags, void* stream) {
  VarArgs a;
  for (int i = 0; i < N_VAR_IN; ++i) a.in[i] = in[i];
  for (int i = 0; i < N_VAR_OUT; ++i) a.out[i] = out[i];
  a.s = scalars(R, V, 0, f, flags);
  const dim3 block = block_for(V);
  const dim3 grid((R + kRobotTile - 1) / kRobotTile);
  variable_slot_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gbp_slot_in_fields() { return N_IN; }
extern "C" int gbp_slot_out_fields() { return N_OUT; }
extern "C" int gbp_variable_in_fields() { return N_VAR_IN; }
extern "C" int gbp_variable_out_fields() { return N_VAR_OUT; }
