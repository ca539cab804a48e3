// Hand-written Hopper (sm_90a) kernels for one GBP slot of the whole swarm.
//
// What they replace
//   internal_slot_kernel  <- magics_tpu/kernels/gbp_slot.py:internal_slot
//                            (Pallas body _slot_kernel): one internal GBP slot,
//                            fused: dynamic / obstacle / tracking factor
//                            messages, then the variable pass (belief update,
//                            snapshot, responses to the internal factors).
//                            It also takes the obstacle factors' SDF taps,
//                            which the JAX package computes outside its Pallas
//                            kernel (magics_tpu/kernels/hot.py) because a TPU
//                            gather serialises.
//   variable_slot_kernel  <- magics_tpu/kernels/gbp_slot.py:variable_slot
//                            (Pallas body _variable_kernel): the belief update
//                            of an external slot, no responses, no snapshot.
//
// Layout. Both read and write the TPU kernels' "hot layout": every field is a
// contiguous [c..., P, R] plane stack, robots last (magics_tpu_torch
// kernels/gbp_slot.py lists the fields and shapes). Element (c, p, r) lives
// at (c * P + p) * R + r. The ragged robot edge is masked here: R need not be
// a multiple of anything. The internal slot also reads the SDF image, a
// contiguous [H, W] float32 array.
//
// What bounds them on the H100. Per robot, at V chain variables and W path
// points (V1 = V-1, V2 = V-2), float32:
//   internal slot reads  3 + 49 V + 89 V1 + 53 V2 + 2 W floats (+ the SDF)
//                 writes     48 V + 88 V1 + 53 V2     floats
//   variable slot reads  1 + 49 V + 40 V1 + 40 V2     floats, writes 24 V
//                 (a gated-on robot reads 1 + 25 V + 40 V1 + 40 V2).
// At the bench shape (V=21, W=2, R=1024) that is 15,292 + 15,100 B per robot
// and a 64 KB SDF, 31.2 MB per internal-slot launch, and 12.7 MB per
// variable-slot launch. A gated-on robot needs less: not its old beliefs
// and the old messages of the factors it computes, nor the z and velocity
// of its obstacle linearisation points, nor (tracking off) the path; the
// SDF only at the pixels its taps hit. With every robot gated on that is
// some 23.4 MB (7.0 us at 3.35 TB/s) and 10.6 MB (3.2 us); chip_smoke.py
// counts the bytes at its run's inputs. The arithmetic is some
// 2,000 flops per robot and variable (two 4x4 inverses and six 4x4 products
// per dynamic factor, one inverse and a residual check per variable), about
// 0.04 GFLOP per launch: under a microsecond at 67 TFLOP/s of float32. Both
// kernels are memory-bound.
//
// The internal slot's design (redesigned for this card). A block owns a tile
// of T robots (8 at the bench shape) times all V chain positions, two threads
// per (robot, variable v); at R=1024 that is 128 blocks of 336 threads for
// 132 SMs.
//   1. Before any maths, every thread issues its share of cp.async copies of
//      the tile's input planes into shared memory: 16-byte pieces where the
//      planes are aligned and the tile is whole, else 4-byte ones (zero-filled
//      past the robot edge). Two groups: the factor messages' inputs
//      (delta_t, the dynamic cavities, the obstacle linearisation points) and
//      the belief update's (prior, external sums). The whole tile's inputs
//      are in flight at once (45 KB a block at the bench shape), and the
//      second group lands while the first is worked on. Inputs that only a
//      gated-off robot or a disabled factor reads (old beliefs and messages,
//      passed through) are read from device memory where they are needed, so
//      a live robot does not load them at all.
//   2. The pair of (robot, v) computes every message TO variable v: half 0
//      dynamic factor v's slot 0 and the obstacle factor (three SDF taps,
//      loads from the 64 KB image, which stays in L1/L2), half 1 dynamic
//      factor v-1's slot 1 and the tracking factor. Each writes its messages
//      and the two swap them by warp shuffles.
//   3. Both halves sum them with the prior and external sum and run the
//      guarded row-scaled inverse, each forming two of its four columns and
//      swapping them (the same operations as one thread's inverse, so the
//      same bits), then split the writes: belief and the response to factor
//      v (belief less its message), or snapshot and the response to factor
//      v-1. No thread reads device memory another wrote, so the slot needs
//      no barrier but the staging's.
// Why two threads a variable, on one code path: R x V is only 21,504
// (robot, variable) items at the bench shape, 5 warps an SM, and each item's
// messages are long chains of dependent divisions and 4x4 products, so one
// thread an item left the SMs waiting on latency: 20.5-21.8 us on an H100
// with this staging. Two threads an item whose halves branched on `half`
// ran the two branches one after the other in each warp (18.3-19.0 us);
// with the slot, the columns and the output planes chosen by data, both
// halves run every instruction together (16.6-16.8 us). 8-robot tiles took
// 16.6 us where 4- and 2-robot tiles took 28 and 50 us (the same items over
// more blocks, each row of a plane 16 or 8 bytes: less of each 32-byte
// sector used). The design before (16 robots a block, loads issued one
// after another between the maths, two phases through the output planes)
// took 33.8 us, 28% of HBM bandwidth. All on an NVIDIA H100 80GB HBM3 at
// 700 W, torch.profiler, PERF.md.
//
// The variable slot's design (redesigned for this card the same way). A
// block owns a tile of T robots (8 at the bench shape: 128 blocks of 336
// threads at R=1024; the largest power of two up to 8 whose staged inputs
// fit, so 8 up to V = 70, then 4 up to 139, 2 up to 277, 1 up to 554), two
// threads per (robot, variable).
//   1. Before any maths, the tile's belief-sum terms (prior mean and sigma,
//      external sums, the dynamic, obstacle and tracking f2v messages: 1 +
//      25 V + 40 V1 + 40 V2 floats a robot, 66.7 KB a block at the bench
//      shape) go to shared memory by cp.async in one group, as above. The
//      old belief, which only a gated-off robot (and a failed guard's mean)
//      needs, is read from device memory where it is used.
//   2. Both halves sum the terms in the Pallas kernel's order and run the
//      guarded inverse as the internal slot's pairs do (the same bits as one
//      thread's inverse), then split the writes: half 0 eta and precision
//      rows 0-1, half 1 the mean and rows 2-3.
// It agrees with its plain version bit for bit at the bench shape and takes
// 9.4 us a launch in the sender ticks where the design before took 12.2
// (the same call), 7.2 us in repeated calls and 10.1 with L2 flushed
// (chip_smoke.py; scripts/torch_tick_compare.py times both designs). The
// bound is 3.2 us; the staging, whose rows are 32 bytes (8 robots of a
// plane row) scattered 4 KB apart, and the lockstep of load, inverse and
// store in one block an SM are the suspects. 16-robot tiles (64 blocks) were
// slower. The design before (16 robots a block, one thread per (robot,
// variable), each loading its ~100 floats one after another from device
// memory and running the whole inverse alone: 64 blocks of 176 threads for
// 132 SMs) sat at 3.9x its bound. All on an NVIDIA H100 80GB HBM3 at 700 W,
// torch.profiler. ptxas (sm_90a): 64 registers at every tile, no spills at
// 8, 4 and 2 robots; the 1-robot tile (V >= 278 only) spills 8 bytes. Its
// time at V = 278
// against the 2-robot tile's at V = 277 is in PERF.md
// (scripts/torch_tick_compare.py).
//
// Maths. It is that of the Pallas kernels, guards included: the row-scaled
// cofactor inverse with det == 0 -> 1 in the division (inv4.cuh, shared
// with ir_slot.cu), the finite check on each dynamic message, and the
// variable pass's "precision not zero" (any entry > 1e-6), det != 0, finite
// and residual ||Lam Sigma - I|| < 1e-4 guards. The dynamic messages use the
// cancellation-free Schur form, which needs no sane/negligible guard. The
// tracking factor follows magics_tpu/graph/factors.py:
// tracking_factor_messages, which carries the corner fix (segment-clamped
// projections, capped blend window); the Pallas kernel lacks it (ROADMAP
// fault F1). The SDF taps follow magics_tpu_torch/graph/factors.py:
// obstacle_taps (the JAX "gather" method) operation for operation.
//
// Rounding. Built with --fmad=false: nvcc would otherwise contract a*b+c
// into one FMA, while the plain PyTorch version rounds each product, and the
// knife-edge guards (residual, "precision not zero") and the SDF pixel index
// could flip on values whose last bits differ. The taps' constants (W / ww,
// ww / 2, the tap step) come in rounded from double to float, as PyTorch
// rounds a Python scalar against a float32 tensor. Sums still run in another
// order than PyTorch's reductions, so kernel and plain version agree to
// float32 roundoff, not bit for bit; chip_smoke.py states the tolerances.
// The belief guard's residual ||lam cov - I|| sums exact products in
// double (core/linalg.py:belief_covariance does the same): on a
// rank-deficient precision the float32 sum of rounded products can cancel
// to exactly the identity and pass, where the JAX package's XLA dot, whose
// fused multiply-adds keep the products' low bits, fails it. The
// swarm-scale workload's 12.8 km coordinates reach such precisions within
// a tick.
//
// Registers: kernels/build.py keeps the -Xptxas -v report beside the library
// and chip_smoke.py prints it. The launch bounds (512 threads) cap a
// thread's registers so that any block the wrappers launch fits an SM.

#include <cuda_runtime.h>
#include <math.h>

#include "inv4.cuh"

namespace {

constexpr int kMaxSlotThreads = 512;  // threads per block
constexpr int kMaxTile = 8;         // most robots per block
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use

// Field order of magics_tpu_torch/kernels/gbp_slot.py:_KERNEL_IN_FIELDS.
enum In {
  GATE, TGATE, BELIEF_ETA, BELIEF_LAM, BELIEF_MEAN, PRIOR_MEAN, PRIOR_SIGMA,
  DELTA_T, DYN_V2F_ETA, DYN_V2F_LAM, DYN_V2F_MU, DYN_F2V_ETA, DYN_F2V_LAM,
  OBS_V2F_MU, OBS_F2V_ETA, OBS_F2V_LAM,
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

// The internal slot's inputs staged in shared memory, in copy order: the
// factor messages' group, then (from S_PRIOR_MEAN) the belief update's.
enum Staged {
  S_DELTA_T, S_DYN_V2F_ETA, S_DYN_V2F_LAM, S_OBS_V2F_MU,
  S_PRIOR_MEAN, S_PRIOR_SIGMA, S_EXT_SUM_ETA, S_EXT_SUM_LAM, N_STAGED
};
// The variable slot's staged inputs, in copy order: every term of a
// gated-on robot's belief sum.
enum VarStaged {
  VS_PRIOR_MEAN, VS_PRIOR_SIGMA, VS_EXT_SUM_ETA, VS_EXT_SUM_LAM,
  VS_DYN_F2V_ETA, VS_DYN_F2V_LAM, VS_OBS_F2V_ETA, VS_OBS_F2V_LAM,
  VS_TRK_F2V_ETA, VS_TRK_F2V_LAM, N_VAR_STAGED
};

struct SlotScalars {
  int R, V, W;
  float dyn_c11, dyn_c12, dyn_c22;   // 12/s^2, -6/s^2, 4/s^2 (dynamics sigma)
  float obs_delta, obs_lam;          // finite-difference step, 1/s^2
  float trk_lam, switch_padding, switch_lo, attraction_distance;
  int dynamic_enabled, obstacle_enabled, tracking_enabled;
  // the SDF taps (internal slot): image size, world -> pixel constants, step
  int sdf_h, sdf_w;
  float half_ww, half_wh, x_scale, y_scale, tap_delta;
  int vec16;   // the staged planes 16-byte aligned and R % 4 == 0
};

struct SlotArgs {
  const void* in[N_IN];
  void* out[N_OUT];
  const float* sdf;
  SlotScalars s;
};

struct VarArgs {
  const void* in[N_VAR_IN];
  void* out[N_VAR_OUT];
  SlotScalars s;
};

// ---------------------------------------------------------------- planes ---

// A [c..., P, R] plane stack in device memory seen from one robot r.
struct Plane {
  const float* a;
  int P, R, r;
  __device__ float operator()(int c, int p) const {
    return __ldg(a + ((size_t)c * P + p) * R + r);
  }
};

struct OutPlane {
  float* a;
  int P, R, r;
  __device__ float& operator()(int c, int p) const {
    return a[((size_t)c * P + p) * R + r];
  }
};

// A [c..., P] plane stack of one robot staged in shared memory as [rows][T].
struct SPlane {
  const float* a;
  int P, T, lr;
  __device__ float operator()(int c, int p) const { return a[(c * P + p) * T + lr]; }
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

// ------------------------------------------------------------ staging ---

// A list of staged fields: for staged field s, the input it copies
// (`field`), its rows (c..., P) per robot (`rows`) and its plane length P
// (`plane`), at V chain variables.
struct InternalStaging {
  static constexpr int kCount = N_STAGED;
  __host__ __device__ static int field(int s) {
    switch (s) {
      case S_DELTA_T: return DELTA_T;
      case S_DYN_V2F_ETA: return DYN_V2F_ETA;
      case S_DYN_V2F_LAM: return DYN_V2F_LAM;
      case S_OBS_V2F_MU: return OBS_V2F_MU;
      case S_PRIOR_MEAN: return PRIOR_MEAN;
      case S_PRIOR_SIGMA: return PRIOR_SIGMA;
      case S_EXT_SUM_ETA: return EXT_SUM_ETA;
      default: return EXT_SUM_LAM;
    }
  }
  __host__ __device__ static int rows(int s, int V) {
    switch (s) {
      case S_DELTA_T: return V - 1;
      case S_DYN_V2F_ETA: return 8 * (V - 1);
      case S_DYN_V2F_LAM: return 32 * (V - 1);
      case S_OBS_V2F_MU: return 4 * (V - 2);
      case S_PRIOR_MEAN: return 4 * V;
      case S_PRIOR_SIGMA: return V;
      case S_EXT_SUM_ETA: return 4 * V;
      default: return 16 * V;
    }
  }
  __host__ __device__ static int plane(int s, int V) {
    return s <= S_DYN_V2F_LAM ? V - 1 : (s == S_OBS_V2F_MU ? V - 2 : V);
  }
};

struct VariableStaging {
  static constexpr int kCount = N_VAR_STAGED;
  __host__ __device__ static int field(int s) {
    switch (s) {
      case VS_PRIOR_MEAN: return V_PRIOR_MEAN;
      case VS_PRIOR_SIGMA: return V_PRIOR_SIGMA;
      case VS_EXT_SUM_ETA: return V_EXT_SUM_ETA;
      case VS_EXT_SUM_LAM: return V_EXT_SUM_LAM;
      case VS_DYN_F2V_ETA: return V_DYN_F2V_ETA;
      case VS_DYN_F2V_LAM: return V_DYN_F2V_LAM;
      case VS_OBS_F2V_ETA: return V_OBS_F2V_ETA;
      case VS_OBS_F2V_LAM: return V_OBS_F2V_LAM;
      case VS_TRK_F2V_ETA: return V_TRK_F2V_ETA;
      default: return V_TRK_F2V_LAM;
    }
  }
  __host__ __device__ static int rows(int s, int V) {
    switch (s) {
      case VS_PRIOR_MEAN: return 4 * V;
      case VS_PRIOR_SIGMA: return V;
      case VS_EXT_SUM_ETA: return 4 * V;
      case VS_EXT_SUM_LAM: return 16 * V;
      case VS_DYN_F2V_ETA: return 8 * (V - 1);
      case VS_DYN_F2V_LAM: return 32 * (V - 1);
      case VS_OBS_F2V_ETA: case VS_TRK_F2V_ETA: return 4 * (V - 2);
      default: return 16 * (V - 2);
    }
  }
  __host__ __device__ static int plane(int s, int V) {
    return s <= VS_EXT_SUM_LAM ? V : (s <= VS_DYN_F2V_LAM ? V - 1 : V - 2);
  }
};

// Where staged field s starts, in rows of T robots.
template <class L>
__host__ __device__ __forceinline__ int staged_offset(int s, int V) {
  int rows = 0;
  for (int i = 0; i < s; ++i) rows += L::rows(i, V);
  return rows;
}

// Shared memory of a block of `tile` robots, and the robots per block at V:
// the largest power of two up to kMaxTile whose staged inputs fit (0 where
// not even one robot's do).
template <class L>
size_t staged_smem(int V, int tile) {
  return sizeof(float) * (size_t)tile * staged_offset<L>(L::kCount, V);
}
template <class L>
int staged_tile(int V) {
  for (int tile = kMaxTile; tile >= 1; tile /= 2)
    if (staged_smem<L>(V, tile) <= kMaxSmem) return tile;
  return 0;
}

// 16-byte copies where R % 4 == 0 and every staged plane is 16-byte aligned.
template <class L>
int staged_vec16(const void* const* in, int R) {
  int ok = R % 4 == 0;
  for (int s = 0; s < L::kCount; ++s) ok = ok && reinterpret_cast<size_t>(in[L::field(s)]) % 16 == 0;
  return ok;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool copy) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = copy ? 4 : 0;   // 0: no read, the destination is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of staged fields [s_begin, s_end) of list L (inputs `in`)
// of the tile's T robots from r0 as one cp.async group; threads take
// consecutive elements. A whole tile of aligned planes goes in 16-byte
// pieces, else element by element (zero-filled past the robot edge).
template <class L, int T>
__device__ __forceinline__ void stage(const void* const* in, const SlotScalars& S, float* smem,
                                      int s_begin, int s_end, int r0, int tid, int nthreads) {
  const int V = S.V, R = S.R;
  const bool vec = T % 4 == 0 && S.vec16 && r0 + T <= R;
  float* dst = smem + T * staged_offset<L>(s_begin, V);
  for (int s = s_begin; s < s_end; ++s) {
    const float* src = static_cast<const float*>(in[L::field(s)]);
    const int n = L::rows(s, V) * T;
    if (vec) {
      for (int j = tid; j < n / 4; j += nthreads) {
        const int row = j / (T / 4), q = 4 * (j % (T / 4));
        cp_async16(dst + row * T + q, src + (size_t)row * R + r0 + q);
      }
    } else {
      for (int j = tid; j < n; j += nthreads) {
        const int row = j / T, r = r0 + j % T;
        const bool copy = r < R;
        cp_async4(dst + j, src + (copy ? (size_t)row * R + r : 0), copy);
      }
    }
    dst += n;
  }
  cp_async_commit();
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
// symmetrised; a message with any non-finite entry is empty. front is
// b (x) I2 for the 2x2 scalars b (`front_b`), tail is [[1, tau], [0, 1]] (x)
// I2, so the two products with them skip the structural zeros: for finite
// operands the skipped terms are +-0 and the sums are the dense ones'; a
// non-finite inverse or cavity reaches the message through a nonzero term
// (every entry of front_b is nonzero), and the finite check empties it,
// as the dense products' NaN would.
__device__ __forceinline__ void dyn_message(
    const float front_b[2][2], const float mid[4][4], const float cav_eta[4],
    const float cav_lam[4][4], float tau, float eta[4], float lam[4][4]) {
  float m[4][4], t[4][4], s[4][4], ct[4][4], l[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) m[i][j] = mid[i][j] + cav_lam[i][j];
  inv4_rowscaled(m, t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = i % 2;   // row i of front: b[i / 2][0] at column c, b[i / 2][1] at c + 2
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = front_b[i / 2][0] * t[c][j] + front_b[i / 2][1] * t[c + 2][j];
    ct[i][0] = cav_lam[i][0];
    ct[i][1] = cav_lam[i][1];
    ct[i][2] = cav_lam[i][0] * tau + cav_lam[i][2];
    ct[i][3] = cav_lam[i][1] * tau + cav_lam[i][3];
  }
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

// A factor-to-variable message in information form.
struct Msg {
  float eta[4], lam[4][4];
};

__device__ __forceinline__ void load_msg(Msg& m, const Plane& eta, const Plane& lam, int c0, int p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m.eta[i] = eta(c0 + i, p);
#pragma unroll
    for (int j = 0; j < 4; ++j) m.lam[i][j] = lam(4 * c0 + 4 * i + j, p);
  }
}

__device__ __forceinline__ void store_msg(const Msg& m, const OutPlane& eta, const OutPlane& lam,
                                          int c0, int p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    eta(c0 + i, p) = m.eta[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) lam(4 * c0 + 4 * i + j, p) = m.lam[i][j];
  }
}

// ---------------------------------------------------------- factor messages ---

// The message of dynamic factor e (variables e, e+1) to its variable in
// `slot` (0: variable e, 1: variable e+1), from the cavity on the other
// variable; the input message where the factor is off. Written and returned.
__device__ Msg dynamic_message(const SlotArgs& A, const SPlane& delta_t, const SPlane& v2f_eta,
                               const SPlane& v2f_lam, int r, int e, int slot, bool on) {
  const SlotScalars& S = A.s;
  const int V1 = S.V - 1;
  Msg m;
  if (!on) {
    load_msg(m, in_plane(A.in[DYN_F2V_ETA], V1, S, r), in_plane(A.in[DYN_F2V_LAM], V1, S, r),
             4 * slot, e);
  } else {
    const float dt = delta_t(0, e);
    const float q11 = S.dyn_c11 / (dt * dt * dt);
    const float q12 = S.dyn_c12 / (dt * dt);
    const float q22 = S.dyn_c22 / dt;
    const float s1 = dt * q11 + q12;
    const float s2 = dt * q12 + q22;
    const float qa = q11 * dt + q12, qb = q12 * dt + q22;
    float mid[4][4], cav_eta[4], cav_lam[4][4];
    const int other = 4 * (1 - slot);   // the cavity's v2f slot
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cav_eta[i] = v2f_eta(other + i, e);
#pragma unroll
      for (int j = 0; j < 4; ++j) cav_lam[i][j] = v2f_lam(4 * other + 4 * i + j, e);
    }
    // slot 0 (to variable e): Phi^T Q^-1, Q^-1, Phi; slot 1 (to e+1):
    // Q^-1 Phi, Phi^T Q^-1 Phi, Phi^-1. Selected, not branched, so that the
    // two slots' threads of a warp run one path.
    const bool s0 = slot == 0;
    const float front[2][2] = {{q11, s0 ? q12 : qa}, {s0 ? qa : q12, qb}};
    expand2(q11, s0 ? q12 : qa, s0 ? q12 : s1, s0 ? q22 : s1 * dt + s2, mid);
    dyn_message(front, mid, cav_eta, cav_lam, s0 ? dt : -dt, m.eta, m.lam);
  }
  store_msg(m, out_plane(A.out[O_DYN_F2V_ETA], V1, S, r), out_plane(A.out[O_DYN_F2V_LAM], V1, S, r),
            4 * slot, e);
  return m;
}

// One SDF sample at world position (px, py), as factors.obstacle_taps
// computes it: world -> pixel, a truncating cast after the negative-
// saturating clamp, the index clamped to the image, 0 past the far edge.
__device__ __forceinline__ float sdf_tap(const SlotArgs& A, float px, float py) {
  const SlotScalars& S = A.s;
  const float xf = (px + S.half_ww) * S.x_scale;
  const float yf = (-py + S.half_wh) * S.y_scale;
  const int xi = static_cast<int>(fminf(floorf(fmaxf(xf, 0.f)), static_cast<float>(S.sdf_w - 1)));
  const int yi = static_cast<int>(fminf(floorf(fmaxf(yf, 0.f)), static_cast<float>(S.sdf_h - 1)));
  const bool inside = xf < static_cast<float>(S.sdf_w) && yf < static_cast<float>(S.sdf_h);
  return inside ? 1.f - __ldg(A.sdf + (size_t)yi * S.sdf_w + xi) : 0.f;
}

// Obstacle factor k (on variable k+1): its three SDF taps at the
// linearisation point, then the message; the input message where off.
__device__ Msg obstacle_message(const SlotArgs& A, const SPlane& mu, int r, int k, bool gate) {
  const SlotScalars& S = A.s;
  const int V2 = S.V - 2;
  Msg m;
  if (!(S.obstacle_enabled && gate)) {
    load_msg(m, in_plane(A.in[OBS_F2V_ETA], V2, S, r), in_plane(A.in[OBS_F2V_LAM], V2, S, r), 0, k);
  } else {
    const float x = mu(0, k), y = mu(1, k);
    const float h0 = sdf_tap(A, x, y);
    const float jx = (sdf_tap(A, x + S.tap_delta, y) - h0) / S.obs_delta;
    const float jy = (sdf_tap(A, x, y + S.tap_delta) - h0) / S.obs_delta;
    const float jx0 = jx * x + jy * y;
    const float scale = S.obs_lam * (jx0 - h0);
    const float J[4] = {jx, jy, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m.eta[i] = J[i] * scale;
#pragma unroll
      for (int j = 0; j < 4; ++j) m.lam[i][j] = S.obs_lam * J[i] * J[j];
    }
  }
  store_msg(m, out_plane(A.out[O_OBS_F2V_ETA], V2, S, r), out_plane(A.out[O_OBS_F2V_LAM], V2, S, r),
            0, k);
  return m;
}

// Tracking factor k (on variable k+1): factors.tracking_factor_messages.
// Writes the message and the factor's record, timeout and last measurement.
__device__ Msg tracking_message(const SlotArgs& A, int r, int k, bool tgate) {
  const SlotScalars& S = A.s;
  const int V2 = S.V - 2;
  Plane last_pos = in_plane(A.in[TRK_LAST_POS], V2, S, r);
  OutPlane o_last_pos = out_plane(A.out[O_TRK_LAST_POS], V2, S, r);
  float& o_last_val = out_plane(A.out[O_TRK_LAST_VAL], V2, S, r)(0, k);
  int* o_record = static_cast<int*>(A.out[O_TRK_RECORD]) + (size_t)k * S.R + r;
  int* o_timeout = static_cast<int*>(A.out[O_TRK_TIMEOUT]) + (size_t)k * S.R + r;
  const int rec_in = ld_int(A.in[TRK_RECORD], S, k, r);
  const int timeout = ld_int(A.in[TRK_TIMEOUT], S, k, r);
  const float old_val = in_plane(A.in[TRK_LAST_VAL], V2, S, r)(0, k);
  Msg m;

  if (!(S.tracking_enabled && tgate)) {
    load_msg(m, in_plane(A.in[TRK_F2V_ETA], V2, S, r), in_plane(A.in[TRK_F2V_LAM], V2, S, r), 0, k);
    *o_record = rec_in;
    *o_timeout = timeout;
    o_last_pos(0, k) = last_pos(0, k);
    o_last_pos(1, k) = last_pos(1, k);
    o_last_val = old_val;
  } else {
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
      m.eta[i] = skipped ? 0.f : J[i] * scale;
#pragma unroll
      for (int j = 0; j < 4; ++j) m.lam[i][j] = skipped ? 0.f : S.trk_lam * J[i] * J[j];
    }
    *o_record = skipped ? rec_in : new_record;
    *o_timeout = timed_out ? timeout - 1 : (timeout == 0 ? -1 : timeout);
    o_last_pos(0, k) = skipped ? last_pos(0, k) : mpx;
    o_last_pos(1, k) = skipped ? last_pos(1, k) : mpy;
    o_last_val = skipped ? old_val : h0;
  }
  store_msg(m, out_plane(A.out[O_TRK_F2V_ETA], V2, S, r), out_plane(A.out[O_TRK_F2V_LAM], V2, S, r),
            0, k);
  return m;
}

// ---------------------------------------------------------- belief update ---

struct Belief {
  float eta[4], lam[4][4], mean[4];
};

// The guarded belief update from a summed eta / precision, for the two
// halves of a (robot, variable) pair, which hold the same eta / precision:
// each half forms two columns of the row-scaled inverse (half 0 columns 0-1,
// half 1 columns 2-3, by inv4_rowscaled's formulas) and the pair swaps them
// by warp shuffles over `mask`, so both end with inv4_rowscaled's
// covariance, bit for bit. The guards: "precision not zero", det != 0,
// finite and residual ||lam cov - I|| < 1e-4, each half checking its own
// columns and the pair combining the two (a max is exact in any order);
// the mean falls back to the old one where a guard fails.
template <class OldMean>
__device__ __forceinline__ Belief solve_belief_pair(const float eta[4], const float lam[4][4],
                                                    int half, unsigned mask, OldMean old_mean) {
  float d[4], a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float rm = fmaxf(fmaxf(fabsf(lam[i][0]), fabsf(lam[i][1])),
                           fmaxf(fabsf(lam[i][2]), fabsf(lam[i][3])));
    d[i] = rm > 0.f ? 1.f / rm : 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = lam[i][j] * d[i];
  }
  const float c01 = a[0][0] * a[1][1] - a[0][1] * a[1][0];
  const float c02 = a[0][0] * a[1][2] - a[0][2] * a[1][0];
  const float c03 = a[0][0] * a[1][3] - a[0][3] * a[1][0];
  const float c12 = a[0][1] * a[1][2] - a[0][2] * a[1][1];
  const float c13 = a[0][1] * a[1][3] - a[0][3] * a[1][1];
  const float c23 = a[0][2] * a[1][3] - a[0][3] * a[1][2];
  const float d01 = a[2][0] * a[3][1] - a[2][1] * a[3][0];
  const float d02 = a[2][0] * a[3][2] - a[2][2] * a[3][0];
  const float d03 = a[2][0] * a[3][3] - a[2][3] * a[3][0];
  const float d12 = a[2][1] * a[3][2] - a[2][2] * a[3][1];
  const float d13 = a[2][1] * a[3][3] - a[2][3] * a[3][1];
  const float d23 = a[2][2] * a[3][3] - a[2][3] * a[3][2];
  const float det = c01 * d23 - c02 * d13 + c03 * d12 + c12 * d03 - c13 * d02 + c23 * d01;
  const float safe_det = det == 0.f ? 1.f : det;
  // this half's two columns of the adjugate: columns 0-1 are rows 1 and 0
  // of the scaled matrix against the minors of rows 2-3, columns 2-3 the
  // same formulas with rows 3 and 2 against the minors of rows 0-1
  const bool h0 = half == 0;
  float p[4], q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j] = h0 ? a[1][j] : a[3][j];
    q[j] = h0 ? a[0][j] : a[2][j];
  }
  const float m01 = h0 ? d01 : c01, m02 = h0 ? d02 : c02, m03 = h0 ? d03 : c03;
  const float m12 = h0 ? d12 : c12, m13 = h0 ? d13 : c13, m23 = h0 ? d23 : c23;
  const float adj[4][2] = {
      {p[1] * m23 - p[2] * m13 + p[3] * m12, -q[1] * m23 + q[2] * m13 - q[3] * m12},
      {-p[0] * m23 + p[2] * m03 - p[3] * m02, q[0] * m23 - q[2] * m03 + q[3] * m02},
      {p[0] * m13 - p[1] * m03 + p[3] * m01, -q[0] * m13 + q[1] * m03 - q[3] * m01},
      {-p[0] * m12 + p[1] * m02 - p[2] * m01, q[0] * m12 - q[1] * m02 + q[2] * m01}};
  float mine[4][2], cov[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      mine[i][jj] = adj[i][jj] / safe_det * (h0 ? d[jj] : d[2 + jj]);
      const float other = __shfl_xor_sync(mask, mine[i][jj], 1);
      cov[i][jj] = h0 ? mine[i][jj] : other;
      cov[i][2 + jj] = h0 ? other : mine[i][jj];
    }
  bool pnz = false;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) pnz = pnz || lam[i][j] > 1e-6f;
  float resid = 0.f;   // over this half's columns j = 2 half + jj
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      // exact products, summed in double (the rounding note at the top)
      double acc = static_cast<double>(lam[i][0]) * mine[0][jj];
#pragma unroll
      for (int k = 1; k < 4; ++k) acc += static_cast<double>(lam[i][k]) * mine[k][jj];
      resid = fmaxf(resid, static_cast<float>(fabs(acc - (i == 2 * half + jj ? 1.0 : 0.0))));
      finite = finite && isfinite(mine[i][jj]);
    }
  resid = fmaxf(resid, __shfl_xor_sync(mask, resid, 1));
  finite = __shfl_xor_sync(mask, static_cast<int>(finite), 1) != 0 && finite;
  const bool valid = pnz && det != 0.f && finite && resid < 1e-4f;
  float mean[4];
  matvec4(cov, eta, mean);
  Belief b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b.eta[i] = eta[i];
    b.mean[i] = valid ? mean[i] : old_mean(i);
#pragma unroll
    for (int j = 0; j < 4; ++j) b.lam[i][j] = lam[i][j];
  }
  return b;
}

__device__ __forceinline__ Belief old_belief(const Plane& eta, const Plane& lam, const Plane& mean,
                                             int v) {
  Belief b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b.eta[i] = eta(i, v);
    b.mean[i] = mean(i, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) b.lam[i][j] = lam(4 * i + j, v);
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

__device__ __forceinline__ void add_msg(float eta[4], float lam[4][4], const Msg& m) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    eta[i] += m.eta[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) lam[i][j] += m.lam[i][j];
  }
}

// The response of variable v to dynamic factor e in `slot` (belief less the
// factor's message to v, and the belief mean), or the input v2f message
// where the variable does not respond.
__device__ __forceinline__ void dynamic_response(const SlotArgs& A, const SPlane& v2f_eta,
                                                 const SPlane& v2f_lam, int r, int e, int slot,
                                                 bool respond, const Belief& b, const Msg& m) {
  const SlotScalars& S = A.s;
  const int V1 = S.V - 1;
  OutPlane o_eta = out_plane(A.out[O_DYN_V2F_ETA], V1, S, r);
  OutPlane o_lam = out_plane(A.out[O_DYN_V2F_LAM], V1, S, r);
  OutPlane o_mu = out_plane(A.out[O_DYN_V2F_MU], V1, S, r);
  if (respond) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o_eta(4 * slot + i, e) = b.eta[i] - m.eta[i];
      o_mu(4 * slot + i, e) = b.mean[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) o_lam(16 * slot + 4 * i + j, e) = b.lam[i][j] - m.lam[i][j];
    }
    return;
  }
  Plane v2f_mu = in_plane(A.in[DYN_V2F_MU], V1, S, r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o_eta(4 * slot + i, e) = v2f_eta(4 * slot + i, e);
    o_mu(4 * slot + i, e) = v2f_mu(4 * slot + i, e);
#pragma unroll
    for (int j = 0; j < 4; ++j) o_lam(16 * slot + 4 * i + j, e) = v2f_lam(16 * slot + 4 * i + j, e);
  }
}

// ----------------------------------------------------------------- kernels ---

// Swap a message with the partner lane (lane ^ 1) of the same robot and
// variable; every lane of `mask` takes part.
__device__ __forceinline__ Msg swap_partner(const Msg& m, unsigned mask) {
  Msg o;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o.eta[i] = __shfl_xor_sync(mask, m.eta[i], 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) o.lam[i][j] = __shfl_xor_sync(mask, m.lam[i][j], 1);
  }
  return o;
}

// Block: threadIdx.x = 2 * (robot in the tile) + half, threadIdx.y = chain
// position. The two halves of a (robot, variable v) pair split the messages
// to v (half 0: dynamic factor v's slot 0 and the obstacle factor; half 1:
// dynamic factor v-1's slot 1 and the tracking factor), swap them by warp
// shuffles, both run the belief update, and split the writes (half 0: belief,
// the response to factor v, the obstacle's v2f mean; half 1: snapshot, the
// response to factor v-1, the tracking v2f mean).
template <int T>
__global__ void __launch_bounds__(kMaxSlotThreads) internal_slot_kernel(SlotArgs A) {
  extern __shared__ float smem[];
  const SlotScalars& S = A.s;
  const int V = S.V, V1 = V - 1, V2 = V - 2;
  const int half = threadIdx.x & 1, lr = threadIdx.x >> 1, ny = blockDim.y;
  const int nthreads = blockDim.x * ny, tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.x * T;
  // the lanes of this thread's warp (the block's last warp may be partial)
  const int warp_lanes = min(32, nthreads - (tid & ~31));
  const unsigned mask = warp_lanes == 32 ? 0xffffffffu : (1u << warp_lanes) - 1u;

  // 1. the tile's inputs in flight at once, in two groups
  stage<InternalStaging, T>(A.in, S, smem, 0, S_PRIOR_MEAN, r0, tid, nthreads);
  stage<InternalStaging, T>(A.in, S, smem, S_PRIOR_MEAN, N_STAGED, r0, tid, nthreads);

  const int r = r0 + lr;
  const bool live = r < S.R;
  const int rr = live ? r : 0;   // a safe robot index for address arithmetic
  const bool gate = live && __ldg(static_cast<const float*>(A.in[GATE]) + rr) > 0.f;
  const bool tgate = live && __ldg(static_cast<const float*>(A.in[TGATE]) + rr) > 0.f;
  auto staged = [&](int s) {
    return SPlane{smem + T * staged_offset<InternalStaging>(s, V), InternalStaging::plane(s, V),
                  T, lr};
  };
  const SPlane delta_t = staged(S_DELTA_T), v2f_eta = staged(S_DYN_V2F_ETA);
  const SPlane v2f_lam = staged(S_DYN_V2F_LAM), obs_mu = staged(S_OBS_V2F_MU);
  const SPlane prior_mean = staged(S_PRIOR_MEAN), prior_sigma = staged(S_PRIOR_SIGMA);
  const SPlane ext_eta = staged(S_EXT_SUM_ETA), ext_lam = staged(S_EXT_SUM_LAM);
  const bool dyn_on = S.dynamic_enabled && gate;

  cp_async_wait<1>();
  __syncthreads();
  // Passes over the chain of uniform trip count (one at V <= 512 / 2T), so
  // every thread meets the barrier of the first and the shuffles.
  for (int v0 = 0; v0 < V; v0 += ny) {
    const int v = v0 + threadIdx.y;
    const bool act = live && v < V;
    const bool interior = v >= 1 && v <= V2;
    // 2. this half's messages to variable v
    const int e = v - half;   // this half's dynamic factor, in slot `half`
    const bool has_dyn = e >= 0 && e < V1;
    Msg md = {}, mf = {};
    if (act) {
      if (has_dyn) md = dynamic_message(A, delta_t, v2f_eta, v2f_lam, rr, e, half, dyn_on);
      if (interior)
        mf = half == 0 ? obstacle_message(A, obs_mu, rr, v - 1, gate)
                       : tracking_message(A, rr, v - 1, tgate);
    }
    if (v0 == 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    const Msg od = swap_partner(md, mask), of = swap_partner(mf, mask);
    // the pairs that solve a belief below, both halves of each (they share
    // robot and variable), for the shuffles in solve_belief_pair
    const unsigned solving = __ballot_sync(mask, act && gate);
    if (!act) continue;
    // m0: dynamic factor v, slot 0; m1: dynamic factor v-1, slot 1; mi:
    // obstacle + tracking (either order: a float sum of two commutes)
    Msg m0, m1, mi;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m0.eta[i] = half == 0 ? md.eta[i] : od.eta[i];
      m1.eta[i] = half == 0 ? od.eta[i] : md.eta[i];
      mi.eta[i] = mf.eta[i] + of.eta[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        m0.lam[i][j] = half == 0 ? md.lam[i][j] : od.lam[i][j];
        m1.lam[i][j] = half == 0 ? od.lam[i][j] : md.lam[i][j];
        mi.lam[i][j] = mf.lam[i][j] + of.lam[i][j];
      }
    }

    // 3. the belief update (both halves), snapshot and responses of v
    Plane belief_mean = in_plane(A.in[BELIEF_MEAN], V, S, rr);
    Belief b;
    if (!gate) {
      b = old_belief(in_plane(A.in[BELIEF_ETA], V, S, rr), in_plane(A.in[BELIEF_LAM], V, S, rr),
                     belief_mean, v);
    } else {
      const float ps = prior_sigma(0, v);
      float eta[4], lam[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        eta[i] = ps * prior_mean(i, v) + ext_eta(i, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) lam[i][j] = (i == j ? ps : 0.f) + ext_lam(4 * i + j, v);
      }
      if (v < V1) add_msg(eta, lam, m0);
      if (v >= 1) add_msg(eta, lam, m1);
      if (interior) add_msg(eta, lam, mi);   // obstacle + tracking, one term
      b = solve_belief_pair(eta, lam, half, solving, [&](int i) { return belief_mean(i, v); });
    }
    // half 0 writes the belief, half 1 the snapshot (the same values), each
    // its response to its dynamic factor (belief less its own message) and
    // its interior factor's v2f mean
    const int o = half == 0 ? O_BELIEF_ETA : O_SNAP_ETA;   // then lam, mean
    store_belief(b, out_plane(A.out[o], V, S, rr), out_plane(A.out[o + 1], V, S, rr),
                 out_plane(A.out[o + 2], V, S, rr), v);
    if (has_dyn) dynamic_response(A, v2f_eta, v2f_lam, rr, e, half, dyn_on, b, md);
    if (interior) {
      const int k = v - 1;
      const bool on = gate && (half == 0 ? S.obstacle_enabled : S.tracking_enabled);
      Plane trk_mu = in_plane(A.in[TRK_V2F_MU], V2, S, rr);
      OutPlane o_mu = out_plane(A.out[half == 0 ? O_OBS_V2F_MU : O_TRK_V2F_MU], V2, S, rr);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o_mu(i, k) = on ? b.mean[i] : (half == 0 ? obs_mu(i, k) : trk_mu(i, k));
    }
  }
}

// Block: threadIdx.x = 2 * (robot in the tile) + half, threadIdx.y = chain
// position, as in the internal slot. Both halves of a (robot, variable v)
// pair sum the staged terms and run the belief inverse, each forming two of
// its columns; half 0 writes eta and rows 0-1 of the precision, half 1 the
// mean and rows 2-3. A gated-off robot copies its old belief, each half the
// entries it writes, from device memory.
template <int T>
__global__ void __launch_bounds__(kMaxSlotThreads) variable_slot_kernel(VarArgs A) {
  extern __shared__ float smem[];
  const SlotScalars& S = A.s;
  const int V = S.V, V1 = V - 1, V2 = V - 2;
  const int half = threadIdx.x & 1, lr = threadIdx.x >> 1, ny = blockDim.y;
  const int nthreads = blockDim.x * ny, tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.x * T;
  const int warp_lanes = min(32, nthreads - (tid & ~31));
  const unsigned mask = warp_lanes == 32 ? 0xffffffffu : (1u << warp_lanes) - 1u;

  // every term of the belief sums in flight at once, one group
  stage<VariableStaging, T>(A.in, S, smem, 0, N_VAR_STAGED, r0, tid, nthreads);

  const int r = r0 + lr;
  const bool live = r < S.R;
  const int rr = live ? r : 0;   // a safe robot index for address arithmetic
  const bool gate = live && __ldg(static_cast<const float*>(A.in[V_GATE]) + rr) > 0.f;
  auto staged = [&](int s) {
    return SPlane{smem + T * staged_offset<VariableStaging>(s, V), VariableStaging::plane(s, V),
                  T, lr};
  };
  const SPlane prior_mean = staged(VS_PRIOR_MEAN), prior_sigma = staged(VS_PRIOR_SIGMA);
  const SPlane ext_eta = staged(VS_EXT_SUM_ETA), ext_lam = staged(VS_EXT_SUM_LAM);
  const SPlane dyn_eta = staged(VS_DYN_F2V_ETA), dyn_lam = staged(VS_DYN_F2V_LAM);
  const SPlane obs_eta = staged(VS_OBS_F2V_ETA), obs_lam = staged(VS_OBS_F2V_LAM);
  const SPlane trk_eta = staged(VS_TRK_F2V_ETA), trk_lam = staged(VS_TRK_F2V_LAM);
  // this half's planes: eta (half 0) or mean (half 1), and rows 2 half, 2 half + 1
  void* const o_vec = half == 0 ? A.out[VO_BELIEF_ETA] : A.out[VO_BELIEF_MEAN];
  const void* const i_vec = half == 0 ? A.in[V_BELIEF_ETA] : A.in[V_BELIEF_MEAN];
  const int row0 = 8 * half;   // first precision entry of this half's rows

  cp_async_wait<0>();
  __syncthreads();
  // Passes over the chain of uniform trip count, so every thread meets the
  // ballot (and its pair the shuffles of the inverse).
  for (int v0 = 0; v0 < V; v0 += ny) {
    const int v = v0 + threadIdx.y;
    const bool act = live && v < V;
    const unsigned solving = __ballot_sync(mask, act && gate);
    if (!act) continue;
    OutPlane out_vec = out_plane(o_vec, V, S, rr);
    OutPlane out_lam = out_plane(A.out[VO_BELIEF_LAM], V, S, rr);
    if (!gate) {   // the old belief passes through
      Plane old_vec = in_plane(i_vec, V, S, rr), old_lam = in_plane(A.in[V_BELIEF_LAM], V, S, rr);
#pragma unroll
      for (int i = 0; i < 4; ++i) out_vec(i, v) = old_vec(i, v);
#pragma unroll
      for (int c = 0; c < 8; ++c) out_lam(row0 + c, v) = old_lam(row0 + c, v);
      continue;
    }
    // prior + external sum, then dynamic factor v's slot 0, dynamic factor
    // v-1's slot 1, obstacle + tracking factor v-1 as one term: the order
    // in which the Pallas kernel adds them
    const float ps = prior_sigma(0, v);
    float eta[4], lam[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      eta[i] = ps * prior_mean(i, v) + ext_eta(i, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) lam[i][j] = (i == j ? ps : 0.f) + ext_lam(4 * i + j, v);
    }
    if (v < V1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        eta[i] += dyn_eta(i, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) lam[i][j] += dyn_lam(4 * i + j, v);
      }
    }
    if (v >= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        eta[i] += dyn_eta(4 + i, v - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) lam[i][j] += dyn_lam(16 + 4 * i + j, v - 1);
      }
    }
    if (v >= 1 && v <= V2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        eta[i] += obs_eta(i, v - 1) + trk_eta(i, v - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          lam[i][j] += obs_lam(4 * i + j, v - 1) + trk_lam(4 * i + j, v - 1);
      }
    }
    Plane old_mean = in_plane(A.in[V_BELIEF_MEAN], V, S, rr);
    const Belief b = solve_belief_pair(eta, lam, half, solving,
                                       [&](int i) { return old_mean(i, v); });
#pragma unroll
    for (int i = 0; i < 4; ++i) out_vec(i, v) = half == 0 ? b.eta[i] : b.mean[i];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out_lam(row0 + 4 * ii + j, v) = half == 0 ? b.lam[ii][j] : b.lam[2 + ii][j];
  }
}

// Launch a staged kernel (list L) with tiles of T robots: a block of 2T
// threads (two per robot) times as many chain positions as kMaxSlotThreads
// allows, one block per tile, the staged inputs in dynamic shared memory.
template <class L, int T, class Args>
int launch_staged(void (*kernel)(Args), const Args& a, cudaStream_t stream) {
  const int V = a.s.V;
  const size_t smem = staged_smem<L>(V, T);
  static size_t smem_set = 48 * 1024;   // the attribute, once it exceeds the default
  if (smem > smem_set) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    smem_set = smem;
  }
  const int max_ny = kMaxSlotThreads / (2 * T);
  const dim3 block(2 * T, V < max_ny ? V : max_ny);
  const dim3 grid((a.s.R + T - 1) / T);
  kernel<<<grid, block, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

SlotScalars scalars(int R, int V, int W, const float* f, const int* flags) {
  SlotScalars s = {};
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
// `f` holds the float scalars in SlotScalars order (dyn_c11 ..
// attraction_distance, then for the internal slot half_ww, half_wh, x_scale,
// y_scale, tap_delta) and `flags` the 3 enable flags. The internal slot also
// takes the SDF image [sdf_h, sdf_w]. The robots per block are
// gbp_internal_tile(V) and gbp_variable_tile(V) (0: no tile fits). A kernel
// runs on `stream` and is not waited for. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape no tile fits.
extern "C" int gbp_internal_tile(int V) { return staged_tile<InternalStaging>(V); }
extern "C" int gbp_variable_tile(int V) { return staged_tile<VariableStaging>(V); }

extern "C" int gbp_internal_slot(const void* const* in, void* const* out, const void* sdf,
                                 int R, int V, int W, int sdf_h, int sdf_w, const float* f,
                                 const int* flags, void* stream) {
  SlotArgs a;
  for (int i = 0; i < N_IN; ++i) a.in[i] = in[i];
  for (int i = 0; i < N_OUT; ++i) a.out[i] = out[i];
  a.sdf = static_cast<const float*>(sdf);
  a.s = scalars(R, V, W, f, flags);
  a.s.sdf_h = sdf_h;
  a.s.sdf_w = sdf_w;
  a.s.half_ww = f[9];
  a.s.half_wh = f[10];
  a.s.x_scale = f[11];
  a.s.y_scale = f[12];
  a.s.tap_delta = f[13];
  a.s.vec16 = staged_vec16<InternalStaging>(a.in, R);
  if (V < 3) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using L = InternalStaging;
  switch (staged_tile<L>(V)) {
    case 8: return launch_staged<L, 8>(internal_slot_kernel<8>, a, s);
    case 4: return launch_staged<L, 4>(internal_slot_kernel<4>, a, s);
    case 2: return launch_staged<L, 2>(internal_slot_kernel<2>, a, s);
    case 1: return launch_staged<L, 1>(internal_slot_kernel<1>, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gbp_variable_slot(const void* const* in, void* const* out, int R, int V,
                                 const float* f, const int* flags, void* stream) {
  VarArgs a;
  for (int i = 0; i < N_VAR_IN; ++i) a.in[i] = in[i];
  for (int i = 0; i < N_VAR_OUT; ++i) a.out[i] = out[i];
  a.s = scalars(R, V, 0, f, flags);
  a.s.vec16 = staged_vec16<VariableStaging>(a.in, R);
  if (V < 3) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using L = VariableStaging;
  switch (staged_tile<L>(V)) {
    case 8: return launch_staged<L, 8>(variable_slot_kernel<8>, a, s);
    case 4: return launch_staged<L, 4>(variable_slot_kernel<4>, a, s);
    case 2: return launch_staged<L, 2>(variable_slot_kernel<2>, a, s);
    case 1: return launch_staged<L, 1>(variable_slot_kernel<1>, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gbp_slot_in_fields() { return N_IN; }
extern "C" int gbp_slot_out_fields() { return N_OUT; }
extern "C" int gbp_variable_in_fields() { return N_VAR_IN; }
extern "C" int gbp_variable_out_fields() { return N_VAR_OUT; }
