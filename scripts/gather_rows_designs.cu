// Designs of the row gather (out[m, :] = table[idx[m], :], 0 where mask[m]
// is false) beside magics_tpu_torch/kernels/csrc/layout.cu's, and its
// kernel with other stores, for scripts/gather_rows_designs.py to time on
// the card. 16-byte words only (every bench-shape table). Built with
// kernels/build.py's flags; each kernel's name holds "gather_rows", so the
// tick profiles of scripts/torch_tick_compare.py and chip_smoke.py count it
// as the gather.
//
//   design 0, "thread a word": layout.cu's kernel (thread t of a block copies
//     word t % words of row t / words, 256 / words whole rows a block, each
//     thread reading its row's index and mask byte itself), here for rows
//     of at most 256 words, with a choice of stores.
//   design 1, "lane groups": a group of 2^k lanes of a warp copies a row (k
//     <= 5, the group that copies the row in one pass of up to 8 words a
//     lane with the fewest word slots idle: 4 lanes for 20 words, 2 for 10,
//     8 for 40, a warp for 120 or more); lane j copies words j, j + 2^k, ...,
//     all its loads before its stores; lane r loads the index and mask of
//     the warp's row r once, which the group takes by __shfl_sync.
//   design 2, "flat runs": a warp copies a batch of 128 / words whole rows
//     (1 to 32) as one run of words (contiguous in the output), lane l
//     words l, l + 32, ..., 4 loads a lane before their stores, so one pass
//     a warp; lane k loads the index and mask of the batch's row k, which
//     the lanes take by __shfl_sync.
// Stores: evict 0 plain, 1 evict-first (st.global.cs).

// layout.cu's kernel (gather_rows_kernel, with its `stream` flag for the
// stores) and kThreads
#include "../magics_tpu_torch/kernels/csrc/layout.cu"

namespace {

using Word = uint4;
constexpr int kLaneUnroll = 8;   // lane groups: most loads a lane before its stores
constexpr int kFlatUnroll = 4;   // flat runs: loads a lane before its stores

__device__ __forceinline__ void put(Word* dst, Word v, bool evict) {
  if (evict) {
    __stcs(dst, v);
  } else {
    *dst = v;
  }
}

__global__ void __launch_bounds__(kThreads) gather_rows_lanes_kernel(
    const Word* __restrict__ table, const long long* __restrict__ idx,
    const unsigned char* __restrict__ mask, Word* __restrict__ out, long long n_out, int words,
    int log_g, bool evict) {
  const int lane = threadIdx.x & 31, rpw = 32 >> log_g, G = 1 << log_g;
  const long long first = ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * rpw;
  long long k_src = 0;
  int k_on = 0;
  if (lane < rpw && first + lane < n_out) {
    k_on = mask == nullptr || __ldg(mask + first + lane);
    if (k_on) k_src = __ldg(idx + first + lane);
  }
  const int r = lane >> log_g;
  const long long src = __shfl_sync(0xffffffffu, k_src, r);
  const bool on = __shfl_sync(0xffffffffu, k_on, r) != 0;
  const long long m = first + r;
  if (m >= n_out) return;
  const Word* from = table + src * words;
  Word* to = out + m * words;
  for (int w0 = lane & (G - 1); w0 < words; w0 += kLaneUnroll * G) {
    Word v[kLaneUnroll];
#pragma unroll
    for (int u = 0; u < kLaneUnroll; ++u) {
      v[u] = make_uint4(0, 0, 0, 0);
      if (on && w0 + u * G < words) v[u] = __ldg(from + w0 + u * G);
    }
#pragma unroll
    for (int u = 0; u < kLaneUnroll; ++u)
      if (w0 + u * G < words) put(to + w0 + u * G, v[u], evict);
  }
}

// log2 of the lane group: of 1, 2, ..., 32 lanes, the group that copies the
// row in one pass of at most kLaneUnroll words a lane with the fewest idle
// word slots (the larger on a tie); a warp for a wider row.
int lanes_log2(int words) {
  int best = 5;
  long long best_slots = -1;
  for (int lg = 0; lg <= 5; ++lg) {
    const long long per_lane = (words + (1LL << lg) - 1) >> lg;
    if (per_lane > kLaneUnroll) continue;
    const long long slots = per_lane << lg;
    if (best_slots < 0 || slots <= best_slots) {
      best = lg;
      best_slots = slots;
    }
  }
  return best;
}

__global__ void __launch_bounds__(kThreads) gather_rows_flat_kernel(
    const Word* __restrict__ table, const long long* __restrict__ idx,
    const unsigned char* __restrict__ mask, Word* __restrict__ out, long long n_out, int words,
    int rpw, bool evict) {
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * rpw;
  if (first >= n_out) return;
  const int rows = n_out - first < rpw ? static_cast<int>(n_out - first) : rpw;
  long long k_src = 0;
  int k_on = 0;
  if (lane < rows) {
    k_on = mask == nullptr || __ldg(mask + first + lane);
    if (k_on) k_src = __ldg(idx + first + lane);
  }
  Word* const run = out + first * words;
  const int n = rows * words;
  const int d_row = 32 / words, d_w = 32 - d_row * words;
  int row = lane / words, w = lane - row * words;
  for (int p0 = lane; p0 < n; p0 += 32 * kFlatUnroll) {
    Word v[kFlatUnroll];
#pragma unroll
    for (int u = 0; u < kFlatUnroll; ++u) {
      const long long src = __shfl_sync(0xffffffffu, k_src, row & 31);
      const bool on = __shfl_sync(0xffffffffu, k_on, row & 31) != 0;
      v[u] = make_uint4(0, 0, 0, 0);
      if (on && p0 + 32 * u < n) v[u] = __ldg(table + src * words + w);
      row += d_row;
      w += d_w;
      if (w >= words) {
        w -= words;
        ++row;
      }
    }
#pragma unroll
    for (int u = 0; u < kFlatUnroll; ++u)
      if (p0 + 32 * u < n) put(run + p0 + 32 * u, v[u], evict);
  }
}

}  // namespace

// The gather by `design` (0-2, above) with stores `evict` (0-1, above), on
// `stream`; arguments otherwise as layout.cu's gather_rows. Returns
// cudaErrorInvalidValue for what these designs do not take (a word under
// 16 bytes, a design 0 row wider than 256 words).
extern "C" int gather_rows_design(const void* table, const long long* idx,
                                  const unsigned char* mask, void* out, long long n_out,
                                  long long row_bytes, int design, int evict, void* stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(out) | static_cast<uintptr_t>(row_bytes);
  if (bits % 16 != 0 || row_bytes / 16 > 0x7fffffffLL || n_out <= 0 || row_bytes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = static_cast<int>(row_bytes / 16);
  const bool ev = evict != 0;
  const Word* t = static_cast<const Word*>(table);
  Word* o = static_cast<Word*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    if (words > kThreads) return static_cast<int>(cudaErrorInvalidValue);
    const long long rpb = kThreads / words;
    gather_rows_kernel<Word><<<static_cast<unsigned>((n_out + rpb - 1) / rpb),
                               static_cast<unsigned>(rpb * words), 0, s>>>(
        t, idx, mask, o, n_out, words, words, ev);
  } else if (design == 1) {
    const int log_g = lanes_log2(words);
    const long long rpb = (kThreads / 32) * (32 >> log_g);
    gather_rows_lanes_kernel<<<static_cast<unsigned>((n_out + rpb - 1) / rpb), kThreads, 0, s>>>(
        t, idx, mask, o, n_out, words, log_g, ev);
  } else if (design == 2) {
    const long long fit = 32 * kFlatUnroll / words;
    const int rpw = fit < 1 ? 1 : fit > 32 ? 32 : static_cast<int>(fit);
    const long long rpb = (kThreads / 32) * rpw;
    gather_rows_flat_kernel<<<static_cast<unsigned>((n_out + rpb - 1) / rpb), kThreads, 0, s>>>(
        t, idx, mask, o, n_out, words, rpw, ev);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
