// Hand-written Hopper (sm_90a) row gather: out[m, :] = table[idx[m], :],
// and where mask[m] is false old[m, :], or 0 without an old table.
//
// What it replaces
//   gather_rows_kernel  <- magics_tpu/kernels/layout.py:layout_pin (Pallas
//                          body _copy_kernel). On the TPU that kernel is an
//                          identity copy in 512-row tiles that pins XLA's
//                          row-major layout on both sides of the row gathers
//                          of the inter-robot exchanges, which XLA otherwise
//                          scalarises under the slot kernels' robot-minor
//                          layout. A CUDA tensor has no layout to pin; what
//                          those call sites need is the gather itself, so
//                          this kernel is that gather, made through
//                          exchange.gather_rows_pinned: the sender's delivery
//                          of the peers' outboxes by (peer, reciprocal
//                          slot), its response gather of the peers' belief
//                          positions and the receiver exchanges' gather of
//                          the peers' snapshot tables.
//                          With an old table it is also the select that
//                          follows the sender's two gathers (the old inbox,
//                          the old response positions where nothing was
//                          delivered), in the same launch.
//
// What bounds it on the H100. It moves bytes and computes nothing: per
// output row it reads one index (8 B), one mask byte and one table row, and
// writes one row. At the bench shapes (R=1024, K=32, V1=20, float32) the
// sender delivery reads and writes 10.5 MB each (32,768 rows of 320 B),
// 6.3 us at 3.35 TB/s; the response gather writes 5.2 MB (rows of 160 B
// out of a 0.16 MB table that stays in L2), 1.6 us; the receiver pack
// gather writes 62.9 MB (rows of 1,920 B out of a 2.0 MB table), 19 us;
// receiver_compact's table gather writes 21.0 MB (rows of 640 B out of a
// 0.66 MB table), 6.3 us. Memory-bound.
//
// What the design does about it. One thread copies one word of one output
// row: a block of up to 256 threads takes rpb = 256 / words whole rows (the
// delivery's 20-word rows 12 a block, the receiver pack's 120-word rows 2),
// or a 256-word slice of one row where a row is wider (blockIdx.y the
// slice). The word is 16 bytes when both row starts and the row size allow
// it (every bench-shape table), else the largest of 8, 4, 2 or 1 bytes that
// does (small test widths give rows that are not a multiple of 16 bytes).
//   - A thread's row and word come from one 32-bit division of its thread
//     number by the row's width; a row's base is one 64-bit multiply.
//   - Each thread reads its row's index and mask byte itself: the threads of
//     a warp ask for the same few addresses, one L1 request.
//   - A masked row is written as its old row, or as zeros, and its table
//     row is not read.
//   - An output larger than kStreamBytes is written with evict-first stores
//     (st.global.cs), which keep the table in L2: the receiver pack's 63 MB,
//     more than the 50 MB L2 holds, so its consumer reads it from HBM
//     whatever the stores. A smaller output is read by its consumer from L2
//     and gets plain stores: written evict-first, receiver_compact's 21 MB
//     table cost its consumer about as much device time per tick as
//     re-reading it from HBM.
// Why a word a thread: the designs that give a warp whole rows, with the
// row's index loaded once and shuffled and several loads a lane before its
// stores (lane groups of a power of two a row, or a batch of rows copied as
// one run of words; scripts/gather_rows_designs.cu), were no faster at the
// main path's three shapes in the bench ticks, by more than the spread
// between runs, once the consumer's device time is counted; the lane groups
// were slower there in some runs and on the response in repeated calls.
// They were faster with L2 flushed. The times of each, beside this
// kernel's and index_select's: PERF.md (scripts/gather_rows_designs.py).
// The callers clip the indexes, as the JAX call sites do: an index outside
// the table is not checked here. ptxas: chip_smoke.py prints it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // most threads a block
constexpr long long kStreamBytes = 32LL << 20;   // outputs above it: evict-first stores

template <typename W> __device__ __forceinline__ W zero_word() { return W(0); }
template <> __device__ __forceinline__ uint4 zero_word<uint4>() { return make_uint4(0, 0, 0, 0); }
template <> __device__ __forceinline__ uint2 zero_word<uint2>() { return make_uint2(0, 0); }

// Block (x, y): rows [x * rpb, (x + 1) * rpb), words [y * span, (y + 1) *
// span) of each; thread t copies word t % span of row t / span. span is the
// row's width, or kThreads for a wider row; rpb = kThreads / span.
template <typename W>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const W* __restrict__ table, const long long* __restrict__ idx,
    const unsigned char* __restrict__ mask, const W* __restrict__ old, W* __restrict__ out,
    long long n_out, int words, int span, bool stream) {
  const int t = threadIdx.x, r = t / span, w = blockIdx.y * span + (t - r * span);
  const long long m = (long long)blockIdx.x * (kThreads / span) + r;
  if (w >= words || m >= n_out) return;
  W v;
  if (mask == nullptr || __ldg(mask + m)) {
    v = __ldg(table + __ldg(idx + m) * words + w);
  } else {
    v = old != nullptr ? __ldg(old + m * words + w) : zero_word<W>();
  }
  W* dst = out + m * words + w;
  if (stream) {
    __stcs(dst, v);
  } else {
    *dst = v;
  }
}

// The largest word that divides the row size and the base addresses (old's
// where given).
int word_bytes(const void* table, const void* old, const void* out, long long row_bytes) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(old) |
                         reinterpret_cast<uintptr_t>(out) | static_cast<uintptr_t>(row_bytes);
  int word = 16;
  while (word > 1 && (bits % word) != 0) word /= 2;
  return word;
}

template <typename W>
int launch(const void* table, const long long* idx, const unsigned char* mask, const void* old,
           void* out, long long n_out, long long row_bytes, cudaStream_t stream) {
  const long long n_words = row_bytes / (long long)sizeof(W);
  if (n_words > 65535LL * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int words = static_cast<int>(n_words);
  const int span = words < kThreads ? words : kThreads;
  const int rpb = kThreads / span;
  const long long rows_blocks = (n_out + rpb - 1) / rpb;
  if (rows_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (words + span - 1) / span;
  gather_rows_kernel<W><<<dim3(static_cast<unsigned>(rows_blocks), slices), rpb * span, 0,
                          stream>>>(
      static_cast<const W*>(table), idx, mask, static_cast<const W*>(old), static_cast<W*>(out),
      n_out, words, span, n_out * row_bytes > kStreamBytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes (kernels/layout.py). `table` is a
// contiguous [n, row_bytes] byte matrix, `idx` n_out int64 row indexes in
// [0, n), `mask` n_out bools or null, `old` a contiguous [n_out, row_bytes]
// byte matrix or null (read only where `mask` is false), `out` a
// contiguous [n_out, row_bytes] byte matrix. The kernel runs on `stream`
// and is not waited for. Returns cudaGetLastError() after the launch;
// launches nothing when there is nothing to copy, and returns
// cudaErrorInvalidValue where the grid would be too large (more than
// 2^31 - 1 blocks of rows, or a row of more than 65,535 slices of 256
// words).
extern "C" int gather_rows(const void* table, const long long* idx, const unsigned char* mask,
                           const void* old, void* out, long long n_out, long long row_bytes,
                           void* stream) {
  if (n_out <= 0 || row_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes(table, old, out, row_bytes)) {
    case 16: return launch<uint4>(table, idx, mask, old, out, n_out, row_bytes, s);
    case 8: return launch<uint2>(table, idx, mask, old, out, n_out, row_bytes, s);
    case 4: return launch<unsigned int>(table, idx, mask, old, out, n_out, row_bytes, s);
    case 2: return launch<unsigned short>(table, idx, mask, old, out, n_out, row_bytes, s);
    default: return launch<unsigned char>(table, idx, mask, old, out, n_out, row_bytes, s);
  }
}

// The word size, in bytes, a gather of these buffers copies with (`old`
// may be null).
extern "C" int gather_rows_word_bytes(const void* table, const void* old, const void* out,
                                      long long row_bytes) {
  return word_bytes(table, old, out, row_bytes);
}
