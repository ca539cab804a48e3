// Hand-written Hopper (sm_90a) row gather: out[m, :] = table[idx[m], :],
// and 0 where mask[m] is false.
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
//                          tick._gather_rows_pinned: the sender's delivery
//                          of the peers' outboxes by (peer, reciprocal
//                          slot), its response gather of the peers' belief
//                          positions and the receiver exchanges' gather of
//                          the peers' snapshot tables.
//
// What bounds it on the H100. It moves bytes and computes nothing: per
// output row it reads one index (8 B), one mask byte and one table row, and
// writes one row. At the bench shapes (R=1024, K=32, V1=20, float32) the
// sender delivery reads and writes 10.5 MB each (32,768 rows of 320 B),
// 6.3 us at 3.35 TB/s; the response gather writes 5.2 MB (rows of 160 B
// out of a 0.16 MB table that stays in L2), 1.6 us; the receiver pack
// gather writes 62.9 MB (rows of 1,920 B out of a 2.0 MB table), 19 us;
// receiver_compact's table gather writes 21.0 MB (rows of 640 B out of a
// 0.66 MB table), 6.3 us.
// Memory-bound.
//
// What the design does about it. Each thread copies one word of one output
// row, threads of a warp on consecutive words, so a row is read and written
// in whole coalesced segments; the word is 16 bytes when both row starts
// and the row size allow it (every bench-shape table), else the largest of
// 8, 4, 2 or 1 bytes that does (small test widths give rows that are not a
// multiple of 16 bytes). A masked row is written as zeros without reading
// the table. The index and mask of a row are re-read by each of its
// threads; they stay in L1. The callers clip the indexes, as the JAX call
// sites do: an index outside the table is not checked here. A grid-stride
// loop bounds the grid. ptxas (nvcc 12.9, sm_90a): 16 registers for each
// word size, no spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

template <typename W> __device__ __forceinline__ W zero_word() { return W(0); }
template <> __device__ __forceinline__ uint4 zero_word<uint4>() { return make_uint4(0, 0, 0, 0); }
template <> __device__ __forceinline__ uint2 zero_word<uint2>() { return make_uint2(0, 0); }

template <typename W>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const W* __restrict__ table, const long long* __restrict__ idx,
    const unsigned char* __restrict__ mask, W* __restrict__ out, long long n_out,
    long long words) {
  const long long total = n_out * words;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const long long m = t / words;
    const long long w = t - m * words;
    W v = zero_word<W>();
    if (mask == nullptr || __ldg(mask + m)) v = __ldg(table + __ldg(idx + m) * words + w);
    out[t] = v;
  }
}

// The largest word that divides the row size and both base addresses.
int word_bytes(const void* table, const void* out, long long row_bytes) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(out) | static_cast<uintptr_t>(row_bytes);
  int word = 16;
  while (word > 1 && (bits % word) != 0) word /= 2;
  return word;
}

template <typename W>
void launch(const void* table, const long long* idx, const unsigned char* mask, void* out,
            long long n_out, long long row_bytes, cudaStream_t stream) {
  const long long words = row_bytes / (long long)sizeof(W);
  const long long total = n_out * words;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows_kernel<W><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const W*>(table), idx, mask, static_cast<W*>(out), n_out, words);
}

}  // namespace

// C entry points, loaded with ctypes (kernels/layout.py). `table` is a
// contiguous [n, row_bytes] byte matrix, `idx` n_out int64 row indexes in
// [0, n), `mask` n_out bools or null, `out` a contiguous [n_out, row_bytes]
// byte matrix. The kernel runs on `stream` and is not waited for. Returns
// cudaGetLastError() after the launch; launches nothing when there is
// nothing to copy.
extern "C" int gather_rows(const void* table, const long long* idx, const unsigned char* mask,
                           void* out, long long n_out, long long row_bytes, void* stream) {
  if (n_out <= 0 || row_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes(table, out, row_bytes)) {
    case 16: launch<uint4>(table, idx, mask, out, n_out, row_bytes, s); break;
    case 8: launch<uint2>(table, idx, mask, out, n_out, row_bytes, s); break;
    case 4: launch<unsigned int>(table, idx, mask, out, n_out, row_bytes, s); break;
    case 2: launch<unsigned short>(table, idx, mask, out, n_out, row_bytes, s); break;
    default: launch<unsigned char>(table, idx, mask, out, n_out, row_bytes, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The word size, in bytes, a gather of these buffers copies with.
extern "C" int gather_rows_word_bytes(const void* table, const void* out, long long row_bytes) {
  return word_bytes(table, out, row_bytes);
}
