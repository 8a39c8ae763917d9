// Mesh exchange kernel K6, written by hand for Hopper (sm_90a).
//
// Replaces daft_tpu/ops/pallas_kernels.py ring_permute_bits: the all-to-all
// of per-destination word blocks inside the repartition program. Contract:
// send is (n_src, n_dst, W) int32 words, block [s, d] being shard s's words
// for shard d; recv is (n_dst, n_src, W) with recv[d][s] = send[s][d], bit
// for bit.
//
// On the TPU each shard's kernel pushes its n - 1 outgoing blocks to its
// peers with remote DMAs over the interconnect, one ring step at a time. The
// port's mesh is n shard slots on one card, so every block already lies in
// the same device memory and the exchange is a block transpose: one launch
// moves all n^2 blocks, where the all_to_all tier makes n^2 copies per plane.
//
// Bound: memory. Every word is read once and written once, 2 x 4 x n^2 x W
// bytes (12.3 GB at the SF1 repartition cell, n = 8, W = 23 x 2^20 + 4:
// 3.7 ms at 3.35 TB/s). Design:
// - the grid's second dimension is the output block (d, s), so a thread
//   block finds its source block with no division per word; the first
//   dimension strides over the block's words;
// - each thread copies 16-byte vectors (int4) when W is a multiple of four
//   words and both buffers are 16-byte aligned (the repartition step pads W
//   so that it always is), single words otherwise; four loads are issued
//   before their stores, to keep enough bytes in flight;
// - every offset is 64-bit: at the SF1 cell n^2 x W is 1.5e9 words, and a
//   32-bit byte offset would overflow.
// Left for later: copying only each block's live prefix (the counts ride at
// the end of each block, so that needs a first pass or a layout change), and
// NVLink peer copies for a mesh over several cards.
//
// The launcher takes raw device pointers and the caller's stream, launches
// on that stream, never synchronises, allocates nothing (the wrapper in
// daft_tpu_torch/ops/permute_kernels.py allocates recv), and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// thread blocks over all pairs: enough to fill 132 SMs many times over
constexpr long long kTargetBlocks = 132LL * 32;

template <typename T>
__global__ void block_transpose_kernel(const T* __restrict__ send,
                                       T* __restrict__ recv, int n, long long w) {
  const int pair = blockIdx.y;  // output block: d * n + s
  const int d = pair / n;
  const int s = pair - d * n;
  const T* __restrict__ src = send + (static_cast<long long>(s) * n + d) * w;
  T* __restrict__ dst = recv + static_cast<long long>(pair) * w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; k + 3 * stride < w; k += 4 * stride) {
    const T a = __ldg(src + k);
    const T b = __ldg(src + k + stride);
    const T c = __ldg(src + k + 2 * stride);
    const T e = __ldg(src + k + 3 * stride);
    dst[k] = a;
    dst[k + stride] = b;
    dst[k + 2 * stride] = c;
    dst[k + 3 * stride] = e;
  }
  for (; k < w; k += stride) dst[k] = __ldg(src + k);
}

template <typename T>
void launch(const void* send, void* recv, int n, long long w, cudaStream_t stream) {
  const long long pairs = static_cast<long long>(n) * n;
  long long bx = (kTargetBlocks + pairs - 1) / pairs;
  const long long needed = (w + kThreads - 1) / kThreads;
  if (bx > needed) bx = needed;
  if (bx < 1) bx = 1;
  const dim3 grid(static_cast<unsigned int>(bx), static_cast<unsigned int>(pairs));
  block_transpose_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(send), static_cast<T*>(recv), n, w);
}

}  // namespace

extern "C" {

// send and recv: (n, n, w_words) int32; n * n <= 65535 (checked by the
// wrapper).
int daft_ring_permute_words(const void* send, void* recv, int n, long long w_words,
                            void* stream) {
  if (n > 0 && w_words > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uintptr_t addr = reinterpret_cast<uintptr_t>(send) |
                           reinterpret_cast<uintptr_t>(recv);
    if (w_words % 4 == 0 && (addr & 15) == 0) {
      launch<int4>(send, recv, n, w_words / 4, s);
    } else {
      launch<int>(send, recv, n, w_words, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
