// Mesh exchange kernel K6, written by hand for Hopper (sm_90a).
//
// Replaces daft_tpu/ops/pallas_kernels.py ring_permute_bits: the all-to-all
// of per-destination word blocks inside the repartition program. Contract:
// send is (n_src, n_dst, W) int32 words, block [s, d] being shard s's words
// for shard d; recv is (n_dst, n_src, W) with recv[d][s] = send[s][d], bit
// for bit, every word copied (padding included).
//
// On the TPU each shard's kernel pushes its n - 1 outgoing blocks to its
// peers with remote DMAs over the interconnect, one ring step at a time. The
// port's mesh is n shard slots on one card, so every block already lies in
// the same device memory and the exchange is a block transpose: one launch
// moves all n^2 blocks, where the all_to_all tier makes n^2 copies per plane.
//
// Bound: memory. Every word is read once and written once, 2 x 4 x n^2 x W
// bytes (12.3 GB at the SF1 repartition cell, n = 8, W = 23 x 2^20 + 4:
// 3.686 ms at 3.35 TB/s).
//
// The first design was a grid of 66 x 64 blocks of 256 threads, each
// thread issuing four 16-byte loads through the read-only L1 path before its
// four stores: 5.145-5.251 ms, 72 % of the memory rate, slower than the 64
// device-to-device copies of the plain version (4.467 ms, 83 %).
//
// This design is a persistent bulk-copy kernel. One block of one warp per SM
// walks a flat list of 32 KB chunks (chunk c: output block c / chunks per
// block, bytes at (c % chunks per block) x 32 KB), every gridDim-th chunk.
// One thread per block does the copying through a ring of four 32 KB stages
// in shared memory: cp.async.bulk loads a chunk into a stage and completes
// on the stage's mbarrier; once it lands, cp.async.bulk stores the stage to
// the destination as a bulk group; a stage is loaded again only after the
// store from it has read it (cp.async.bulk.wait_group.read). Three loads and
// up to two stores are in flight per SM, and the SM's bulk-copy unit moves
// the bytes without a register or an instruction per word.
// Measured at the SF1 cell (chip_smoke.py on an H100 80GB HBM3 at 700 W):
// 4.38 ms, 84 % of the memory rate, against 4.44-4.51 ms for the 64 copies
// and 5.16 ms for transpose(0, 1).contiguous(). Tried and dropped, each
// slower in the same run: an L2 evict-first hint on both sides (4.54 ms
// against 4.42 without) or on the loads alone (4.50 against 4.38); with the
// hint on, 48 or 64 KB stages, two blocks per SM and a contiguous range of
// chunks per block (4.51-4.82 against 4.51-4.54); and a persistent vector
// copy with eight 16-byte loads in flight per thread, L1 bypassed and
// streaming stores (5.64 ms against 4.51).
// Bulk copies need 16-byte aligned addresses and sizes, so this path takes W
// a multiple of four words and 16-byte aligned buffers (the repartition step
// pads W to a multiple of four); anything else takes the word path, a grid
// over (words, output blocks) that copies one int32 per thread per step.
// Every offset is 64-bit: at the SF1 cell n^2 x W is 1.5e9 words.
// Left for later: copying only each block's live prefix (the counts ride at
// the end of each block, so that needs a first pass or a layout change), and
// NVLink peer copies for a mesh over several cards.
//
// The launcher takes raw device pointers and the caller's stream, launches
// on that stream, never synchronises, allocates nothing (the wrapper in
// daft_tpu_torch/ops/permute_kernels.py allocates recv), and returns the
// first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- the word path -------------------------------------------------------------

constexpr int kThreads = 256;
// thread blocks over all pairs: enough to fill 132 SMs many times over
constexpr long long kTargetBlocks = 132LL * 32;

__global__ void word_transpose_kernel(const int* __restrict__ send, int* __restrict__ recv,
                                      int n, long long w) {
  const int pair = blockIdx.y;  // output block: d * n + s
  const int d = pair / n;
  const int s = pair - d * n;
  const int* __restrict__ src = send + (static_cast<long long>(s) * n + d) * w;
  int* __restrict__ dst = recv + static_cast<long long>(pair) * w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; k < w;
       k += stride) {
    dst[k] = src[k];
  }
}

// ---- the bulk path -------------------------------------------------------------

constexpr int kStages = 4;
constexpr unsigned kChunkBytes = 32 * 1024;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, unsigned src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(32)
    bulk_transpose_kernel(const unsigned char* __restrict__ send,
                          unsigned char* __restrict__ recv, int n, long long block_bytes,
                          long long chunks_per_block) {
  extern __shared__ __align__(128) unsigned char stage_buf[];
  __shared__ __align__(8) unsigned long long full[kStages];
  if (threadIdx.x != 0) return;
  const long long total = static_cast<long long>(n) * n * chunks_per_block;
  const long long first = blockIdx.x;
  const long long step = gridDim.x;
  if (first >= total) return;
  const long long count = (total - first + step - 1) / step;

  for (int i = 0; i < kStages; ++i) mbar_init(smem_addr(&full[i]));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  // this block's i-th chunk: its source, its destination, its bytes
  auto locate = [&](long long i, const unsigned char** src, unsigned char** dst) {
    const long long c = first + i * step;
    const long long pair = c / chunks_per_block;  // output block d * n + s
    const long long off = (c - pair * chunks_per_block) * kChunkBytes;
    const long long d = pair / n;
    const long long s = pair - d * n;
    *src = send + (s * n + d) * block_bytes + off;
    *dst = recv + pair * block_bytes + off;
    const long long left = block_bytes - off;
    return static_cast<unsigned>(left < kChunkBytes ? left : kChunkBytes);
  };
  // chunk i goes through stage i % kStages, whose barrier completes phase
  // i / kStages when the chunk has landed
  auto load = [&](long long i) {
    const unsigned char* src;
    unsigned char* dst;
    const unsigned bytes = locate(i, &src, &dst);
    const int st = static_cast<int>(i % kStages);
    const unsigned bar = smem_addr(&full[st]);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_addr(stage_buf + st * kChunkBytes), src, bytes, bar);
  };

  for (long long i = 0; i < count && i < kStages; ++i) load(i);
  for (long long i = 0; i < count; ++i) {
    const int st = static_cast<int>(i % kStages);
    mbar_wait(smem_addr(&full[st]), static_cast<unsigned>((i / kStages) & 1));
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const unsigned char* src;
    unsigned char* dst;
    const unsigned bytes = locate(i, &src, &dst);
    bulk_store(dst, smem_addr(stage_buf + st * kChunkBytes), bytes);
    // refill the stage of chunk i - 1 once its store has read it
    if (i >= 1 && i - 1 + kStages < count) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(i - 1 + kStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

cudaError_t launch_bulk(const void* send, void* recv, int n, long long w_words,
                        cudaStream_t stream) {
  const int smem = kStages * static_cast<int>(kChunkBytes);
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(bulk_transpose_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess) {
    return err;
  }
  const long long block_bytes = w_words * 4;
  const long long chunks_per_block = (block_bytes + kChunkBytes - 1) / kChunkBytes;
  const long long total = static_cast<long long>(n) * n * chunks_per_block;
  const long long grid = total < sms ? total : sms;  // one block per SM
  bulk_transpose_kernel<<<static_cast<unsigned>(grid), 32, smem, stream>>>(
      static_cast<const unsigned char*>(send), static_cast<unsigned char*>(recv), n,
      block_bytes, chunks_per_block);
  return cudaGetLastError();
}

void launch_words(const void* send, void* recv, int n, long long w, cudaStream_t stream) {
  const long long pairs = static_cast<long long>(n) * n;
  long long bx = (kTargetBlocks + pairs - 1) / pairs;
  const long long needed = (w + kThreads - 1) / kThreads;
  if (bx > needed) bx = needed;
  if (bx < 1) bx = 1;
  const dim3 grid(static_cast<unsigned int>(bx), static_cast<unsigned int>(pairs));
  word_transpose_kernel<<<grid, kThreads, 0, stream>>>(static_cast<const int*>(send),
                                                        static_cast<int*>(recv), n, w);
}

}  // namespace

extern "C" {

// send and recv: (n, n, w_words) int32; n * n <= 65535 (checked by the
// wrapper). The path is chosen by shape and alignment alone.
int daft_ring_permute_words(const void* send, void* recv, int n, long long w_words,
                            void* stream) {
  if (n > 0 && w_words > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uintptr_t addr = reinterpret_cast<uintptr_t>(send) |
                           reinterpret_cast<uintptr_t>(recv);
    if (w_words % 4 == 0 && (addr & 15) == 0) {
      const cudaError_t err = launch_bulk(send, recv, n, w_words, s);
      if (err != cudaSuccess) return static_cast<int>(err);
    } else {
      launch_words(send, recv, n, w_words, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
