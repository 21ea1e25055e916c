// The Hopper machinery shared by the tensor-core scan kernels (tc_scan.cu)
// and the tensor-core breakdown ladder (breakdown.cu): shared addresses,
// mbarriers, TMA loads, the wgmma fences and shared-memory descriptors,
// the magic-number f32 conversion constants, and on the host the TMA
// descriptor encoder, the shared-memory opt-in and the persistent grid.
// The ladder is built from these, so its rungs time K1a's own product.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

namespace {

constexpr int kTileRows = 64;    // wgmma M: one warpgroup's rows
constexpr int kTcThreads = 128;  // one warpgroup a block
constexpr int kTensorMapError = 10000;
// 1.5 * 2^24 as f32 bits: in [2^24, 2^25) one ulp is 2, so adding an int i
// (|i| < 2^22) to these bits gives the float 25165824 + 2i exactly.
constexpr int kMagic2Bits = 0x4BC00000;
constexpr float kMagic2 = 25165824.0f;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Bytes of one K-major column chunk of u8 rows and queries: a row of
// 128 B is one 128-byte swizzle span; narrower rows (32, 64 B) go as
// unswizzled 16-byte chunks.
__host__ __device__ constexpr int row_chunk(int d) { return d == 128 ? 128 : 16; }

// ---- PTX: shared addresses, mbarriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
  __syncwarp();  // reconverge before the warpgroup-wide wgmma
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads above the wait.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major operand stored as column
// chunks [K / chunk][rows][chunk]: start address, leading offset (between
// chunks along K; unused when one chunk is a whole swizzle span), stride
// between 8-row groups (8 x the chunk), swizzle mode (`layout`: 0 = none,
// 16-byte chunks of 8 x 16 B core matrices; 1 = 128 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// ---- Host side: TMA descriptors, the shared-memory opt-in, the grid

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A byte tensor map of rank 1 to 3 (dims, the strides of dims 1.. in
// bytes, the box); zero fill out of bounds (padding rows, rows past N,
// query rows past Q).  Returns 0 or kTensorMapError + the driver's code.
int encode_tiled(CUtensorMap* map, int rank, const void* ptr, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return kTensorMapError;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// A rank-1 or rank-2 byte map: dims (dim0, dim1), row stride stride1.
int encode_map(CUtensorMap* map, int rank, const void* ptr, uint64_t dim0, uint64_t dim1,
               uint64_t stride1, uint32_t box0, uint32_t box1, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {dim0, dim1};
  const cuuint64_t strides[1] = {stride1};
  const cuuint32_t box[2] = {box0, box1};
  return encode_tiled(map, rank, ptr, dims, strides, box, swizzle);
}

// Opts a kernel into the device's largest dynamic shared memory, once per
// (kernel, device), so that every launch of it may take what its layout
// needs (an opt-in per size would let a smaller launch lower the limit
// under a larger one's).
template <typename Kernel>
int allow_smem(Kernel kernel) {
  struct Opt {
    const void* kernel;
    int dev;
  };
  static std::mutex mu;
  static std::vector<Opt> done;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (const Opt& o : done)
    if (o.kernel == key && o.dev == dev) return 0;
  int optin = 0;
  rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == cudaSuccess) rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  done.push_back(Opt{key, dev});
  return 0;
}

// Persistent grid of one-warpgroup blocks: as many as fit on the SMs, at
// most one an item.  The shared-memory opt-in and the occupancy query are
// host calls of some microseconds; each (kernel, device, bytes) asks once.
template <typename Kernel>
int persistent_grid(Kernel kernel, size_t smem, int n_items, int* grid) {
  struct Fit {
    const void* kernel;
    int dev;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Fit> fits;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  auto it = std::find_if(fits.begin(), fits.end(), [&](const Fit& f) {
    return f.kernel == key && f.dev == dev && f.smem == smem;
  });
  if (it == fits.end()) {
    const int opt = allow_smem(kernel);
    if (opt != 0) return opt;
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTcThreads, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    it = fits.insert(fits.end(), Fit{key, dev, smem, std::max(1, per_sm) * sms});
  }
  *grid = std::min(n_items, it->blocks);
  return 0;
}

}  // namespace
