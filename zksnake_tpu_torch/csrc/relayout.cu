// S1-S8: the relayout probes of the gather-free MSM pipeline.
//
// Replace the Pallas kernels of scripts/bench_sortdma.py, which measured on
// the TPU how fast a round-major MSM table could be built from sorted point
// planes (stored here as int32 words holding the u32 bits):
//   S1 stage_dma          (:86)  out[b] = src[start_b : start_b + R, :]
//   S7 stage_expand_dma_pm (:398) the same function, by async copies
//   S3 stage_expand_dma   (:177) out[b] = X[:, start_b : start_b + R]
//   S2 stage_tkernel      (:139) transpose in (128, 128) tiles
//   S4 stage_tk_copy      (:279) identity copy, tile by tile (TMA)
//   S5 stage_tk_fat       (:309) transpose in fat (512, M) blocks
//   S6 stage_tk_mxu       (:345) transpose through the matrix unit
//   S8 stage_tk_flat      (:455) skinny (2 nl, M) -> (M, 2 nl) transpose
// Each computes the function, not the TPU's blocking.
//
// Bound: device memory for all eight (each word is read once and written
// once; S6's tensor-core work is a few percent of that time). The designs
// keep every global access coalesced and, where the shape allows, 16 bytes
// a thread; shared tiles are padded or laid out so that no warp access
// conflicts more than a few ways. The expansions (S1, S3, S7) are plain
// loads and stores: their asynchronous versions (cp.async.bulk / TMA, the
// DMA engine the TPU kernels used) are later work.

#include <cuda.h>  // CUtensorMap and its enums only: the driver is reached at run time
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

// ------------------------------------------------------------ S1, S3, S7 --

// Words q .. q+3 of `in` (any alignment; in is 16-byte aligned and holds
// in_words words, q + 3 < in_words): the aligned chunk holding q, and where
// q is not aligned the next one, funnelled together. A next chunk that
// would reach past the end of `in` is read word by word.
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ in, int64_t q, int64_t in_words) {
  const int64_t a = q >> 2;
  const int m = (int)(q & 3);
  const int4 A = __ldg(reinterpret_cast<const int4*>(in) + a);
  if (m == 0) return A;
  int4 B;
  if (4 * a + 8 <= in_words) {
    B = __ldg(reinterpret_cast<const int4*>(in) + a + 1);
  } else {  // only words up to q + 3 <= 4a + 6 exist for certain
    B.x = __ldg(in + 4 * a + 4);
    B.y = m >= 2 ? __ldg(in + 4 * a + 5) : 0;
    B.z = m == 3 ? __ldg(in + 4 * a + 6) : 0;
    B.w = 0;
  }
  if (m == 1) return make_int4(A.y, A.z, A.w, B.x);
  if (m == 2) return make_int4(A.z, A.w, B.x, B.y);
  return make_int4(A.w, B.x, B.y, B.z);
}

// One block per bucket b. Its output out[b] is nrows * len contiguous words:
// row l is the window in[l * ld + starts[b] * scale + k], k < len. S1/S7:
// nrows = 1, scale = the row width, len = R * width (the window of R whole
// rows is one span). S3: nrows = nl limb rows of ld words, scale = 1,
// len = R. The block writes its output in aligned 16-byte chunks (a head
// and a tail of single words where the output is not aligned); a chunk
// within one row reads its four source words through load4, a chunk that
// crosses a row end word by word. A window that does not lie inside `in`
// gives a bucket of zeros, as the plain versions do.
__global__ void __launch_bounds__(256)
expand_kernel(const int32_t* __restrict__ in, int64_t in_words, int64_t ld, int nrows,
              int scale, const int32_t* __restrict__ starts, int64_t len,
              int32_t* __restrict__ out) {
  const int64_t b = blockIdx.x;
  const int64_t s = (int64_t)starts[b] * scale;
  const int64_t base = b * nrows * len;  // first output word of this bucket
  const int64_t total = nrows * len;
  if (s < 0 || s + (int64_t)(nrows - 1) * ld + len > in_words) {
    for (int64_t w = threadIdx.x; w < total; w += blockDim.x) out[base + w] = 0;
    return;
  }
  const int64_t head = total < ((-base) & 3) ? total : ((-base) & 3);
  const int64_t chunks = (total - head) >> 2;
  const int64_t tail = head + 4 * chunks;
  auto src_of = [&](int64_t w) {  // source word of output word w of the bucket
    const int64_t l = nrows == 1 ? 0 : w / len;
    return l * ld + s + (w - l * len);
  };
  for (int64_t w = threadIdx.x; w < head; w += blockDim.x) out[base + w] = __ldg(in + src_of(w));
  for (int64_t w = tail + threadIdx.x; w < total; w += blockDim.x)
    out[base + w] = __ldg(in + src_of(w));
  int4* dst = reinterpret_cast<int4*>(out + base + head);
  for (int64_t c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int64_t w = head + 4 * c;
    const int64_t l = nrows == 1 ? 0 : w / len;
    const int64_t k = w - l * len;
    int4 v;
    if (k + 3 < len) {
      v = load4(in, l * ld + s + k, in_words);
    } else {
      v.x = __ldg(in + src_of(w));
      v.y = __ldg(in + src_of(w + 1));
      v.z = __ldg(in + src_of(w + 2));
      v.w = __ldg(in + src_of(w + 3));
    }
    dst[c] = v;
  }
}

// -------------------------------------------------------------------- S2 --

// The classic 32 x 32 shared tile with a padded row (bank-conflict free in
// both directions), a (32, 8) block, one word a thread a step.
__global__ void __launch_bounds__(256)
tile32_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int rows, int cols) {
  __shared__ int32_t tile[32][33];
  const int64_t r0 = (int64_t)blockIdx.y * 32, c0 = (int64_t)blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int j = ty; j < 32; j += 8) {
    const int64_t r = r0 + j, c = c0 + tx;
    if (r < rows && c < cols) tile[j][tx] = __ldg(in + r * cols + c);
  }
  __syncthreads();
#pragma unroll
  for (int j = ty; j < 32; j += 8) {  // out (cols, rows): out row c0 + j, column r0 + tx
    const int64_t orow = c0 + j, ocol = r0 + tx;
    if (orow < cols && ocol < rows) out[orow * rows + ocol] = tile[tx][j];
  }
}

// -------------------------------------------------------------------- S4 --

// The identity copy, tile by tile through shared memory, the way Hopper
// copies: the Tensor Memory Accelerator (TMA) moves whole (CP_R, CP_C)
// tiles global -> shared -> global while the block's one issuing thread
// only hands out coordinates. Each block walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... through a ring of CP_STAGES tile buffers: the
// loads run CP_STAGES - 1 tiles ahead (completion on one mbarrier a buffer),
// each arrived tile is stored back at once (a bulk group a tile), and a
// buffer is loaded again when its last store has read it. Both carry an L2
// evict-first hint (each byte passes once) and every block gets the same
// number of tiles where the grid allows. TMA clips the
// tiles at the array's edge itself: the loads fill past it with zeros, the
// stores write nothing past it. Rows whose byte stride TMA cannot take (not
// a multiple of 16 bytes) take the same kernel's 16-byte path: the array is
// contiguous, so it is copied as flat 16-byte chunks and a word tail.
constexpr int CP_R = 32, CP_C = 128, CP_STAGES = 4, CP_THREADS = 128;
constexpr int CP_BYTES = CP_R * CP_C * 4;  // 16 KB a tile

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__global__ void __launch_bounds__(CP_THREADS)
copy_kernel(const __grid_constant__ CUtensorMap src, const __grid_constant__ CUtensorMap dst,
            int use_tma, int tiles_c, int tiles, const int32_t* __restrict__ in,
            int32_t* __restrict__ out, int64_t words) {
  extern __shared__ __align__(128) unsigned char buf[];  // CP_STAGES tiles
  __shared__ __align__(8) uint64_t full[CP_STAGES];
  if (!use_tma) {
    const int64_t chunks = words >> 2;
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < chunks; q += step)
      reinterpret_cast<int4*>(out)[q] = __ldg(reinterpret_cast<const int4*>(in) + q);
    if (blockIdx.x == 0 && threadIdx.x < (words & 3))
      out[4 * chunks + threadIdx.x] = __ldg(in + 4 * chunks + threadIdx.x);
    return;
  }
  if (threadIdx.x != 0) return;
  uint64_t once;  // L2 policy: evict first
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(once));
  const uint64_t smap = reinterpret_cast<uint64_t>(&src), dmap = reinterpret_cast<uint64_t>(&dst);
  for (int s = 0; s < CP_STAGES; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const int mine = (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  auto coords = [&](int i, int* c, int* r) {
    const int t = (int)blockIdx.x + i * (int)gridDim.x;
    *c = (t % tiles_c) * CP_C;
    *r = (t / tiles_c) * CP_R;
  };
  auto load = [&](int i) {
    const unsigned bar = smem_addr(&full[i % CP_STAGES]);
    int c, r;
    coords(i, &c, &r);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(CP_BYTES) : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n"
        ::"r"(smem_addr(buf + (i % CP_STAGES) * CP_BYTES)), "l"(smap), "r"(c), "r"(r),
        "r"(bar), "l"(once) : "memory");
  };
  for (int i = 0; i < CP_STAGES - 1 && i < mine; ++i) load(i);
  for (int i = 0; i < mine; ++i) {
    const unsigned bar = smem_addr(&full[i % CP_STAGES]);
    const unsigned parity = (unsigned)(i / CP_STAGES) & 1u;
    asm volatile(
        "{\n .reg .pred p;\n WAIT:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        " @!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
    int c, r;
    coords(i, &c, &r);
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
        " [%0, {%1, %2}], [%3], %4;\n"
        ::"l"(dmap), "r"(c), "r"(r), "r"(smem_addr(buf + (i % CP_STAGES) * CP_BYTES)),
        "l"(once) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (i + CP_STAGES - 1 < mine) {
      // its buffer held tile i - 1: wait until that store has read it (the
      // store of tile i may still be reading)
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(i + CP_STAGES - 1);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so
// nothing beyond the CUDA runtime is linked.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 13000
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A (rows, cols) int32 map with (CP_R, CP_C) boxes; false if TMA refuses it.
bool tile_map(CUtensorMap* map, const void* base, int rows, int cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {CP_C, CP_R}, elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// ---------------------------------------------------------------- S5, S8 --

// A TR x TC word tile a 256-thread block, 16 bytes a thread in and out.
// S5: TR = TC = 64 (4 int4 loads and 4 stores a thread). S8: TR = 32,
// TC = 128, so each output row of the (M, 32) result is 128 bytes, written
// whole by 8 neighbouring threads. A warp reads 4 tile rows x 8 chunks and
// writes 4 output rows x 8 chunks; with the tile row padded to TC + 1 words
// both the scattered shared stores and the gathering shared loads hit 32
// distinct banks. Edge tiles, and shapes whose rows are not whole chunks,
// go word by word.
template <int TR, int TC>
__global__ void __launch_bounds__(256)
transpose_vec_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int rows,
                     int cols) {
  static_assert(TR % 32 == 0 && TC % 32 == 0, "tile of whole warps");
  __shared__ int32_t tile[TR][TC + 1];
  const int64_t r0 = (int64_t)blockIdx.y * TR, c0 = (int64_t)blockIdx.x * TC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vin = (cols & 3) == 0, vout = (rows & 3) == 0;
  constexpr int RG = TR / 4;  // 4-row groups of the tile
  for (int g = warp; g < RG * (TC / 32); g += 8) {
    const int r = (g % RG) * 4 + (lane >> 3);
    const int c = ((g / RG) * 8 + (lane & 7)) * 4;
    const int64_t gr = r0 + r, gc = c0 + c;
    if (vin && gr < rows && gc + 3 < cols) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(in + gr * cols + gc));
      tile[r][c] = v.x;
      tile[r][c + 1] = v.y;
      tile[r][c + 2] = v.z;
      tile[r][c + 3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        tile[r][c + k] = (gr < rows && gc + k < cols) ? __ldg(in + gr * cols + gc + k) : 0;
    }
  }
  __syncthreads();
  constexpr int CG = TC / 4;  // 4-row groups of the output tile
  for (int g = warp; g < CG * (TR / 32); g += 8) {
    const int j = (g % CG) * 4 + (lane >> 3);         // tile column = output row
    const int i = ((g / CG) * 8 + (lane & 7)) * 4;    // tile row = output column
    const int64_t orow = c0 + j, ocol = r0 + i;
    if (vout && orow < cols && ocol + 3 < rows) {
      *reinterpret_cast<int4*>(out + orow * rows + ocol) =
          make_int4(tile[i][j], tile[i + 1][j], tile[i + 2][j], tile[i + 3][j]);
    } else if (orow < cols) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ocol + k < rows) out[orow * rows + ocol + k] = tile[i + k][j];
    }
  }
}

// -------------------------------------------------------------------- S6 --

// The transpose on the tensor cores, exact. A 128-thread block takes a
// 64 x 64 word tile: it cuts the tile into four u8 byte planes, stored
// 16 x 16 subtile by subtile (WMMA wants 32-byte aligned tiles). Each warp
// takes four subtiles; for each byte plane it loads the subtile as the
// col-major A operand (so A = X^T) and multiplies it by the 16 x 16 u8
// identity on the tensor cores (u8 x u8 -> s32, m16n16k16): D = X^T I =
// X^T, every entry one product of a byte by 1, so exact. The four s32
// accumulators share one fragment layout, so the word is reassembled
// element by element in registers, D0 | D1 << 8 | D2 << 16 | D3 << 24,
// stored to a shared output tile, and written out 16 bytes a thread.
constexpr int MMA_TILE = 64;

__global__ void __launch_bounds__(128)
transpose_mma_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int rows,
                     int cols) {
  constexpr int ST = MMA_TILE / 16;                                  // subtiles a side
  __shared__ __align__(32) unsigned char planes[4][ST * ST][256];    // [byte][subtile][16x16]
  __shared__ __align__(32) int32_t stage[ST * ST][256];              // transposed subtiles
  __shared__ __align__(32) unsigned char eye[256];
  const int64_t r0 = (int64_t)blockIdx.y * MMA_TILE, c0 = (int64_t)blockIdx.x * MMA_TILE;
  const int tid = threadIdx.x, warp = tid >> 5;
  const bool vin = (cols & 3) == 0, vout = (rows & 3) == 0;
  for (int i = tid; i < 256; i += blockDim.x) eye[i] = (i >> 4) == (i & 15) ? 1 : 0;
  // load: 64 rows x 16 chunks of 4 words; a chunk's byte p of its 4 words
  // is one 32-bit word of plane p (4 neighbouring columns)
  for (int q = tid; q < MMA_TILE * MMA_TILE / 4; q += blockDim.x) {
    const int r = q >> 4, c = (q & 15) * 4;
    const int64_t gr = r0 + r, gc = c0 + c;
    uint32_t w[4];
    if (vin && gr < rows && gc + 3 < cols) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(in + gr * cols + gc));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = (gr < rows && gc + k < cols) ? (uint32_t)__ldg(in + gr * cols + gc + k) : 0u;
    }
    const int sub = (r >> 4) * ST + (c >> 4), off = (r & 15) * 16 + (c & 15);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int sh = 8 * p;
      *reinterpret_cast<uint32_t*>(&planes[p][sub][off]) =
          ((w[0] >> sh) & 0xFFu) | (((w[1] >> sh) & 0xFFu) << 8) |
          (((w[2] >> sh) & 0xFFu) << 16) | (((w[3] >> sh) & 0xFFu) << 24);
    }
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_b, 16, 16, 16, unsigned char, wmma::row_major> fi;
  wmma::load_matrix_sync(fi, eye, 16);
  for (int s = warp; s < ST * ST; s += blockDim.x / 32) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> d[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, unsigned char, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, planes[p][s], 16);
      wmma::fill_fragment(d[p], 0);
      wmma::mma_sync(d[p], fa, fi, d[p]);
    }
#pragma unroll
    for (int e = 0; e < d[0].num_elements; ++e)
      d[0].x[e] = (int)((uint32_t)d[0].x[e] | ((uint32_t)d[1].x[e] << 8) |
                        ((uint32_t)d[2].x[e] << 16) | ((uint32_t)d[3].x[e] << 24));
    // subtile (tr, tc) of the input is subtile (tc, tr) of the output
    wmma::store_matrix_sync(stage[(s % ST) * ST + s / ST], d[0], 16, wmma::mem_row_major);
  }
  __syncthreads();
  // out (cols, rows): output row c0 + j, columns r0 + i .. i + 3
  for (int q = tid; q < MMA_TILE * MMA_TILE / 4; q += blockDim.x) {
    const int j = q >> 4, i = (q & 15) * 4;
    const int64_t orow = c0 + j, ocol = r0 + i;
    const int32_t* src = &stage[(j >> 4) * ST + (i >> 4)][(j & 15) * 16 + (i & 15)];
    if (vout && orow < cols && ocol + 3 < rows) {
      *reinterpret_cast<int4*>(out + orow * rows + ocol) = *reinterpret_cast<const int4*>(src);
    } else if (orow < cols) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ocol + k < rows) out[orow * rows + ocol + k] = src[k];
    }
  }
}

// Grid of tr x tc tiles over a (rows, cols) input: tile columns on x.
bool tile_grid(int rows, int cols, int tr, int tc, dim3* grid) {
  const int64_t gy = ((int64_t)rows + tr - 1) / tr, gx = ((int64_t)cols + tc - 1) / tc;
  if (gy > 65535) return false;
  *grid = dim3((unsigned)gx, (unsigned)gy);
  return true;
}

}  // namespace

extern "C" {

// S1, S3, S7 (see expand_kernel). in: in_words int32 words, out: nb * nrows
// * len words, both 16-byte aligned; starts: nb int32. Returns the
// cudaError_t of the launch (0 on success).
int zk_expand(const void* in, long long in_words, long long ld, int nrows, int scale,
              const void* starts, int nb, long long len, void* out, void* stream) {
  if (nrows < 1 || scale < 1 || len < 0 || nb < 0) return (int)cudaErrorInvalidValue;
  if (nb > 0 && len > 0)
    expand_kernel<<<nb, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)in, in_words, ld, nrows, scale, (const int32_t*)starts, len,
        (int32_t*)out);
  return (int)cudaGetLastError();
}

// S2: in (rows, cols) -> out (cols, rows).
int zk_tile32(const void* in, void* out, int rows, int cols, void* stream) {
  dim3 grid;
  if (!tile_grid(rows, cols, 32, 32, &grid)) return (int)cudaErrorInvalidValue;
  if (rows > 0 && cols > 0)
    tile32_kernel<<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>((const int32_t*)in,
                                                                  (int32_t*)out, rows, cols);
  return (int)cudaGetLastError();
}

// S4: out (rows, cols) = in (rows, cols); both 16-byte aligned.
int zk_copy_tma(const void* in, void* out, int rows, int cols, void* stream) {
  if (rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  const int64_t words = (int64_t)rows * cols;
  if (words == 0) return (int)cudaGetLastError();
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CP_STAGES * CP_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  CUtensorMap src{}, dst{};
  const int use_tma = (cols % 4) == 0;
  int tiles_c = 0, tiles = 0;
  unsigned grid;
  if (use_tma) {
    if (!tile_map(&src, in, rows, cols) || !tile_map(&dst, out, rows, cols))
      return (int)cudaErrorInvalidValue;
    tiles_c = (cols + CP_C - 1) / CP_C;
    const int64_t nt = (int64_t)tiles_c * ((rows + CP_R - 1) / CP_R);
    if (nt >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    tiles = (int)nt;
    // at most 3 blocks an SM (64 KB of tiles each), all with the same count
    const int per = (tiles + 3 * sm_count() - 1) / (3 * sm_count());
    grid = (unsigned)((tiles + per - 1) / per);
  } else {
    const int64_t blocks = ((words >> 2) + CP_THREADS - 1) / CP_THREADS;
    grid = (unsigned)(blocks < 8 * sm_count() ? (blocks > 0 ? blocks : 1) : 8 * sm_count());
  }
  copy_kernel<<<grid, CP_THREADS, use_tma ? CP_STAGES * CP_BYTES : 0, (cudaStream_t)stream>>>(
      src, dst, use_tma, tiles_c, tiles, (const int32_t*)in, (int32_t*)out, words);
  return (int)cudaGetLastError();
}

// S5: in (rows, cols) -> out (cols, rows), 64 x 64 tiles; both 16-byte aligned.
int zk_transpose_fat(const void* in, void* out, int rows, int cols, void* stream) {
  dim3 grid;
  if (!tile_grid(rows, cols, 64, 64, &grid)) return (int)cudaErrorInvalidValue;
  if (rows > 0 && cols > 0)
    transpose_vec_kernel<64, 64><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)in, (int32_t*)out, rows, cols);
  return (int)cudaGetLastError();
}

// S8: in (rows, cols) -> out (cols, rows), 32 x 128 tiles; both 16-byte aligned.
int zk_transpose_flat(const void* in, void* out, int rows, int cols, void* stream) {
  dim3 grid;
  if (!tile_grid(rows, cols, 32, 128, &grid)) return (int)cudaErrorInvalidValue;
  if (rows > 0 && cols > 0)
    transpose_vec_kernel<32, 128><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)in, (int32_t*)out, rows, cols);
  return (int)cudaGetLastError();
}

// S6: in (rows, cols) -> out (cols, rows) through the tensor cores; both
// 16-byte aligned.
int zk_transpose_mma(const void* in, void* out, int rows, int cols, void* stream) {
  dim3 grid;
  if (!tile_grid(rows, cols, MMA_TILE, MMA_TILE, &grid)) return (int)cudaErrorInvalidValue;
  if (rows > 0 && cols > 0)
    transpose_mma_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const int32_t*)in, (int32_t*)out, rows, cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
