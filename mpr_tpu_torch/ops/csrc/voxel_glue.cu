// The unrolled 3D voxel stage's glue: two kernels around the generated
// float kernel (render/unrolled.py::_voxel_stage, one chunk of cells).
//
// Replaces no TPU kernel: the JAX package's voxel stage
// (mpr_tpu/render/unrolled.py) leaves this glue to XLA, which fuses it
// into the evaluation.  The port's plain PyTorch glue
// (render/unrolled.py::voxel_centers_plain, voxel_columns_plain)
// materialises the voxels' int64 coordinates, three gathers and each
// operation of the camera transform over every lane, about 370 bytes of
// device memory a lane; these two kernels keep all of it in registers.
//
// Bound on the H100: bytes.  A lane is a handful of float operations
// (a centre, four rows of the 4x4, three IEEE divisions); the centres
// kernel writes 12 bytes a lane (wx, wy, wz for the float kernel), the
// columns kernel reads the float kernel's 4 bytes a lane; the cells'
// coordinates are 24 bytes a cell of k^3 lanes.
//
// Design: both kernels take a thread a (cell, vy, vx) column of a cell of
// k^3 voxels, k a power of two fixed at compile time (2, 4 or 16), lanes
// laid out as the float kernel takes them, lane = cell*k^3 + (vz*k + vy)*k
// + vx, so that neighbouring threads touch neighbouring lanes at every vz.
//   * voxel_centers_kernel: the column's x and y centres and their part
//     of each row of the transform once, then for each vz the rest, in
//     camera.transform3's order of operations, ((m30*fx + m31*fy) +
//     m32*fz) + m33 and so on (--fmad=false: each operation rounds as
//     PyTorch's does), centres as render/unrolled.py::_center's
//     ((float)i + 0.5f) / size * 2 - 1.  The 4x4 is read from the device.
//   * voxel_columns_kernel: the column's k values loaded at once, the top
//     one below 0 (NaN is not filled) found from vz = k - 1 down, and
//     cz*k + vz + 1 max-reduced into the int64 depth with a 64-bit
//     atomicMax, as scatter_reduce(..., "amax") does; an empty column
//     issues no atomic.  A pixel outside the depth is dropped.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float center(long long i, float size) {
  return ((float)i + 0.5f) / size * 2.0f - 1.0f;
}

template <int K>
__global__ void __launch_bounds__(THREADS)
voxel_centers_kernel(const float* __restrict__ mat,
                     const long long* __restrict__ bx,
                     const long long* __restrict__ by,
                     const long long* __restrict__ bz,
                     float* __restrict__ wx, float* __restrict__ wy,
                     float* __restrict__ wz, long long cols, float size) {
  __shared__ float m[16];
  if (threadIdx.x < 16) m[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const long long col = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (col >= cols) return;
  const long long c = col / (K * K);
  const int v = (int)(col % (K * K));
  const float fx = center(bx[c] * K + v % K, size);
  const float fy = center(by[c] * K + v / K, size);
  const float pw = m[12] * fx + m[13] * fy;
  const float px = m[0] * fx + m[1] * fy;
  const float py = m[4] * fx + m[5] * fy;
  const float pz = m[8] * fx + m[9] * fy;
  const long long z0 = bz[c] * K;
  const long long lane0 = c * (K * K * K) + v;
#pragma unroll 4
  for (int vz = 0; vz < K; ++vz) {
    const float fz = center(z0 + vz, size);
    const float w = (pw + m[14] * fz) + m[15];
    const long long lane = lane0 + (long long)vz * (K * K);
    wx[lane] = ((px + m[2] * fz) + m[3]) / w;
    wy[lane] = ((py + m[6] * fz) + m[7]) / w;
    wz[lane] = ((pz + m[10] * fz) + m[11]) / w;
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
voxel_columns_kernel(const float* __restrict__ val,
                     const long long* __restrict__ bx,
                     const long long* __restrict__ by,
                     const long long* __restrict__ bz,
                     long long* __restrict__ depth, long long cols,
                     long long n_depth, int size, int r0) {
  const long long col = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (col >= cols) return;
  const long long c = col / (K * K);
  const int v = (int)(col % (K * K));
  const float* p = val + c * (K * K * K) + v;
  float x[K];
#pragma unroll
  for (int vz = 0; vz < K; ++vz) x[vz] = p[vz * (K * K)];
  int top = 0;
#pragma unroll
  for (int vz = 0; vz < K; ++vz)
    if (x[vz] < 0.0f) top = vz + 1;
  if (!top) return;
  const long long pix = (by[c] * K + v / K - 64LL * r0) * size
                        + bx[c] * K + v % K;
  if (pix < 0 || pix >= n_depth) return;
  atomicMax(depth + pix, bz[c] * K + top);
}

template <int K>
int launch(const void* mat, const void* bx, const void* by, const void* bz,
           void* wx, void* wy, void* wz, int cells, int size,
           cudaStream_t stream) {
  const long long cols = (long long)cells * K * K;
  voxel_centers_kernel<K><<<(unsigned)((cols + THREADS - 1) / THREADS),
                            THREADS, 0, stream>>>(
      static_cast<const float*>(mat), static_cast<const long long*>(bx),
      static_cast<const long long*>(by), static_cast<const long long*>(bz),
      static_cast<float*>(wx), static_cast<float*>(wy),
      static_cast<float*>(wz), cols, (float)size);
  return (int)cudaGetLastError();
}

template <int K>
int launch_columns(const void* val, const void* bx, const void* by,
                   const void* bz, void* depth, int cells, int n_depth,
                   int size, int r0, cudaStream_t stream) {
  const long long cols = (long long)cells * K * K;
  voxel_columns_kernel<K><<<(unsigned)((cols + THREADS - 1) / THREADS),
                            THREADS, 0, stream>>>(
      static_cast<const float*>(val), static_cast<const long long*>(bx),
      static_cast<const long long*>(by), static_cast<const long long*>(bz),
      static_cast<long long*>(depth), cols, n_depth, size, r0);
  return (int)cudaGetLastError();
}

}  // namespace

// The centres: wx, wy, wz (cells*k^3 f32 each) of the voxels of the cells
// (bx, by, bz) (int64, in the grid of k-voxel cells), mat the device's
// (4, 4) f32, size voxels an edge.  k is 2, 4 or 16.
extern "C" int mpr_voxel_glue(const void* mat, const void* bx,
                              const void* by, const void* bz, void* wx,
                              void* wy, void* wz, int cells, int k,
                              int size, void* stream) {
  if (cells < 1 || size < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: return launch<2>(mat, bx, by, bz, wx, wy, wz, cells, size, s);
    case 4: return launch<4>(mat, bx, by, bz, wx, wy, wz, cells, size, s);
    case 16: return launch<16>(mat, bx, by, bz, wx, wy, wz, cells, size, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The columns: the top filled voxel of each column of val (cells*k^3 f32,
// the float kernel's output on mpr_voxel_glue's lanes) max-reduced into
// depth (n_depth int64: the slab of 64px tile rows from r0, size pixels a
// row).
extern "C" int mpr_voxel_glue_columns(const void* val, const void* bx,
                                      const void* by, const void* bz,
                                      void* depth, int cells, int k,
                                      int n_depth, int size, int r0,
                                      void* stream) {
  if (cells < 1 || size < 1 || n_depth < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2:
      return launch_columns<2>(val, bx, by, bz, depth, cells, n_depth, size,
                               r0, s);
    case 4:
      return launch_columns<4>(val, bx, by, bz, depth, cells, n_depth, size,
                               r0, s);
    case 16:
      return launch_columns<16>(val, bx, by, bz, depth, cells, n_depth, size,
                                r0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
