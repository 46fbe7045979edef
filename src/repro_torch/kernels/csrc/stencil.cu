// One sweep of the 4-point 2D Jacobi stencil (paper §6.1): the port of
// the TPU kernel src/repro/kernels/stencil/stencil.py::jacobi4_pallas
// (_jacobi_kernel).  Interior cells become
// 0.25 * (north + south + west + east); the boundary rows and columns are
// copied through.
//
// What bounds it on the H100.  A sweep reads the grid once and writes it
// once, with 4 operations per cell: 0.5 operations per fp32 byte, far
// below the card's ridge, so one sweep is bound by bytes (an 8192 x 8192
// fp32 grid: 537 MB, 0.16 ms at 3.35 TB/s).  Many sweeps could share one
// pass through device memory (the paper's time replication, §3.3); this
// kernel does not yet.
//
// What this design does about it.  The TPU kernel reads three row-stripe
// taps of the grid per block (the paper's delay buffer, §2.2).  Here each
// block stages a 32 x 32 tile plus its one-cell halo in shared memory, so
// every cell is read from device memory once per sweep (the halo adds
// 1/8), and computes in fp32: ((up + down) + west) + east, then * 0.25,
// the order of the plain version, so fp32 agrees bit for bit and bf16 is
// rounded once.  The Jacobi update reads only the old grid, so a sweep
// writes a second buffer; the wrapper ping-pongs two buffers, one launch
// per sweep.  Ragged edges are masked, so every (rows, cols) runs.
#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int ROWS_PER_THREAD = 4;   // blockDim (32, 8)

template <typename T>
__global__ void __launch_bounds__(TILE * TILE / ROWS_PER_THREAD)
jacobi4_kernel(const T* __restrict__ x, T* __restrict__ y, int rows,
               int cols) {
  __shared__ float tile[TILE + 2][TILE + 2];
  // a 1-D grid of tiles, row-major, so no grid axis limits the shape
  const int tiles_x = (cols + TILE - 1) / TILE;
  const int r0 = (blockIdx.x / tiles_x) * TILE;
  const int c0 = (blockIdx.x % tiles_x) * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
  // the tile and its halo: (TILE + 2)^2 cells, grid cell (r0-1+i, c0-1+j)
  for (int e = ty * blockDim.x + tx; e < (TILE + 2) * (TILE + 2);
       e += nthreads) {
    const int i = e / (TILE + 2), j = e % (TILE + 2);
    const int r = r0 - 1 + i, c = c0 - 1 + j;
    tile[i][j] = (r >= 0 && r < rows && c >= 0 && c < cols)
                     ? to_f32(x[static_cast<long long>(r) * cols + c])
                     : 0.f;
  }
  __syncthreads();
  const int c = c0 + tx;
  if (c >= cols) return;
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int i = ty + k * (TILE / ROWS_PER_THREAD);
    const int r = r0 + i;
    if (r >= rows) break;
    const float centre = tile[i + 1][tx + 1];
    float out = centre;
    if (r > 0 && r < rows - 1 && c > 0 && c < cols - 1)
      out = 0.25f * (((tile[i][tx + 1] + tile[i + 2][tx + 1]) +
                      tile[i + 1][tx]) + tile[i + 1][tx + 2]);
    y[static_cast<long long>(r) * cols + c] = from_f32<T>(out);
  }
}

template <typename T>
int launch(const void* x, void* y, int rows, int cols, cudaStream_t stream) {
  const long long tiles = static_cast<long long>((cols + TILE - 1) / TILE) *
                          ((rows + TILE - 1) / TILE);
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(TILE, TILE / ROWS_PER_THREAD);
  jacobi4_kernel<T><<<static_cast<unsigned>(tiles), block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One sweep x -> y: x, y (rows, cols) of the float type `dtype`,
// contiguous, distinct buffers.  Returns a cudaError_t.
extern "C" int repro_jacobi4(const void* x, void* y, int rows, int cols,
                             int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || cols == 0) return 0;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, y, rows, cols, s);
  if (dtype == DTYPE_F32) return launch<float>(x, y, rows, cols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
