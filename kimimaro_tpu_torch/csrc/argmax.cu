// B3: per-lane masked argmax over a crop window of a full volume.
//
// Replaces the Pallas kernel kimimaro_tpu/ops/pallas_argmax.py
// `crop_argmax` (`_kernel_factory`). Per lane: the first maximum of an f32
// field over the voxels with cc == lid inside the window [off, off + crop).
// Ties go to the first maximum in (x, y, z) lexicographic order, which is
// jnp.argmax over the crop's ravel; a lane whose label holds only -inf (or
// no voxel at all) answers -inf at the crop origin, like jnp.argmax.
// Returns global coordinates and the value.
//
// What bounds it on the card: each crop voxel is read once (4 bytes of
// field, 4 of cc), so a tier is bandwidth-bound: 2048 lanes of 96^3 read
// about 14.5 GB. One block per lane walks its window row by row (a warp
// per (x, y) row, lanes along the contiguous z axis, so reads coalesce) and
// reduces the key (value, -flat index) in shared memory. The TPU kernel's
// 8/128 window widening is a TPU tiling rule and is not carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool better(float v, int64_t i, float bv,
                                       int64_t bi) {
    return v > bv || (v == bv && i < bi);
}

__global__ void crop_argmax_kernel(const float* __restrict__ field,
                                   const int32_t* __restrict__ cc,
                                   const int32_t* __restrict__ offs,
                                   const int32_t* __restrict__ lids, int Y,
                                   int Z, int CX, int CY, int CZ,
                                   int32_t* __restrict__ coords,
                                   float* __restrict__ vals) {
    const int lane = blockIdx.x;
    const int ox = offs[3 * lane + 0];
    const int oy = offs[3 * lane + 1];
    const int oz = offs[3 * lane + 2];
    const int32_t lid = lids[lane];

    float best = -INFINITY;
    int64_t bi = INT64_MAX;
    const int warp = threadIdx.x / 32;
    const int wl = threadIdx.x % 32;
    const int nwarps = kThreads / 32;
    const int64_t rows = (int64_t)CX * CY;
    for (int64_t r = warp; r < rows; r += nwarps) {
        const int x = (int)(r / CY);
        const int y = (int)(r - (int64_t)x * CY);
        const int64_t gbase = ((int64_t)(ox + x) * Y + (oy + y)) * Z + oz;
        const int64_t fbase = r * CZ;
        for (int z = wl; z < CZ; z += 32) {
            const int64_t g = gbase + z;
            const float v = (cc[g] == lid) ? field[g] : -INFINITY;
            const int64_t f = fbase + z;
            if (better(v, f, best, bi)) {
                best = v;
                bi = f;
            }
        }
    }

    __shared__ float sv[kThreads];
    __shared__ int64_t si[kThreads];
    sv[threadIdx.x] = best;
    si[threadIdx.x] = bi;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) {
            const float v = sv[threadIdx.x + s];
            const int64_t i = si[threadIdx.x + s];
            if (better(v, i, sv[threadIdx.x], si[threadIdx.x])) {
                sv[threadIdx.x] = v;
                si[threadIdx.x] = i;
            }
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        int64_t f = si[0];
        if (f == INT64_MAX) f = 0;  // empty crop: cannot happen (crop >= 1)
        const int64_t cyz = (int64_t)CY * CZ;
        const int x = (int)(f / cyz);
        const int64_t rem = f - (int64_t)x * cyz;
        const int y = (int)(rem / CZ);
        const int z = (int)(rem - (int64_t)y * CZ);
        coords[3 * lane + 0] = ox + x;
        coords[3 * lane + 1] = oy + y;
        coords[3 * lane + 2] = oz + z;
        vals[lane] = sv[0];
    }
}

}  // namespace

extern "C" {

// field: float32 (X, Y, Z); cc: int32 (X, Y, Z); offs: int32 (N, 3) crop
// origins with off + crop inside the volume; lids: int32 (N,). Outputs:
// coords int32 (N, 3), vals float32 (N,). Returns a cudaError_t code.
int kt_crop_argmax(const void* field, const void* cc, const void* offs,
                   const void* lids, int N, int X, int Y, int Z, int CX,
                   int CY, int CZ, void* coords, void* vals, void* stream) {
    (void)X;
    if (N <= 0) return 0;
    crop_argmax_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)field, (const int32_t*)cc, (const int32_t*)offs,
        (const int32_t*)lids, Y, Z, CX, CY, CZ, (int32_t*)coords,
        (float*)vals);
    return (int)cudaGetLastError();
}

}  // extern "C"
