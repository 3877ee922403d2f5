// B5: one directed axis-0 sweep of a single (n, H, W) volume, gated by an
// ok mask (no component ids).
//
// Replaces the Pallas kernel kimimaro_tpu/ops/pallas_sweep.py `sweep_axis0`
// (`_sweep_kernel_factory`), which the host trace path relaxes label crops
// with (kimimaro_tpu/ops/geodesic.py `_sweep`).
//
//   node mode   new = min(cur, min9(prev) + nodecost)
//   euclid mode new = min(cur, min9(prev + step_cost))
//   new = ok ? new : +inf; clamp_positive resets positives to +inf.
//
// The first plane of the sweep passes through unchanged. A descending
// sweep walks the plane index downward instead of flipping the data.
//
// What bounds it on the card: label crops are small (tens to a few hundred
// voxels per side), so a plane is a few thousand threads and the sweep is
// bound by the per-plane launch, not by bytes. The design is the simple one
// shared with B1 (one stencil launch per plane, previous plane read from
// the output in device memory); a whole-crop kernel that walks the planes
// in one block is later work. Built with --fmad=false; __fadd_rn keeps the
// f32 order (step cost before the min, nodecost after it).

#include "plane.cuh"

namespace {

template <bool NODE, bool CLAMP>
__global__ void axis0_plane(const float* __restrict__ d,
                            const uint8_t* __restrict__ ok,
                            const float* __restrict__ nc,
                            float* __restrict__ out, int H, int W,
                            int64_t plane, int64_t prev, kt::Costs9 costs) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (y >= H || z >= W) return;
    const int64_t HW = (int64_t)H * W;
    const int64_t i = plane * HW + (int64_t)y * W + z;
    const float cur = d[i];
    if (prev < 0) {
        out[i] = cur;
        return;
    }
    float cand = INFINITY;
    int k = 0;
    for (int dy = -1; dy <= 1; ++dy) {
        for (int dz = -1; dz <= 1; ++dz, ++k) {
            const int yy = y + dy;
            const int zz = z + dz;
            float s = INFINITY;
            if (yy >= 0 && yy < H && zz >= 0 && zz < W) {
                s = out[prev * HW + (int64_t)yy * W + zz];
            }
            cand = NODE ? fminf(cand, s) : fminf(cand, __fadd_rn(s, costs.c[k]));
        }
    }
    if (NODE) cand = __fadd_rn(cand, nc[i]);
    float nv = ok[i] ? fminf(cur, cand) : INFINITY;
    if (CLAMP && nv > 0.0f) nv = INFINITY;
    out[i] = nv;
}

template <bool NODE, bool CLAMP>
int run_axis0(const void* d, const void* ok, const void* nc, void* out, int n,
              int H, int W, const kt::Costs9& costs, int descending,
              cudaStream_t st) {
    const dim3 grid = kt::plane_grid(H, W);
    const dim3 block = kt::plane_block();
    for (int s = 0; s < n; ++s) {
        int64_t plane, prev;
        kt::sweep_planes(s, n, descending, &plane, &prev);
        axis0_plane<NODE, CLAMP><<<grid, block, 0, st>>>(
            (const float*)d, (const uint8_t*)ok, (const float*)nc,
            (float*)out, H, W, plane, prev, costs);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

}  // namespace

extern "C" {

// d/out/nc: float32, ok: uint8 (bool), all (n, H, W) contiguous; nc may be
// NULL when node_mode is 0. Returns a cudaError_t code (0 = success).
int kt_sweep_axis0(const void* d, const void* ok, const void* nc, void* out,
                   int n, int H, int W, const float* costs9, int node_mode,
                   int clamp, int descending, void* stream) {
    const kt::Costs9 costs = kt::make_costs9(costs9);
    cudaStream_t st = (cudaStream_t)stream;
    if (node_mode) {
        if (nc == nullptr) return (int)cudaErrorInvalidValue;
        return clamp ? run_axis0<true, true>(d, ok, nc, out, n, H, W, costs,
                                             descending, st)
                     : run_axis0<true, false>(d, ok, nc, out, n, H, W, costs,
                                              descending, st);
    }
    return clamp ? run_axis0<false, true>(d, ok, nc, out, n, H, W, costs,
                                          descending, st)
                 : run_axis0<false, false>(d, ok, nc, out, n, H, W, costs,
                                           descending, st);
}

}  // extern "C"
