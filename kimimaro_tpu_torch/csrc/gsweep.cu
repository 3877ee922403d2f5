// B1 and B2: the cc-masked full-volume plane sweeps of the global engine.
//
// Replaces the Pallas kernels kimimaro_tpu/ops/gsweep.py `_sweep0_pallas`
// (`_kernel_factory`, B1) and `_sweep0_pallas_dual` (`_dual_kernel_factory`,
// B2). One directed sweep along axis 0 of an (n, H, W) volume: plane i is
// relaxed from plane i-1 through the nine (dy, dz) offsets, and a neighbour
// counts only when its carried component id equals the voxel's.
//
//   euclid   new = min(cur, min9(prev_same + step_cost))
//   node     new = min(cur, min9(prev_same) + nodecost)
//   maxflood new = max(cur, max9(prev_same))
//   minid    new = min(cur, min9(prev_same))         (int32 CCL ids)
//
// The carried id of a voxel is its cc id where it is occupied and -1
// elsewhere; occupancy is cc != 0 in minid mode (raw labels bitcast to
// int32 may be negative) and cc > 0 otherwise, and-ed with okmask != 0
// when given. The first plane of a sweep passes through with occupancy
// masking (and clamp). A descending sweep walks the plane index downward.
//
// What bounds it on the card: the stencil is a few compares per voxel, so
// each plane is memory- and launch-bound: one read of d, cc (and nodecost,
// okmask) per voxel plus the previous plane's ids and values, which the
// nine overlapping neighbour reads take from L1/L2. At 512x512 a plane is
// 262k threads; the per-plane launch (n launches per sweep) is the fixed
// cost this simple form accepts. The design keeps the previous plane in
// device memory (no carried scratch) so that blocks need no ordering among
// themselves; keeping it in shared memory or L2 across planes in one
// persistent kernel is later work.
//
// The f32 operation order is the contract: the step cost is added before
// the min in euclid mode, the nodecost after the min in node mode. The
// file is built with --fmad=false and uses __fadd_rn so nothing contracts.

#include "plane.cuh"

namespace {

enum Mode { kEuclid = 0, kNode = 1, kMaxflood = 2, kMinid = 3 };

template <int MODE>
struct Field {
    using T = float;
    static __device__ __forceinline__ float fill() {
        return MODE == kMaxflood ? -INFINITY : INFINITY;
    }
};

template <>
struct Field<kMinid> {
    using T = int32_t;
    static __device__ __forceinline__ int32_t fill() { return 2147483647; }
};

template <int MODE>
__device__ __forceinline__ bool occupied_id(int32_t c) {
    return MODE == kMinid ? (c != 0) : (c > 0);
}

template <int MODE, bool HAS_OK, bool CLAMP>
__global__ void sweep0_plane(const typename Field<MODE>::T* __restrict__ d,
                             const int32_t* __restrict__ cc,
                             const float* __restrict__ nc,
                             const uint8_t* __restrict__ ok,
                             typename Field<MODE>::T* __restrict__ out,
                             int H, int W, int64_t plane, int64_t prev,
                             kt::Costs9 costs) {
    using T = typename Field<MODE>::T;
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (y >= H || z >= W) return;
    const int64_t HW = (int64_t)H * W;
    const int64_t i = plane * HW + (int64_t)y * W + z;
    const int32_t ccc = cc[i];
    bool occ = occupied_id<MODE>(ccc);
    if (HAS_OK) occ = occ && (ok[i] != 0);
    const T fill = Field<MODE>::fill();
    const T cur = d[i];

    T nv;
    if (prev < 0) {
        nv = occ ? cur : fill;
    } else {
        T cand = fill;
        int k = 0;
        for (int dy = -1; dy <= 1; ++dy) {
            for (int dz = -1; dz <= 1; ++dz, ++k) {
                const int yy = y + dy;
                const int zz = z + dz;
                T sv = fill;
                if (yy >= 0 && yy < H && zz >= 0 && zz < W) {
                    const int64_t j = prev * HW + (int64_t)yy * W + zz;
                    const int32_t pc = cc[j];
                    bool pocc = occupied_id<MODE>(pc);
                    if (HAS_OK) pocc = pocc && (ok[j] != 0);
                    if ((pocc ? pc : -1) == ccc) sv = out[j];
                }
                if (MODE == kEuclid) sv = __fadd_rn(sv, costs.c[k]);
                if (MODE == kMaxflood) {
                    cand = fmaxf(cand, sv);
                } else if (MODE == kMinid) {
                    cand = min(cand, sv);
                } else {
                    cand = fminf(cand, sv);
                }
            }
        }
        if (MODE == kNode) cand = __fadd_rn(cand, nc[i]);
        if (MODE == kMaxflood) {
            nv = occ ? fmaxf(cur, cand) : fill;
        } else if (MODE == kMinid) {
            nv = occ ? min(cur, cand) : fill;
        } else {
            nv = occ ? fminf(cur, cand) : fill;
        }
    }
    if (CLAMP && (MODE == kEuclid || MODE == kNode)) {
        if (nv > 0.0f) nv = INFINITY;
    }
    out[i] = nv;
}

template <int MODE, bool HAS_OK, bool CLAMP>
int run_sweep0(const void* d, const void* cc, const void* nc, const void* ok,
               void* out, int n, int H, int W, const kt::Costs9& costs,
               int descending, cudaStream_t st) {
    using T = typename Field<MODE>::T;
    const dim3 grid = kt::plane_grid(H, W);
    const dim3 block = kt::plane_block();
    for (int s = 0; s < n; ++s) {
        int64_t plane, prev;
        kt::sweep_planes(s, n, descending, &plane, &prev);
        sweep0_plane<MODE, HAS_OK, CLAMP><<<grid, block, 0, st>>>(
            (const T*)d, (const int32_t*)cc, (const float*)nc,
            (const uint8_t*)ok, (T*)out, H, W, plane, prev, costs);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

template <int MODE>
int dispatch_sweep0(const void* d, const void* cc, const void* nc,
                    const void* ok, void* out, int n, int H, int W,
                    const kt::Costs9& costs, int clamp, int descending,
                    cudaStream_t st) {
    if (ok != nullptr) {
        return clamp ? run_sweep0<MODE, true, true>(d, cc, nc, ok, out, n, H,
                                                     W, costs, descending, st)
                     : run_sweep0<MODE, true, false>(d, cc, nc, ok, out, n, H,
                                                      W, costs, descending, st);
    }
    return clamp ? run_sweep0<MODE, false, true>(d, cc, nc, ok, out, n, H, W,
                                                  costs, descending, st)
                 : run_sweep0<MODE, false, false>(d, cc, nc, ok, out, n, H, W,
                                                   costs, descending, st);
}

// ---------------------------------------------------------------------------
// B2: two fields in one pass with one read of cc.
//   kind 0 "ball_rail": A = euclid + okmask + clamp_positive, B = node.
//   kind 1 "max2": two maxflood fields.
// Field A's stricter occupancy (cc > 0 and ok) is folded into its carried
// values (+inf at non-ok voxels); the carried ids use the shared cc > 0
// rule. Each field equals the single-field sweep bit for bit.

template <int KIND>
__global__ void dual_plane(const float* __restrict__ da,
                           const float* __restrict__ db,
                           const int32_t* __restrict__ cc,
                           const float* __restrict__ nc,
                           const uint8_t* __restrict__ ok,
                           float* __restrict__ oa, float* __restrict__ ob,
                           int H, int W, int64_t plane, int64_t prev,
                           kt::Costs9 costs) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (y >= H || z >= W) return;
    const int64_t HW = (int64_t)H * W;
    const int64_t i = plane * HW + (int64_t)y * W + z;
    const int32_t ccc = cc[i];
    const bool occ = ccc > 0;
    const bool occ_a = KIND == 0 ? (occ && ok[i] != 0) : occ;
    const float fill = KIND == 0 ? INFINITY : -INFINITY;

    float cand_a = fill;
    float cand_b = fill;
    if (prev >= 0) {
        int k = 0;
        for (int dy = -1; dy <= 1; ++dy) {
            for (int dz = -1; dz <= 1; ++dz, ++k) {
                const int yy = y + dy;
                const int zz = z + dz;
                float sva = fill;
                float svb = fill;
                if (yy >= 0 && yy < H && zz >= 0 && zz < W) {
                    const int64_t j = prev * HW + (int64_t)yy * W + zz;
                    const int32_t pc = cc[j];
                    if ((pc > 0 ? pc : -1) == ccc) {
                        // oa already holds +inf at the previous plane's
                        // non-ok voxels (the folded occupancy of field A)
                        sva = oa[j];
                        svb = ob[j];
                    }
                }
                if (KIND == 0) {
                    cand_a = fminf(cand_a, __fadd_rn(sva, costs.c[k]));
                    cand_b = fminf(cand_b, svb);
                } else {
                    cand_a = fmaxf(cand_a, sva);
                    cand_b = fmaxf(cand_b, svb);
                }
            }
        }
    }
    const float cur_a = da[i];
    const float cur_b = db[i];
    float na, nb;
    if (KIND == 0) {
        na = occ_a ? fminf(cur_a, cand_a) : INFINITY;
        if (na > 0.0f) na = INFINITY;
        cand_b = __fadd_rn(cand_b, nc[i]);
        nb = occ ? fminf(cur_b, cand_b) : INFINITY;
    } else {
        na = occ ? fmaxf(cur_a, cand_a) : fill;
        nb = occ ? fmaxf(cur_b, cand_b) : fill;
    }
    oa[i] = na;
    ob[i] = nb;
}

template <int KIND>
int run_dual(const void* da, const void* db, const void* cc, const void* nc,
             const void* ok, void* oa, void* ob, int n, int H, int W,
             const kt::Costs9& costs, int descending, cudaStream_t st) {
    const dim3 grid = kt::plane_grid(H, W);
    const dim3 block = kt::plane_block();
    for (int s = 0; s < n; ++s) {
        int64_t plane, prev;
        kt::sweep_planes(s, n, descending, &plane, &prev);
        dual_plane<KIND><<<grid, block, 0, st>>>(
            (const float*)da, (const float*)db, (const int32_t*)cc,
            (const float*)nc, (const uint8_t*)ok, (float*)oa, (float*)ob, H,
            W, plane, prev, costs);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

}  // namespace

extern "C" {

// B1. d/out: float32 (int32 in minid mode); cc: int32; nc: float32 or
// NULL; ok: uint8 or NULL; all (n, H, W) contiguous. mode: 0 euclid,
// 1 node, 2 maxflood, 3 minid. Returns a cudaError_t code (0 = success).
int kt_gsweep_sweep0(const void* d, const void* cc, const void* nc,
                     const void* ok, void* out, int n, int H, int W,
                     const float* costs9, int mode, int clamp, int descending,
                     void* stream) {
    const kt::Costs9 costs = kt::make_costs9(costs9);
    cudaStream_t st = (cudaStream_t)stream;
    switch (mode) {
        case kEuclid:
            return dispatch_sweep0<kEuclid>(d, cc, nc, ok, out, n, H, W, costs,
                                            clamp, descending, st);
        case kNode:
            return dispatch_sweep0<kNode>(d, cc, nc, ok, out, n, H, W, costs,
                                          clamp, descending, st);
        case kMaxflood:
            return dispatch_sweep0<kMaxflood>(d, cc, nc, ok, out, n, H, W,
                                              costs, 0, descending, st);
        case kMinid:
            return dispatch_sweep0<kMinid>(d, cc, nc, ok, out, n, H, W, costs,
                                           0, descending, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// B2. kind: 0 ball_rail (nc and ok required), 1 max2.
int kt_gsweep_sweep0_dual(const void* da, const void* db, const void* cc,
                          const void* nc, const void* ok, void* oa, void* ob,
                          int n, int H, int W, const float* costs9, int kind,
                          int descending, void* stream) {
    const kt::Costs9 costs = kt::make_costs9(costs9);
    cudaStream_t st = (cudaStream_t)stream;
    if (kind == 0) {
        if (nc == nullptr || ok == nullptr) return (int)cudaErrorInvalidValue;
        return run_dual<0>(da, db, cc, nc, ok, oa, ob, n, H, W, costs,
                           descending, st);
    }
    if (kind == 1) {
        return run_dual<1>(da, db, cc, nc, ok, oa, ob, n, H, W, costs,
                           descending, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
