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
// What bounds it on the card: the stencil is a few compares per voxel and
// every operand is read once, so a sweep is bound by bytes (25 per voxel
// for B2's ball_rail, 13 for B1 with an okmask). What keeps a kernel from
// that bound is the order of the planes.
//
//   B1 keeps the per-plane form: n launches per sweep, each reading the
//   previous plane back from device memory through nine overlapping loads.
//   At 512 x 512 a launch is about 7 us, so the sweep is bound by the
//   launch cadence, four to eight times its byte bound.
//
//   B2 is one launch per sweep (plane.cuh, persistent strips): CTA g owns
//   rows [g R, g R + R) of every plane, keeps the previous plane's strip
//   (both fields and the carried ids, with a one-cell border and one halo
//   row above and below) in shared memory, twice, so that a plane is
//   relaxed from one copy into the other; the operands of the next plane
//   stream into two stages with cp.async, off the dependency chain. A
//   thread relaxes one column of up to four rows, so that the cells of
//   the carried plane are read once for all of them (the sweep's
//   arithmetic is bound by shared-memory reads), the strip's edge rows
//   first: those go, each value with the step's number in one 64-bit word,
//   to mailboxes in device memory, where the neighbours' threads spin for
//   them as their halo. The chain per plane is one such exchange through
//   L2 (no fence, no grid barrier) instead of a launch. A plane too large
//   for shared memory (see `plan_dual`) keeps the per-plane form.
//
// The f32 operation order is the contract: the step cost is added before
// the min in euclid mode, the nodecost after the min in node mode. The
// file is built with --fmad=false and uses __fadd_rn so nothing contracts.

#include <type_traits>

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
//
// First the per-plane form (`dual_plane`, `run_dual`), the route of planes
// too large for shared memory; then the persistent strips.

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

// B2, persistent strips. Shared memory of one CTA, in this order:
//   carried: 2 copies x {field A, field B, ids} x (R + 2) x (W + 2) words;
//   stages:  2 x {da, db, cc, (nc,) R x W words each (, ok R x W bytes)}.
constexpr int kGroup = 4;  // rows of a column that one thread relaxes

struct DualLayout {
    int64_t cells;        // (R + 2) * (W + 2)
    int64_t strip;        // R * W
    size_t stage_offset;  // bytes before the first stage
    size_t stage_bytes;
    size_t total;
};

template <int KIND>
__host__ __device__ inline DualLayout dual_layout(int R, int W) {
    DualLayout l;
    l.cells = (int64_t)(R + 2) * (W + 2);
    l.strip = (int64_t)R * W;
    l.stage_offset = (size_t)((2 * 3 * l.cells * 4 + 15) / 16 * 16);
    const int64_t words = KIND == 0 ? 4 : 3;
    const int64_t bytes = words * l.strip * 4 + (KIND == 0 ? l.strip : 0);
    l.stage_bytes = (size_t)((bytes + 15) / 16 * 16);
    l.total = l.stage_offset + kt::kStages * l.stage_bytes;
    return l;
}

template <int KIND, bool ASYNC>
__global__ void __launch_bounds__(kt::kStripThreads, 1)
dual_strips(const float* __restrict__ da, const float* __restrict__ db,
            const int32_t* __restrict__ cc, const float* __restrict__ nc,
            const uint8_t* __restrict__ ok, float* __restrict__ oa,
            float* __restrict__ ob, unsigned long long* mail, int n, int H,
            int W, int R, int descending, kt::Costs9 costs) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x;
    const int T = blockDim.x;
    const int g = blockIdx.x;
    const int G = gridDim.x;
    const int y0 = g * R;
    const int rows = min(R, H - y0);
    const int PW = W + 2;
    const int64_t HW = (int64_t)H * W;
    const float fill = KIND == 0 ? INFINITY : -INFINITY;
    const DualLayout lay = dual_layout<KIND>(R, W);

    float* car_a[2];
    float* car_b[2];
    int32_t* car_id[2];
    for (int k = 0; k < 2; ++k) {
        car_a[k] = (float*)smem + (3 * k + 0) * lay.cells;
        car_b[k] = (float*)smem + (3 * k + 1) * lay.cells;
        car_id[k] = (int32_t*)smem + (3 * k + 2) * lay.cells;
    }
    // nothing is carried into the first plane; the border cells and the
    // halo rows outside the volume keep these values for the whole sweep
    for (int64_t i = tid; i < lay.cells; i += T) {
        for (int k = 0; k < 2; ++k) {
            car_a[k][i] = fill;
            car_b[k][i] = fill;
            car_id[k][i] = -1;
        }
    }

    // the operands of sweep step s: one contiguous run of rows x W
    // elements each, into stage s % 2
    auto prefetch = [&](int s) {
        int64_t plane, prev;
        kt::sweep_planes(s, n, descending, &plane, &prev);
        const int64_t src = plane * HW + (int64_t)y0 * W;
        const int64_t cnt = (int64_t)rows * W;
        unsigned char* st = smem + lay.stage_offset
            + (size_t)(s % kt::kStages) * lay.stage_bytes;
        kt::stage_copy<ASYNC, 4>(st, da + src, cnt * 4);
        kt::stage_copy<ASYNC, 4>(st + lay.strip * 4, db + src, cnt * 4);
        kt::stage_copy<ASYNC, 4>(st + lay.strip * 8, cc + src, cnt * 4);
        if (KIND == 0) {
            kt::stage_copy<ASYNC, 4>(st + lay.strip * 12, nc + src, cnt * 4);
            kt::stage_copy<ASYNC, 1>(st + lay.strip * 16, ok + src, cnt);
        }
    };
    prefetch(0);
    kt::cp_async_commit();

    // The mailboxes of strip g: its top and its bottom edge row, each for
    // an even and an odd step, each W cells of field A then W of field B.
    // A strip writes the mailbox of step s + 2 only after it has read its
    // neighbours' step s + 1, which they wrote after reading its step s.
    auto mailbox = [&](int strip, int bottom, int step) {
        return mail + ((int64_t)(strip * 2 + bottom) * 2 + (step & 1)) * 2 * W;
    };

    const int groups = (rows + kGroup - 1) / kGroup;
    const int item_g = tid / W, item_z = tid % W;  // item `tid`
    const int step_g = T / W, step_z = T % W;
    int p = 0;  // the carried copy that holds the previous plane
    for (int s = 0; s < n; ++s) {
        int64_t plane, prev;
        kt::sweep_planes(s, n, descending, &plane, &prev);
        float* pa = car_a[p];
        float* pb = car_b[p];
        int32_t* pid = car_id[p];
        if (s > 0) {
            // the halo rows, one column a thread: the neighbours' edge
            // rows of step s - 1 from their mailboxes, the ids from cc
            const int64_t base = prev * HW;
            if (g > 0) {
                const int64_t row = base + (int64_t)(y0 - 1) * W;
                const unsigned long long* mb = mailbox(g - 1, 1, s - 1);
                for (int z = tid; z < W; z += T) {
                    const int32_t c = __ldg(cc + row + z);
                    pid[1 + z] = c > 0 ? c : -1;
                    pa[1 + z] = kt::mail_wait(mb + z, s);
                    pb[1 + z] = kt::mail_wait(mb + W + z, s);
                }
            }
            if (g + 1 < G) {
                const int64_t row = base + (int64_t)(y0 + rows) * W;
                const int dst = (rows + 1) * PW + 1;
                const unsigned long long* mb = mailbox(g + 1, 0, s - 1);
                for (int z = tid; z < W; z += T) {
                    const int32_t c = __ldg(cc + row + z);
                    pid[dst + z] = c > 0 ? c : -1;
                    pa[dst + z] = kt::mail_wait(mb + z, s);
                    pb[dst + z] = kt::mail_wait(mb + W + z, s);
                }
            }
        }
        kt::cp_async_wait_all();  // this thread's part of stage s % 2
        __syncthreads();
        // every thread is past step s - 1: its stage takes step s + 1
        if (s + 1 < n) prefetch(s + 1);
        kt::cp_async_commit();

        const unsigned char* st = smem + lay.stage_offset
            + (size_t)(s % kt::kStages) * lay.stage_bytes;
        const float* s_da = (const float*)st;
        const float* s_db = (const float*)(st + lay.strip * 4);
        const int32_t* s_cc = (const int32_t*)(st + lay.strip * 8);
        const float* s_nc = (const float*)(st + lay.strip * 12);
        const uint8_t* s_ok = st + lay.strip * 16;
        float* qa = car_a[p ^ 1];
        float* qb = car_b[p ^ 1];
        int32_t* qid = car_id[p ^ 1];
        float* out_a = oa + plane * HW + (int64_t)y0 * W;
        float* out_b = ob + plane * HW + (int64_t)y0 * W;
        unsigned long long* top_out = g > 0 ? mailbox(g, 0, s) : nullptr;
        unsigned long long* bottom_out =
            g + 1 < G ? mailbox(g, 1, s) : nullptr;

        // Relax column z of the rows [ra, ra + rc) of the strip (rc <= 4)
        // from the carried plane: the (rc + 2) x 3 cells around them are
        // read once for all rc voxels. A group of four rows goes in the
        // order 0, 3, 1, 2, so that the strip's edge rows come first. The
        // arithmetic is that of `dual_plane`, in its order.
        auto relax_column = [&](auto full_t, int ra, int z, int rc) {
            constexpr bool FULL = decltype(full_t)::value;
            constexpr int order[kGroup] = {0, 3, 1, 2};
            int32_t nid[kGroup + 2][3];
            float va[kGroup + 2][3];
            float vb[kGroup + 2][3];
#pragma unroll
            for (int dy = 0; dy < kGroup + 2; ++dy) {
                if (FULL || dy < rc + 2) {
#pragma unroll
                    for (int dz = 0; dz < 3; ++dz) {
                        const int j = (ra + dy) * PW + z + dz;
                        nid[dy][dz] = pid[j];
                        va[dy][dz] = pa[j];
                        vb[dy][dz] = pb[j];
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < kGroup; ++k) {
                if (!FULL && k >= rc) break;
                const int rr = FULL ? order[k] : k;
                const int r = ra + rr;
                const int i = r * W + z;
                const int32_t ccc = s_cc[i];
                const bool occ = ccc > 0;
                const bool occ_a = KIND == 0 ? (occ && s_ok[i] != 0) : occ;
                float cand_a = fill;
                float cand_b = fill;
#pragma unroll
                for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
                    for (int dz = 0; dz < 3; ++dz) {
                        // a neighbour of another id offers the fill value,
                        // which changes neither minimum nor maximum
                        if (nid[rr + dy][dz] == ccc) {
                            if (KIND == 0) {
                                cand_a = fminf(cand_a, __fadd_rn(
                                    va[rr + dy][dz], costs.c[3 * dy + dz]));
                                cand_b = fminf(cand_b, vb[rr + dy][dz]);
                            } else {
                                cand_a = fmaxf(cand_a, va[rr + dy][dz]);
                                cand_b = fmaxf(cand_b, vb[rr + dy][dz]);
                            }
                        }
                    }
                }
                const float cur_a = s_da[i];
                const float cur_b = s_db[i];
                float na, nb;
                if (KIND == 0) {
                    na = occ_a ? fminf(cur_a, cand_a) : INFINITY;
                    if (na > 0.0f) na = INFINITY;
                    cand_b = __fadd_rn(cand_b, s_nc[i]);
                    nb = occ ? fminf(cur_b, cand_b) : INFINITY;
                } else {
                    na = occ ? fmaxf(cur_a, cand_a) : fill;
                    nb = occ ? fmaxf(cur_b, cand_b) : fill;
                }
                // an edge row goes to the neighbour's mailbox first
                if (r == 0 && top_out != nullptr) {
                    kt::mail_post(top_out + z, na, s + 1);
                    kt::mail_post(top_out + W + z, nb, s + 1);
                }
                if (r == rows - 1 && bottom_out != nullptr) {
                    kt::mail_post(bottom_out + z, na, s + 1);
                    kt::mail_post(bottom_out + W + z, nb, s + 1);
                }
                out_a[i] = na;
                out_b[i] = nb;
                // field A's +inf at its non-ok voxels is its folded
                // occupancy
                const int q = (r + 1) * PW + z + 1;
                qa[q] = na;
                qb[q] = nb;
                qid[q] = occ ? ccc : -1;
            }
        };

        // one item per (group of four rows, column); the groups that hold
        // the strip's edge rows first: the neighbours wait for them.
        // (it / W, it % W) walks on by T items without a division.
        const int items = groups * W;
        int gi = item_g, z = item_z;
        for (int it = tid; it < items; it += T) {
            const int grp = gi == 0 ? 0 : (gi == 1 ? groups - 1 : gi - 1);
            const int ra = grp * kGroup;
            const int rc = min(kGroup, rows - ra);
            if (rc == kGroup) {
                relax_column(std::true_type{}, ra, z, rc);
            } else {
                relax_column(std::false_type{}, ra, z, rc);
            }
            gi += step_g;
            z += step_z;
            if (z >= W) {
                z -= W;
                ++gi;
            }
        }
        p ^= 1;
    }
}

// How B2 runs a plane of H x W. The persistent form needs the device to
// hold one CTA per strip at once, and the strip of the fewest rows
// (ceil(H / SMs)) to fit in a block's shared memory: the carried plane
// twice and two operand stages. Any other plane (at 132 SMs and 227 KB:
// above about 640 x 640) keeps the per-plane form.
struct DualPlan {
    bool persistent;
    kt::Strips strips;
    size_t smem;
};

template <int KIND>
DualPlan plan_dual(int H, int W) {
    DualPlan plan = {false, {0, 0}, 0};
    const int ctas = kt::coresident_ctas();
    if (ctas <= 0 || H <= 0 || W <= 0) return plan;
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    plan.strips = kt::make_strips(H, ctas);
    plan.smem = dual_layout<KIND>(plan.strips.rows, W).total;
    plan.persistent = plan.smem <= (size_t)optin;
    return plan;
}

template <int KIND>
int run_dual_strips(const float* da, const float* db, const int32_t* cc,
                    const float* nc, const uint8_t* ok, float* oa, float* ob,
                    unsigned long long* mail, int n, int H, int W,
                    const kt::Costs9& costs, int descending,
                    const DualPlan& plan, cudaStream_t st) {
    // 16 bytes a copy needs every plane strip to start and end on 16
    // bytes, for the byte mask too
    bool aligned = W % 16 == 0;
    const void* operands[5] = {da, db, cc, nc, ok};
    for (const void* q : operands) {
        aligned = aligned && ((uintptr_t)q % 16 == 0);
    }
    const void* kern = aligned ? (const void*)dual_strips<KIND, true>
                               : (const void*)dual_strips<KIND, false>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (e != cudaSuccess) return (int)e;
    int R = plan.strips.rows;
    kt::Costs9 c = costs;
    void* args[] = {&da, &db, &cc, &nc, &ok, &oa, &ob, &mail, &n, &H, &W,
                    &R, &descending, &c};
    e = cudaLaunchCooperativeKernel(kern, dim3(plan.strips.count),
                                    dim3(kt::kStripThreads), args, plan.smem,
                                    st);
    return (int)e;
}

template <int KIND>
int dispatch_dual(const void* da, const void* db, const void* cc,
                  const void* nc, const void* ok, void* oa, void* ob,
                  void* mail, int n, int H, int W, const kt::Costs9& costs,
                  int descending, cudaStream_t st) {
    if (n <= 0 || H <= 0 || W <= 0) return 0;
    const DualPlan plan = plan_dual<KIND>(H, W);
    if (!plan.persistent) {
        return run_dual<KIND>(da, db, cc, nc, ok, oa, ob, n, H, W, costs,
                              descending, st);
    }
    if (mail == nullptr) return (int)cudaErrorInvalidValue;
    return run_dual_strips<KIND>(
        (const float*)da, (const float*)db, (const int32_t*)cc,
        (const float*)nc, (const uint8_t*)ok, (float*)oa, (float*)ob,
        (unsigned long long*)mail, n, H, W, costs, descending, plan, st);
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

// B2. kind: 0 ball_rail (nc and ok required), 1 max2. mail: int64
// (strips * 8 * W,) for the persistent form (kt_gsweep_dual_plan), zeroed
// by the caller before every call: the strips' edge-row mailboxes.
int kt_gsweep_sweep0_dual(const void* da, const void* db, const void* cc,
                          const void* nc, const void* ok, void* oa, void* ob,
                          void* mail, int n, int H, int W,
                          const float* costs9, int kind, int descending,
                          void* stream) {
    const kt::Costs9 costs = kt::make_costs9(costs9);
    cudaStream_t st = (cudaStream_t)stream;
    if (kind == 0) {
        if (nc == nullptr || ok == nullptr) return (int)cudaErrorInvalidValue;
        return dispatch_dual<0>(da, db, cc, nc, ok, oa, ob, mail, n, H, W,
                                costs, descending, st);
    }
    if (kind == 1) {
        return dispatch_dual<1>(da, db, cc, nc, ok, oa, ob, mail, n, H, W,
                                costs, descending, st);
    }
    return (int)cudaErrorInvalidValue;
}

// How B2 runs a plane of H x W on the current device: returns 1 for the
// persistent form (and its rows per strip and its strips), 0 for the
// per-plane form.
int kt_gsweep_dual_plan(int H, int W, int kind, int* rows, int* strips) {
    const DualPlan plan = kind == 0 ? plan_dual<0>(H, W) : plan_dual<1>(H, W);
    *rows = plan.strips.rows;
    *strips = plan.strips.count;
    return plan.persistent ? 1 : 0;
}

}  // extern "C"
