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
// that bound is the order of the planes: a launch per plane costs about
// 5-7 us at 512 x 512, four to eight times the plane's bytes.
//
// Both are one launch per sweep (plane.cuh, persistent strips): CTA g owns
// rows [g R, g R + R) of every plane, keeps the previous plane's strip (the
// fields and the carried ids, with a one-cell border and one halo row above
// and below) in shared memory, twice, so that a plane is relaxed from one
// copy into the other; the operands of the next plane stream into two
// stages with cp.async, off the dependency chain. A thread relaxes one
// column of up to four rows, so that the cells of the carried plane are
// read once for all of them (the sweep's arithmetic is bound by
// shared-memory reads), the strip's edge rows first: those go, each value
// with the step's number in one 64-bit word, to mailboxes in device
// memory, where the neighbours' threads spin for them as their halo. The
// chain per plane is one such exchange through L2 (no fence, no grid
// barrier) instead of a launch. A plane too large for shared memory (see
// `plan_sweep0`, `plan_dual`) keeps the per-plane form.
//
// Inside the strips the carried ids are the raw cc values: a voxel that is
// not occupied carries the fill value (+inf, -inf or 2147483647), which
// changes no minimum or maximum, so what id it carries never matters. The
// per-plane form and the plain versions carry -1 there instead; both give
// the same result, also for occupied raw labels of -1 in minid mode.
//
// B1 with a voxel graph (B1-vg, minid mode only: the CCL of
// kimimaro_tpu/ops/ccl.py `_ccl_stage` with `has_vg`, which the JAX package
// runs as a lax.scan with no Pallas form): a neighbour u on the previous
// plane counts only where it has the voxel's label and the graph lets u's
// id move into the voxel. Both tests sit in one word a voxel, G1's CCL
// form (ops.stencils.graph_into with labels): bit GRAPH_BITS[o] set where
// the move from v + o into v is open and v + o has v's label, bit 26 where
// v is occupied. So the sweep reads the ids and that word (`bits` names
// the bit of each of the nine (dy, dz) neighbours for this layout and
// direction) and carries the ids alone: no cc operand, no carried-id
// channel, nine bit tests for the nine id compares. 12 bytes a voxel (ids
// and gate in, ids out; 0.48 ms at 512^3 on the HBM rate), 4 a carried
// cell.
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

// the nine-neighbour reduction of each mode
template <int MODE, class T>
__device__ __forceinline__ T reduce(T a, T b) {
    if (MODE == kMaxflood) return fmaxf(a, b);
    if (MODE == kMinid) return min(a, b);
    return fminf(a, b);
}

// ---------------------------------------------------------------------------
// B1, per plane: the route of planes too large for the strips.

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
                cand = reduce<MODE>(cand, sv);
            }
        }
        if (MODE == kNode) cand = __fadd_rn(cand, nc[i]);
        nv = occ ? reduce<MODE>(cur, cand) : fill;
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

// ---------------------------------------------------------------------------
// B1, persistent strips: the operator of kt::sweep_strips. Operands in
// this order: d, cc (, nc) words (, ok bytes).

template <int MODE, bool HAS_OK, bool CLAMP>
struct Sweep0Op {
    using T = typename Field<MODE>::T;
    static constexpr int kFields = 1;
    static constexpr bool kIds = true;
    static constexpr bool kNc = MODE == kNode;
    static constexpr int kWords = 2 + (kNc ? 1 : 0);
    static constexpr int kBytes = HAS_OK ? 1 : 0;

    const T* d;
    const int32_t* cc;
    const float* nc;
    const uint8_t* ok;
    T* out;
    kt::Costs9 costs;

    __device__ T fill() const { return Field<MODE>::fill(); }

    __device__ const void* operand(int k) const {
        if (k == 0) return d;
        if (k == 1) return cc;
        if (kNc && k == 2) return nc;
        return ok;
    }

    __device__ int32_t halo_id(int64_t j) const { return __ldg(cc + j); }

    // the arithmetic of `sweep0_plane`, in its order; a neighbour of
    // another id offers the fill value, which changes no min or max
    __device__ __forceinline__ void relax(
        bool first, const kt::StageView<kWords + kBytes>& in, int i,
        const T (&v)[1][kt::kGroup + 2][3],
        const int32_t (&nid)[kt::kGroup + 2][3], int rr, T (&nv)[1],
        int32_t& cid) const {
        const int32_t ccc = ((const int32_t*)in.p[1])[i];
        bool occ = occupied_id<MODE>(ccc);
        if constexpr (HAS_OK) occ = occ && (in.p[kWords][i] != 0);
        const T fill = Field<MODE>::fill();
        const T cur = ((const T*)in.p[0])[i];
        T r;
        if (first) {
            r = occ ? cur : fill;
        } else {
            T cand = fill;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
                for (int dz = 0; dz < 3; ++dz) {
                    if (nid[rr + dy][dz] == ccc) {
                        T sv = v[0][rr + dy][dz];
                        if (MODE == kEuclid) {
                            sv = __fadd_rn(sv, costs.c[3 * dy + dz]);
                        }
                        cand = reduce<MODE>(cand, sv);
                    }
                }
            }
            if constexpr (MODE == kNode) {
                cand = __fadd_rn(cand, ((const float*)in.p[2])[i]);
            }
            r = occ ? reduce<MODE>(cur, cand) : fill;
        }
        if (CLAMP && (MODE == kEuclid || MODE == kNode)) {
            if (r > 0.0f) r = INFINITY;
        }
        nv[0] = r;
        cid = ccc;
    }

    __device__ void store(int64_t j, const T (&nv)[1]) const { out[j] = nv[0]; }
};

// How B1 runs a plane of H x W: the persistent strips where a strip of
// ceil(H / SMs) rows fits in a block's shared memory, the per-plane form
// above that. One field and its ids are 8 bytes a carried cell and copy,
// and a voxel's operands 8 to 13 bytes a stage, so on 132 SMs with 227 KB
// the strips hold square planes up to 896 x 896 without an okmask in
// euclid, maxflood and minid mode, 848 x 848 with one, and 784 x 784 in
// node mode (B2: 656 x 656).
template <int MODE, bool HAS_OK>
kt::StripPlan plan_sweep0(int H, int W) {
    return kt::plan_grid_strips<Sweep0Op<MODE, HAS_OK, false>>(H, W);
}

template <int MODE, bool HAS_OK, bool CLAMP>
int run_sweep0_any(const void* d, const void* cc, const void* nc,
                   const void* ok, void* mail, void* out, int n, int H,
                   int W, const kt::Costs9& costs, int descending,
                   cudaStream_t st) {
    using Op = Sweep0Op<MODE, HAS_OK, CLAMP>;
    using T = typename Op::T;
    const kt::StripPlan plan = plan_sweep0<MODE, HAS_OK>(H, W);
    if (plan.form != kt::kGridStrips) {
        return run_sweep0<MODE, HAS_OK, CLAMP>(d, cc, nc, ok, out, n, H, W,
                                               costs, descending, st);
    }
    const Op op = {(const T*)d, (const int32_t*)cc, (const float*)nc,
                   (const uint8_t*)ok, (T*)out, costs};
    return kt::run_grid_strips(op, (unsigned long long*)mail, n, H, W,
                               descending, plan, st);
}

template <int MODE>
int dispatch_sweep0(const void* d, const void* cc, const void* nc,
                    const void* ok, void* mail, void* out, int n, int H,
                    int W, const kt::Costs9& costs, int clamp, int descending,
                    cudaStream_t st) {
    if (n <= 0 || H <= 0 || W <= 0) return 0;
    if (ok != nullptr) {
        return clamp ? run_sweep0_any<MODE, true, true>(
                           d, cc, nc, ok, mail, out, n, H, W, costs,
                           descending, st)
                     : run_sweep0_any<MODE, true, false>(
                           d, cc, nc, ok, mail, out, n, H, W, costs,
                           descending, st);
    }
    return clamp ? run_sweep0_any<MODE, false, true>(
                       d, cc, nc, ok, mail, out, n, H, W, costs, descending,
                       st)
                 : run_sweep0_any<MODE, false, false>(
                       d, cc, nc, ok, mail, out, n, H, W, costs, descending,
                       st);
}

template <int MODE>
kt::StripPlan plan_sweep0_mode(int H, int W, int has_ok) {
    return has_ok ? plan_sweep0<MODE, true>(H, W)
                  : plan_sweep0<MODE, false>(H, W);
}

// ---------------------------------------------------------------------------
// B1-vg: minid mode on G1's CCL gate. The occupancy is the gate's bit 26,
// a neighbour k of the previous plane counts where bit bits.b[k] is set
// (which also says that it has the voxel's label), and a voxel that is not
// occupied takes the fill. First the per-plane form, then the strips
// (kIds false: the ids are the carried values, the labels ride the gate).

constexpr int kOccBit = 26;

__global__ void sweep0_gate_plane(const int32_t* __restrict__ d,
                                  const uint32_t* __restrict__ gate,
                                  int32_t* __restrict__ out, int H, int W,
                                  int64_t plane, int64_t prev,
                                  kt::Bits9 bits) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (y >= H || z >= W) return;
    const int64_t HW = (int64_t)H * W;
    const int64_t i = plane * HW + (int64_t)y * W + z;
    const uint32_t g = gate[i];
    const bool occ = ((g >> kOccBit) & 1u) != 0u;
    const int32_t fill = Field<kMinid>::fill();
    const int32_t cur = d[i];
    int32_t nv;
    if (prev < 0) {
        nv = occ ? cur : fill;
    } else {
        int32_t cand = fill;
        int k = 0;
        for (int dy = -1; dy <= 1; ++dy) {
            for (int dz = -1; dz <= 1; ++dz, ++k) {
                const int yy = y + dy;
                const int zz = z + dz;
                if (yy >= 0 && yy < H && zz >= 0 && zz < W &&
                    ((g >> bits.b[k]) & 1u) != 0u) {
                    cand = min(cand, out[prev * HW + (int64_t)yy * W + zz]);
                }
            }
        }
        nv = occ ? min(cur, cand) : fill;
    }
    out[i] = nv;
}

int run_sweep0_gate(const void* d, const void* gate, void* out, int n, int H,
                    int W, const kt::Bits9& bits, int descending,
                    cudaStream_t st) {
    const dim3 grid = kt::plane_grid(H, W);
    const dim3 block = kt::plane_block();
    for (int s = 0; s < n; ++s) {
        int64_t plane, prev;
        kt::sweep_planes(s, n, descending, &plane, &prev);
        sweep0_gate_plane<<<grid, block, 0, st>>>(
            (const int32_t*)d, (const uint32_t*)gate, (int32_t*)out, H, W,
            plane, prev, bits);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

// Operands in this order: d, gate words.
struct Sweep0GateOp {
    using T = int32_t;
    static constexpr int kFields = 1;
    static constexpr bool kIds = false;
    static constexpr int kWords = 2;
    static constexpr int kBytes = 0;

    const int32_t* d;
    const uint32_t* gate;
    int32_t* out;
    kt::Bits9 bits;

    __device__ int32_t fill() const { return Field<kMinid>::fill(); }

    __device__ const void* operand(int k) const {
        return k == 0 ? (const void*)d : (const void*)gate;
    }

    // the arithmetic of `sweep0_gate_plane`; a cell outside the volume
    // holds the fill
    __device__ __forceinline__ void relax(
        bool first, const kt::StageView<kWords + kBytes>& in, int i,
        const int32_t (&v)[1][kt::kGroup + 2][3],
        const int32_t (&)[kt::kGroup + 2][3], int rr, int32_t (&nv)[1],
        int32_t&) const {
        const uint32_t g = ((const uint32_t*)in.p[1])[i];
        const bool occ = ((g >> kOccBit) & 1u) != 0u;
        const int32_t fill = Field<kMinid>::fill();
        const int32_t cur = ((const int32_t*)in.p[0])[i];
        if (first) {
            nv[0] = occ ? cur : fill;
            return;
        }
        int32_t cand = fill;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dz = 0; dz < 3; ++dz) {
                if (((g >> bits.b[3 * dy + dz]) & 1u) != 0u) {
                    cand = min(cand, v[0][rr + dy][dz]);
                }
            }
        }
        nv[0] = occ ? min(cur, cand) : fill;
    }

    __device__ void store(int64_t j, const int32_t (&nv)[1]) const {
        out[j] = nv[0];
    }
};

// How B1-vg runs a plane of H x W: 4 bytes a carried cell and copy and 8
// bytes of operands a voxel a stage, so on 132 SMs with 227 KB the strips
// hold square planes up to 1056 x 1056.
kt::StripPlan plan_sweep0_gate(int H, int W) {
    return kt::plan_grid_strips<Sweep0GateOp>(H, W);
}

int dispatch_sweep0_gate(const void* d, const void* gate, void* mail,
                         void* out, int n, int H, int W,
                         const kt::Bits9& bits, int descending,
                         cudaStream_t st) {
    if (n <= 0 || H <= 0 || W <= 0) return 0;
    const kt::StripPlan plan = plan_sweep0_gate(H, W);
    if (plan.form != kt::kGridStrips) {
        return run_sweep0_gate(d, gate, out, n, H, W, bits, descending, st);
    }
    const Sweep0GateOp op = {(const int32_t*)d, (const uint32_t*)gate,
                             (int32_t*)out, bits};
    return kt::run_grid_strips(op, (unsigned long long*)mail, n, H, W,
                               descending, plan, st);
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

// B2, persistent strips: the operator of kt::sweep_strips. Operands in
// this order: da, db, cc (, nc) words (, ok bytes). The first plane
// takes the same arithmetic from an all-fill carried plane, as
// `dual_plane` does.
template <int KIND>
struct DualOp {
    using T = float;
    static constexpr int kFields = 2;
    static constexpr bool kIds = true;
    static constexpr int kWords = KIND == 0 ? 4 : 3;
    static constexpr int kBytes = KIND == 0 ? 1 : 0;

    const float* da;
    const float* db;
    const int32_t* cc;
    const float* nc;
    const uint8_t* ok;
    float* oa;
    float* ob;
    kt::Costs9 costs;

    __device__ float fill() const { return KIND == 0 ? INFINITY : -INFINITY; }

    __device__ const void* operand(int k) const {
        const void* in[5] = {da, db, cc, nc, ok};
        return in[k];
    }

    __device__ int32_t halo_id(int64_t j) const { return __ldg(cc + j); }

    // the arithmetic of `dual_plane`, in its order
    __device__ __forceinline__ void relax(
        bool, const kt::StageView<kWords + kBytes>& in, int i,
        const float (&v)[2][kt::kGroup + 2][3],
        const int32_t (&nid)[kt::kGroup + 2][3], int rr, float (&nv)[2],
        int32_t& cid) const {
        const int32_t ccc = ((const int32_t*)in.p[2])[i];
        const bool occ = ccc > 0;
        bool occ_a = occ;
        if constexpr (KIND == 0) occ_a = occ && in.p[4][i] != 0;
        const float fill = this->fill();
        float cand_a = fill;
        float cand_b = fill;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dz = 0; dz < 3; ++dz) {
                if (nid[rr + dy][dz] == ccc) {
                    if (KIND == 0) {
                        cand_a = fminf(cand_a, __fadd_rn(
                            v[0][rr + dy][dz], costs.c[3 * dy + dz]));
                        cand_b = fminf(cand_b, v[1][rr + dy][dz]);
                    } else {
                        cand_a = fmaxf(cand_a, v[0][rr + dy][dz]);
                        cand_b = fmaxf(cand_b, v[1][rr + dy][dz]);
                    }
                }
            }
        }
        const float cur_a = ((const float*)in.p[0])[i];
        const float cur_b = ((const float*)in.p[1])[i];
        if constexpr (KIND == 0) {
            float na = occ_a ? fminf(cur_a, cand_a) : INFINITY;
            if (na > 0.0f) na = INFINITY;
            cand_b = __fadd_rn(cand_b, ((const float*)in.p[3])[i]);
            nv[0] = na;
            nv[1] = occ ? fminf(cur_b, cand_b) : INFINITY;
        } else {
            nv[0] = occ ? fmaxf(cur_a, cand_a) : fill;
            nv[1] = occ ? fmaxf(cur_b, cand_b) : fill;
        }
        cid = ccc;
    }

    __device__ void store(int64_t j, const float (&nv)[2]) const {
        oa[j] = nv[0];
        ob[j] = nv[1];
    }
};

// How B2 runs a plane of H x W: as B1, with 12 bytes a carried cell and
// copy (two fields and the ids) and 12 or 17 bytes of operands a voxel, so
// the strips hold square planes up to 656 x 656 for ball_rail and 688 x 688
// for max2 (132 SMs, 227 KB).
template <int KIND>
kt::StripPlan plan_dual(int H, int W) {
    return kt::plan_grid_strips<DualOp<KIND>>(H, W);
}

template <int KIND>
int dispatch_dual(const void* da, const void* db, const void* cc,
                  const void* nc, const void* ok, void* oa, void* ob,
                  void* mail, int n, int H, int W, const kt::Costs9& costs,
                  int descending, cudaStream_t st) {
    if (n <= 0 || H <= 0 || W <= 0) return 0;
    const kt::StripPlan plan = plan_dual<KIND>(H, W);
    if (plan.form != kt::kGridStrips) {
        return run_dual<KIND>(da, db, cc, nc, ok, oa, ob, n, H, W, costs,
                              descending, st);
    }
    const DualOp<KIND> op = {(const float*)da, (const float*)db,
                             (const int32_t*)cc, (const float*)nc,
                             (const uint8_t*)ok, (float*)oa, (float*)ob,
                             costs};
    return kt::run_grid_strips(op, (unsigned long long*)mail, n, H, W,
                               descending, plan, st);
}

}  // namespace

extern "C" {

// B1. d/out: float32 (int32 in minid mode); cc: int32; nc: float32 or
// NULL; ok: uint8 or NULL; all (n, H, W) contiguous. mode: 0 euclid, 1
// node, 2 maxflood, 3 minid. B1-vg: gate (uint32, G1's CCL form) with
// bits9 its nine bit indices in (dy, dz) order, minid mode only, with cc,
// nc and ok NULL and no clamp. mail: int64 (strips * 4 * W,) for the
// persistent form (kt_gsweep_sweep0_plan), zeroed by the caller before
// every call: the strips' edge-row mailboxes. Returns a cudaError_t code
// (0 = success).
int kt_gsweep_sweep0(const void* d, const void* cc, const void* nc,
                     const void* ok, const void* gate, void* mail, void* out,
                     int n, int H, int W, const float* costs9,
                     const int* bits9, int mode, int clamp, int descending,
                     void* stream) {
    const kt::Costs9 costs = kt::make_costs9(costs9);
    cudaStream_t st = (cudaStream_t)stream;
    if ((gate == nullptr) != (bits9 == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    if (gate != nullptr) {
        if (mode != kMinid || cc != nullptr || nc != nullptr ||
            ok != nullptr || clamp) {
            return (int)cudaErrorInvalidValue;
        }
        kt::Bits9 bits;
        for (int k = 0; k < 9; ++k) {
            bits.b[k] = bits9[k];
            if (bits.b[k] < 0 || bits.b[k] > 31) {
                return (int)cudaErrorInvalidValue;
            }
        }
        return dispatch_sweep0_gate(d, gate, mail, out, n, H, W, bits,
                                    descending, st);
    }
    if (cc == nullptr) return (int)cudaErrorInvalidValue;
    switch (mode) {
        case kEuclid:
            return dispatch_sweep0<kEuclid>(d, cc, nc, ok, mail, out, n, H, W,
                                            costs, clamp, descending, st);
        case kNode:
            if (nc == nullptr) return (int)cudaErrorInvalidValue;
            return dispatch_sweep0<kNode>(d, cc, nc, ok, mail, out, n, H, W,
                                          costs, clamp, descending, st);
        case kMaxflood:
            return dispatch_sweep0<kMaxflood>(d, cc, nc, ok, mail, out, n, H,
                                              W, costs, 0, descending, st);
        case kMinid:
            return dispatch_sweep0<kMinid>(d, cc, nc, ok, mail, out, n, H, W,
                                           costs, 0, descending, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// How B1 runs a plane of H x W in `mode` (with an okmask where has_ok; B1-vg
// where has_gate: minid mode only) on the current device: returns 1 for the
// persistent form (and its rows per strip and its strips), 0 for the
// per-plane form, -1 for a combination it does not run.
int kt_gsweep_sweep0_plan(int H, int W, int mode, int has_ok, int has_gate,
                          int* rows, int* strips) {
    kt::StripPlan plan = {kt::kPerPlane, {0, 0}, 0, 0};
    if (has_gate) {
        if (mode != kMinid || has_ok) return -1;
        plan = plan_sweep0_gate(H, W);
        *rows = plan.strips.rows;
        *strips = plan.strips.count;
        return plan.form == kt::kGridStrips ? 1 : 0;
    }
    switch (mode) {
        case kEuclid: plan = plan_sweep0_mode<kEuclid>(H, W, has_ok); break;
        case kNode: plan = plan_sweep0_mode<kNode>(H, W, has_ok); break;
        case kMaxflood: plan = plan_sweep0_mode<kMaxflood>(H, W, has_ok); break;
        case kMinid: plan = plan_sweep0_mode<kMinid>(H, W, has_ok); break;
        default: return -1;
    }
    *rows = plan.strips.rows;
    *strips = plan.strips.count;
    return plan.form == kt::kGridStrips ? 1 : 0;
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
    const kt::StripPlan plan =
        kind == 0 ? plan_dual<0>(H, W) : plan_dual<1>(H, W);
    *rows = plan.strips.rows;
    *strips = plan.strips.count;
    return plan.form == kt::kGridStrips ? 1 : 0;
}

}  // extern "C"
