// V1: one directed axis-0 sweep of the joint Voronoi relaxation of an
// (n, H, W) volume: a distance field and, beside it, the 1-based id of the
// nearest seed, relaxed together.
//
// Replaces the lax.scan of kimimaro_tpu/ops/geodesic.py `_voronoi_stage`
// (`sweep`), which `voronoi_feature_field` runs for `oversegment`; it has
// no Pallas original. For plane i > 0 and each voxel, over the nine (dy,
// dz) neighbours of plane i-1 in (-1, 0, 1) x (-1, 0, 1) order:
//
//   sd = shifted_dist + cost[k]        (f32; +inf outside the plane)
//   if (sd < best_d) best_d = sd, best_f = shifted_feature  (first wins)
//   take = ok && best_d < cur_d
//   d' = take ? best_d : (ok ? cur_d : +inf);  f' = take ? best_f : cur_f
//
// Plane 0 of the sweep passes through. A descending sweep walks the plane
// index downward instead of flipping the data. Built with --fmad=false;
// __fadd_rn keeps the f32 order. A sweep that alters any distance or
// feature sets `changed` to 1 (it is never cleared here): a round of six
// sweeps that leaves it 0 is the fixpoint, without a compare pass over the
// fields.
//
// What bounds it on the card: 17 bytes a voxel (d, f, ok in; d, f out),
// but, as for B5, the crops of oversegment are small planes (tens to a few
// hundred voxels a side), so a sweep's floor is its chain of n dependent
// planes. V1 is B5's Axis0Op with the feature as a second carried field:
// plane.cuh's strips carry two 32-bit fields (the feature bit for bit in
// the float channel, which only moves it), and their halo rows cross the
// mailboxes for both. One launch per sweep: a thread-block cluster where
// a strip of up to 16 CTAs takes one pass of its threads, grid-wide strips
// above, one launch per plane beyond both (`plan_v1`), with plane.cuh's
// kernels. Each CTA keeps its change flag in its own shared memory (the
// operator's hooks) and posts it once, at its end.

#include <map>
#include <mutex>
#include <tuple>

#include "plane.cuh"

namespace {

// the per-plane form: voxel (y, z) of `plane`, from `prev` in the output
__global__ void v1_plane(const float* __restrict__ d,
                         const int32_t* __restrict__ f,
                         const uint8_t* __restrict__ ok,
                         float* __restrict__ out_d,
                         int32_t* __restrict__ out_f,
                         int* __restrict__ changed, int H, int W,
                         int64_t plane, int64_t prev, kt::Costs9 costs) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const bool inside = y < H && z < W;
    int moved = 0;
    if (inside) {
        const int64_t HW = (int64_t)H * W;
        const int64_t i = plane * HW + (int64_t)y * W + z;
        const float cur_d = d[i];
        const int32_t cur_f = f[i];
        float nd = cur_d;
        int32_t nf = cur_f;
        if (prev >= 0) {
            float best_d = INFINITY;
            int32_t best_f = 0;
            int k = 0;
            for (int dy = -1; dy <= 1; ++dy) {
                for (int dz = -1; dz <= 1; ++dz, ++k) {
                    const int yy = y + dy, zz = z + dz;
                    float s = INFINITY;
                    int32_t sf = 0;
                    if (yy >= 0 && yy < H && zz >= 0 && zz < W) {
                        const int64_t j = prev * HW + (int64_t)yy * W + zz;
                        s = out_d[j];
                        sf = out_f[j];
                    }
                    const float sd = __fadd_rn(s, costs.c[k]);
                    if (sd < best_d) {
                        best_d = sd;
                        best_f = sf;
                    }
                }
            }
            const bool okv = ok[i] != 0;
            const bool take = okv && best_d < cur_d;
            nd = take ? best_d : (okv ? cur_d : INFINITY);
            nf = take ? best_f : cur_f;
        }
        out_d[i] = nd;
        out_f[i] = nf;
        moved = nd != cur_d || nf != cur_f;
    }
    if (__syncthreads_or(moved) && threadIdx.x == 0 && threadIdx.y == 0) {
        *changed = 1;
    }
}

// V1 in the strips: the operator of kt::sweep_strips. Operands in this
// order: d, f words, ok bytes. The feature rides field 1 of the carried
// plane as the bits of a float. Its own shared memory is the CTA's change
// flag (`begin`), posted to `changed` once the CTA is done (`finish`).
struct VoronoiOp {
    using T = float;
    static constexpr int kFields = 2;
    static constexpr bool kIds = false;
    static constexpr int kWords = 2;
    static constexpr int kBytes = 1;
    static constexpr size_t kExtraBytes = 16;

    const float* d;
    const int32_t* f;
    const uint8_t* ok;
    float* out_d;
    int32_t* out_f;
    kt::Costs9 costs;
    int* changed;
    int* flag;

    __device__ void begin(unsigned char* extra) {
        flag = (int*)extra;
        if (threadIdx.x == 0) *flag = 0;
    }

    __device__ void finish() const {
        if (threadIdx.x == 0 && *flag) *changed = 1;
    }

    __device__ float fill() const { return INFINITY; }

    __device__ const void* operand(int k) const {
        if (k == 0) return d;
        if (k == 1) return f;
        return ok;
    }

    __device__ int32_t halo_id(int64_t) const { return 0; }

    // the arithmetic of `v1_plane`, in its order; a neighbour's feature
    // counts only where its distance is finite, so the fill's bits in
    // field 1 are never taken
    __device__ __forceinline__ void relax(
        bool first, const kt::StageView<kWords + kBytes>& in, int i,
        const float (&v)[2][kt::kGroup + 2][3],
        const int32_t (&)[kt::kGroup + 2][3], int rr, float (&nv)[2],
        int32_t&) const {
        const float cur_d = ((const float*)in.p[0])[i];
        const int32_t cur_f = ((const int32_t*)in.p[1])[i];
        if (first) {
            nv[0] = cur_d;
            nv[1] = __int_as_float(cur_f);
            return;
        }
        float best_d = INFINITY;
        int32_t best_f = 0;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dz = 0; dz < 3; ++dz) {
                const float sd = __fadd_rn(v[0][rr + dy][dz],
                                           costs.c[3 * dy + dz]);
                if (sd < best_d) {
                    best_d = sd;
                    best_f = __float_as_int(v[1][rr + dy][dz]);
                }
            }
        }
        const bool okv = in.p[kWords][i] != 0;
        const bool take = okv && best_d < cur_d;
        const float nd = take ? best_d : (okv ? cur_d : INFINITY);
        const int32_t nf = take ? best_f : cur_f;
        if (nd != cur_d || nf != cur_f) *flag = 1;
        nv[0] = nd;
        nv[1] = __int_as_float(nf);
    }

    __device__ void store(int64_t j, const float (&nv)[2]) const {
        out_d[j] = nv[0];
        out_f[j] = __float_as_int(nv[1]);
    }
};

// How V1 runs a plane of H x W: one cluster, grid-wide strips or per plane
// (the first the shape and the device allow). Kept per (device, H, W).
kt::StripPlan plan_v1(int H, int W) {
    static std::mutex lock;
    static std::map<std::tuple<int, int, int>, kt::StripPlan> plans;
    int dev = 0;
    cudaGetDevice(&dev);
    const std::tuple<int, int, int> key(dev, H, W);
    std::lock_guard<std::mutex> guard(lock);
    const auto found = plans.find(key);
    if (found != plans.end()) return found->second;
    kt::StripPlan plan = kt::plan_cluster<VoronoiOp>(H, W);
    if (plan.form != kt::kCluster) {
        plan = kt::plan_grid_strips<VoronoiOp>(H, W);
    }
    plans[key] = plan;
    return plan;
}

// ---------------------------------------------------------------------------
// The lane-batched form: one launch per directed sweep for every lane of a
// batch (oversegment's crops, each in its own extent within its bucket).
//
// Lane i is the (n, H, W) box at element base_i of flat d/f/ok storage, its
// rows row_i and its planes plane_i elements apart (ops.voronoi
// .VoronoiLanes). The sweep is in place: a CTA walks the planes of its
// lanes in order, reading each plane's own values before writing them, and
// writes a voxel only where its distance or feature changes. Nothing
// outside a lane's extent is read as a candidate or written.
//
// What bounds it: 17 bytes a voxel at most (d, f, ok read; d, f written
// where they change), against the chain of n dependent planes of each lane.
// The crops of oversegment are small (planes of a few hundred to about
// 15,000 voxels, tens of planes), so a lane's chain is short and many
// lanes must be in flight at once to fill the card: one CTA walks a whole
// lane, with one __syncthreads() a plane and no exchange with other CTAs.
// The host packs lanes of similar plane counts into CTAs up to the shared
// memory one CTA may hold (`pack_lanes`), so several small lanes share a
// CTA and its SM; each CTA carries the previous plane of each of its lanes
// (d and f, 8 bytes a cell) in shared memory, twice (the plane being
// relaxed is written into the other copy), and each thread relaxes a few
// cells of every plane. A lane's plane must fit one CTA's shared memory
// (`capacity` cells): a crop with a larger plane takes V1's single-volume
// forms above, whose clusters and strips spread a plane over many SMs.
// The previous plane's feature is read only for the winning neighbour.
// Each CTA posts each of its lanes' change flags once, at its end; a lane
// that is not active is not swept.
constexpr int kLaneThreads = 1024;
constexpr int kMaxPack = 32;
// static shared memory of `v1_lanes` and a margin, kept out of the carried
// planes
constexpr int kLaneStaticBytes = 2048;

__global__ void __launch_bounds__(kLaneThreads, 1)
v1_lanes(float* d, int32_t* f, const uint8_t* __restrict__ ok,
         const long long* __restrict__ lanes, const int* __restrict__ order,
         const int* __restrict__ packs, int* __restrict__ changed,
         const uint8_t* __restrict__ active, int capacity, kt::Costs9 costs,
         int descending) {
    __shared__ long long s_base[kMaxPack], s_plane[kMaxPack];
    __shared__ int s_lane[kMaxPack], s_n[kMaxPack], s_H[kMaxPack],
        s_W[kMaxPack], s_row[kMaxPack], s_moved[kMaxPack];
    __shared__ int s_voff[kMaxPack + 1];
    __shared__ int s_maxn;
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x;
    const int first = packs[2 * blockIdx.x];
    const int count = packs[2 * blockIdx.x + 1];
    if (tid < count) {
        const int lane = order[first + tid];
        const long long* e = lanes + 6 * (long long)lane;
        const bool on = active == nullptr || active[lane] != 0;
        s_lane[tid] = lane;
        s_base[tid] = e[0];
        s_n[tid] = on ? (int)e[1] : 0;
        s_H[tid] = (int)e[2];
        s_W[tid] = (int)e[3];
        s_row[tid] = (int)e[4];
        s_plane[tid] = e[5];
        s_moved[tid] = 0;
    }
    __syncthreads();
    if (tid == 0) {
        int off = 0, most = 0;
        for (int j = 0; j < count; ++j) {
            s_voff[j] = off;
            off += s_H[j] * s_W[j];
            most = max(most, s_n[j]);
        }
        s_voff[count] = off;
        s_maxn = most;
    }
    __syncthreads();
    const int cells = s_voff[count];
    const int steps = s_maxn;
    // the carried planes: d of the two copies, then f of the two copies
    float* cd = (float*)smem;
    int32_t* cf = (int32_t*)(smem + (size_t)8 * capacity);
    for (int s = 0; s < steps; ++s) {
        const int into = (s & 1) * capacity, from = capacity - into;
        int j = 0;
        for (int v = tid; v < cells; v += blockDim.x) {
            while (v >= s_voff[j + 1]) ++j;
            const int n = s_n[j];
            if (s >= n) continue;
            const int H = s_H[j], W = s_W[j], voff = s_voff[j];
            const int local = v - voff;
            const int y = local / W, z = local - y * W;
            const long long base = s_base[j], pstride = s_plane[j];
            const long long row = s_row[j];
            const long long pl = descending ? n - 1 - s : s;
            const long long gi = base + pl * pstride + y * row + z;
            const float cur_d = d[gi];
            const int32_t cur_f = f[gi];
            float nd = cur_d;
            int32_t nf = cur_f;
            if (s > 0) {
                float best = INFINITY;
                int win = 0;
#pragma unroll
                for (int dy = -1; dy <= 1; ++dy) {
                    const int yy = y + dy;
                    if (yy < 0 || yy >= H) continue;
#pragma unroll
                    for (int dz = -1; dz <= 1; ++dz) {
                        const int zz = z + dz;
                        if (zz < 0 || zz >= W) continue;
                        const float sd =
                            __fadd_rn(cd[from + voff + yy * W + zz],
                                      costs.c[3 * (dy + 1) + dz + 1]);
                        if (sd < best) {
                            best = sd;
                            win = 3 * (dy + 1) + dz + 1;
                        }
                    }
                }
                const bool okv = ok[gi] != 0;
                const bool take = okv && best < cur_d;
                nd = take ? best : (okv ? cur_d : INFINITY);
                if (take) {
                    const int wy = y + win / 3 - 1, wz = z + win % 3 - 1;
                    nf = cf[from + voff + wy * W + wz];
                }
                if (nd != cur_d || nf != cur_f) {
                    d[gi] = nd;
                    f[gi] = nf;
                    s_moved[j] = 1;
                }
            }
            cd[into + v] = nd;
            cf[into + v] = nf;
        }
        __syncthreads();
    }
    if (tid < count && s_moved[tid]) changed[s_lane[tid]] = 1;
}

}  // namespace

extern "C" {

// V1. d/out_d: float32, f/out_f: int32, ok: uint8 (bool), all (n, H, W)
// contiguous; costs9: the nine step costs in (dy, dz) order. changed: one
// int32 the kernel sets to 1 where the sweep alters a value.
// mail: int64 (strips * 8 * W,) for the grid-wide strips (kt_voronoi_plan
// form 1), zeroed by the caller before every call, else ignored. Returns a
// cudaError_t code (0 = success).
int kt_voronoi_sweep(const void* d, const void* f, const void* ok,
                     void* mail, void* out_d, void* out_f, void* changed,
                     int n, int H, int W, const float* costs9,
                     int descending, void* stream) {
    if (changed == nullptr) return (int)cudaErrorInvalidValue;
    if (n <= 0 || H <= 0 || W <= 0) return 0;
    const kt::Costs9 costs = kt::make_costs9(costs9);
    cudaStream_t st = (cudaStream_t)stream;
    const kt::StripPlan plan = plan_v1(H, W);
    if (plan.form == kt::kPerPlane) {
        const dim3 grid = kt::plane_grid(H, W);
        const dim3 block = kt::plane_block();
        for (int s = 0; s < n; ++s) {
            int64_t plane, prev;
            kt::sweep_planes(s, n, descending, &plane, &prev);
            v1_plane<<<grid, block, 0, st>>>(
                (const float*)d, (const int32_t*)f, (const uint8_t*)ok,
                (float*)out_d, (int32_t*)out_f, (int*)changed, H, W, plane,
                prev, costs);
            const cudaError_t e = cudaGetLastError();
            if (e != cudaSuccess) return (int)e;
        }
        return 0;
    }
    const VoronoiOp op = {(const float*)d,    (const int32_t*)f,
                          (const uint8_t*)ok, (float*)out_d,
                          (int32_t*)out_f,    costs,
                          (int*)changed,      nullptr};
    if (plan.form == kt::kCluster) {
        return kt::run_cluster(op, n, H, W, descending, plan, st);
    }
    return kt::run_grid_strips(op, (unsigned long long*)mail, n, H, W,
                               descending, plan, st);
}

// V1, lane-batched. d: float32, f: int32, ok: uint8 (bool), flat storage
// the lanes lie in; lanes: int64 (L, 6) (base, n, H, W, row, plane); order:
// int32, the lanes of the packs in turn; packs: int32 (P, 2) (first index
// into order, lanes <= kMaxPack); changed: int32 (L,), entry i set to 1
// where lane i changes; active: uint8 (L,) or NULL (every lane active);
// capacity: the cells of the shared-memory planes (at most the value of
// kt_voronoi_lanes_limits), which every pack's planes fit. In place. Returns a cudaError_t code (0 = success).
int kt_voronoi_lanes(void* d, void* f, const void* ok, const void* lanes,
                     const void* order, const void* packs, int P,
                     void* changed, const void* active, int capacity,
                     const float* costs9, int descending, void* stream) {
    if (P < 0 || capacity < 0 || changed == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    if (P == 0) return 0;
    const size_t smem = (size_t)16 * capacity;
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)v1_lanes, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    v1_lanes<<<P, kLaneThreads, smem, (cudaStream_t)stream>>>(
        (float*)d, (int32_t*)f, (const uint8_t*)ok, (const long long*)lanes,
        (const int*)order, (const int*)packs, (int*)changed,
        (const uint8_t*)active, capacity, kt::make_costs9(costs9),
        descending);
    return (int)cudaGetLastError();
}

// The lane-batched V1's limits on the current device: returns the most
// cells a CTA carries in shared memory (two copies of d and f), with its
// threads and the most lanes of a pack.
int kt_voronoi_lanes_limits(int* threads, int* max_pack) {
    *threads = kLaneThreads;
    *max_pack = kMaxPack;
    const int optin = kt::optin_smem();
    if (optin <= kLaneStaticBytes) return -1;
    return (optin - kLaneStaticBytes) / 16;
}

// How V1 runs a plane of H x W on the current device: returns the form (0
// per plane, 1 grid-wide strips, 2 one cluster) with its rows per strip and
// its strips (CTAs).
int kt_voronoi_plan(int H, int W, int* rows, int* ctas) {
    if (H < 1 || W < 1) return -1;
    const kt::StripPlan plan = plan_v1(H, W);
    *rows = plan.strips.rows;
    *ctas = plan.strips.count;
    return plan.form;
}

}  // extern "C"
