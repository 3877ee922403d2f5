// B5: one directed axis-0 sweep of a single (n, H, W) volume, gated by an
// ok mask (no component ids). B4 (below) is its lane-batched form.
//
// Replaces the Pallas kernel kimimaro_tpu/ops/pallas_sweep.py `sweep_axis0`
// (`_sweep_kernel_factory`), which the host trace path relaxes label crops
// with (kimimaro_tpu/ops/geodesic.py `_sweep`).
//
//   node mode   new = min(cur, min9(prev) + nodecost)
//   euclid mode new = min(cur, min9(prev + step_cost))
//   new = ok ? new : +inf; clamp_positive resets positives to +inf.
//
// Every in-volume neighbour counts; out of the volume is +inf. The first
// plane of the sweep passes through unchanged (no ok mask, no clamp). A
// descending sweep walks the plane index downward instead of flipping the
// data. Built with --fmad=false; __fadd_rn keeps the f32 order (step cost
// before the min, nodecost after it).
//
// What bounds it on the card: label crops are small to medium planes (tens
// to a few hundred voxels a side), so a sweep's floor is its chain of n
// dependent planes, not its bytes (a 96^3 crop is 12 MB, 4 us at the HBM
// rate). One launch per plane paid about 4 us a plane. B5 makes one launch
// per sweep in one of three forms, chosen by `plan_axis0` from the shape:
//
//   * one thread-block cluster of up to 16 CTAs (plane.cuh `cluster_strips`)
//     where each CTA relaxes its strip of ceil(H / 16) rows in one pass of
//     its threads (ceil(R / 4) x W <= 512: square planes up to 170 x 170,
//     rows up to 512 wide): a CTA's halo mailboxes lie in its own shared
//     memory and its neighbours post their edge rows there through
//     distributed shared memory, so a plane costs its stencil and a spin
//     on shared memory, no launch and no trip through L2 (about 1.1 us a
//     plane at 96 x 96 on the H100, against 1.4 us for the grid strips);
//   * B1's grid-wide persistent strips (plane.cuh `grid_strips`, mailboxes
//     in device memory) without the cc gating, for larger planes (up to
//     1184 x 1184 in euclid mode and 1024 x 1024 in node mode on 132 SMs);
//   * one launch per plane (`batched_plane`, one lane) above that.
//
// B4 and B5 with a voxel graph (VG): the crop engine and the host trace
// path of a label under a graph (kimimaro_tpu/ops/geodesic.py `_sweep` with
// `voxel_graph`, a lax.scan in the JAX package). As in B1-vg, the gate sits
// at the target: a per-voxel word `gate` (ops.stencils.graph_into: bit
// GRAPH_BITS[o] set where the move from v + o into v is open) is one more
// operand of the stage, read with the voxel's own operands, and `bits`
// names the bit of each of the nine (dy, dz) neighbours on the previous
// plane for this layout and direction. The carried plane holds the field
// only and nothing new crosses a strip's halo: 4 bytes a voxel more in a
// stage (grid strips up to 1024 x 1024 in euclid mode and 912 x 912 in
// node mode on 132 SMs).

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "plane.cuh"

namespace {

using kt::Bits9;

// One voxel of a directed plane sweep of the volume that starts at `base`
// in the buffers. With VG, a candidate from the neighbour k on the previous
// plane counts only where bit bits.b[k] of the voxel's gate word is set.
template <bool NODE, bool CLAMP, bool VG>
__device__ __forceinline__ void sweep_cell(
    const float* __restrict__ d, const uint8_t* __restrict__ ok,
    const float* __restrict__ nc, const uint32_t* __restrict__ gate,
    float* __restrict__ out, int H, int W, int64_t base, int64_t plane,
    int64_t prev, int y, int z, const kt::Costs9& costs, const Bits9& bits) {
    const int64_t HW = (int64_t)H * W;
    const int64_t i = base + plane * HW + (int64_t)y * W + z;
    const float cur = d[i];
    if (prev < 0) {
        out[i] = cur;
        return;
    }
    const uint32_t g = VG ? gate[i] : 0u;
    float cand = INFINITY;
    int k = 0;
    for (int dy = -1; dy <= 1; ++dy) {
        for (int dz = -1; dz <= 1; ++dz, ++k) {
            const int yy = y + dy;
            const int zz = z + dz;
            float s = INFINITY;
            if (yy >= 0 && yy < H && zz >= 0 && zz < W &&
                (!VG || ((g >> bits.b[k]) & 1u) != 0u)) {
                s = out[base + prev * HW + (int64_t)yy * W + zz];
            }
            cand = NODE ? fminf(cand, s)
                        : fminf(cand, __fadd_rn(s, costs.c[k]));
        }
    }
    if (NODE) cand = __fadd_rn(cand, nc[i]);
    float nv = ok[i] ? fminf(cur, cand) : INFINITY;
    if (CLAMP && nv > 0.0f) nv = INFINITY;
    out[i] = nv;
}

// B5 in the strips (cluster or grid-wide): the operator of
// kt::sweep_strips. Operands in this order: d (, nc) (, gate) words, ok
// bytes.
template <bool NODE, bool CLAMP, bool VG>
struct Axis0Op {
    using T = float;
    static constexpr int kFields = 1;
    static constexpr bool kIds = false;
    static constexpr int kGate = NODE ? 2 : 1;  // the gate's operand index
    static constexpr int kWords = 1 + (NODE ? 1 : 0) + (VG ? 1 : 0);
    static constexpr int kBytes = 1;

    const float* d;
    const uint8_t* ok;
    const float* nc;
    const uint32_t* gate;
    float* out;
    kt::Costs9 costs;
    Bits9 bits;

    __device__ float fill() const { return INFINITY; }

    __device__ const void* operand(int k) const {
        if (k == 0) return d;
        if (NODE && k == 1) return nc;
        if (VG && k == kGate) return gate;
        return ok;
    }

    // the arithmetic of `sweep_cell`, in its order
    __device__ __forceinline__ void relax(
        bool first, const kt::StageView<kWords + kBytes>& in, int i,
        const float (&v)[1][kt::kGroup + 2][3],
        const int32_t (&)[kt::kGroup + 2][3], int rr, float (&nv)[1],
        int32_t&) const {
        const float cur = ((const float*)in.p[0])[i];
        if (first) {
            nv[0] = cur;
            return;
        }
        uint32_t g = 0u;
        if constexpr (VG) g = ((const uint32_t*)in.p[kGate])[i];
        float cand = INFINITY;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dz = 0; dz < 3; ++dz) {
                float sv = v[0][rr + dy][dz];
                if (VG && ((g >> bits.b[3 * dy + dz]) & 1u) == 0u) {
                    sv = INFINITY;
                }
                cand = NODE ? fminf(cand, sv)
                            : fminf(cand, __fadd_rn(sv, costs.c[3 * dy + dz]));
            }
        }
        if (NODE) cand = __fadd_rn(cand, ((const float*)in.p[1])[i]);
        float r = in.p[kWords][i] ? fminf(cur, cand) : INFINITY;
        if (CLAMP && r > 0.0f) r = INFINITY;
        nv[0] = r;
    }

    __device__ void store(int64_t j, const float (&nv)[1]) const {
        out[j] = nv[0];
    }
};

// B4: the lane-batched form. Replaces the Pallas kernel
// kimimaro_tpu/ops/pallas_sweep.py `sweep_axis0_batched`
// (`_batched_kernel_factory`), the crop engine's relax
// (kimimaro_tpu/ops/geodesic.py `_batched_relax_pallas`). Each lane is an
// independent (n, H, W) volume of a (B, n, H, W) batch, gated as B5 is.
//
// What bounds it: like B5, the chain of n dependent planes of each lane,
// not the bytes. B4 makes one launch per directed sweep for all lanes, in
// one of three forms chosen by `plan_batched` (ops.sweep
// .sweep_axis0_batched_plan):
//
//   * a grid of thread-block clusters, one cluster per lane (blockIdx.y):
//     B5's cluster strips, each lane's CTAs posting edge rows into their
//     neighbours' shared memory. The CTAs a lane are the most (up to 16,
//     one pass of 512 threads a strip) that keep B x CTAs within one wave
//     of the SMs, but at least the fewest that hold a strip in one pass:
//     many small lanes take few CTAs each, few large lanes many;
//   * per-lane grid-wide strips (one cooperative launch, B x CTAs
//     co-resident, edge rows through mailboxes in device memory) where a
//     cluster cannot hold the plane in one pass;
//   * one launch per plane for all lanes (blockIdx.z = lane) beyond both;
//     B5's per-plane form is this with one lane.
template <bool NODE, bool CLAMP, bool VG>
__global__ void batched_plane(const float* __restrict__ d,
                              const uint8_t* __restrict__ ok,
                              const float* __restrict__ nc,
                              const uint32_t* __restrict__ gate,
                              float* __restrict__ out, int n, int H, int W,
                              int64_t plane, int64_t prev, kt::Costs9 costs,
                              Bits9 bits) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (y >= H || z >= W) return;
    const int64_t base = (int64_t)blockIdx.z * n * H * W;
    sweep_cell<NODE, CLAMP, VG>(d, ok, nc, gate, out, H, W, base, plane,
                                prev, y, z, costs, bits);
}

template <bool NODE, bool CLAMP, bool VG>
int run_batched(const Axis0Op<NODE, CLAMP, VG>& op, int B, int n, int H,
                int W, int descending, cudaStream_t st) {
    dim3 grid = kt::plane_grid(H, W);
    grid.z = B;
    const dim3 block = kt::plane_block();
    for (int s = 0; s < n; ++s) {
        int64_t plane, prev;
        kt::sweep_planes(s, n, descending, &plane, &prev);
        batched_plane<NODE, CLAMP, VG><<<grid, block, 0, st>>>(
            op.d, op.ok, op.nc, op.gate, op.out, n, H, W, plane, prev,
            op.costs, op.bits);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

// How B5 runs a plane of H x W: one cluster, grid-wide strips or per plane
// (the form in the order of preference that the shape and the device
// allow). The answer depends on the shape and the device only, and costs
// device queries, so it is kept per (device, H, W, mode, vg).
template <bool NODE, bool VG>
kt::StripPlan plan_axis0(int H, int W) {
    static std::mutex lock;
    static std::map<std::tuple<int, int, int>, kt::StripPlan> plans;
    int dev = 0;
    cudaGetDevice(&dev);
    const std::tuple<int, int, int> key(dev, H, W);
    std::lock_guard<std::mutex> guard(lock);
    const auto found = plans.find(key);
    if (found != plans.end()) return found->second;
    using Op = Axis0Op<NODE, false, VG>;
    kt::StripPlan plan = kt::plan_cluster<Op>(H, W);
    if (plan.form != kt::kCluster) plan = kt::plan_grid_strips<Op>(H, W);
    plans[key] = plan;
    return plan;
}

template <bool NODE, bool CLAMP, bool VG>
int dispatch_axis0(const Axis0Op<NODE, CLAMP, VG>& op, void* mail, int n,
                   int H, int W, int descending, cudaStream_t st) {
    if (n <= 0 || H <= 0 || W <= 0) return 0;
    const kt::StripPlan plan = plan_axis0<NODE, VG>(H, W);
    if (plan.form == kt::kPerPlane) {
        return run_batched(op, 1, n, H, W, descending, st);
    }
    if (plan.form == kt::kCluster) {
        return kt::run_cluster(op, n, H, W, descending, plan, st);
    }
    return kt::run_grid_strips(op, (unsigned long long*)mail, n, H, W,
                               descending, plan, st);
}

// B4 in the strips: B5's operator for one lane (`at_lane` moves it there).
template <bool NODE, bool CLAMP, bool VG>
struct BatchedOp : Axis0Op<NODE, CLAMP, VG> {
    int64_t lane_elems;  // n * H * W

    __device__ BatchedOp at_lane(int b) const {
        BatchedOp o = *this;
        const int64_t e = (int64_t)b * lane_elems;
        o.d += e;
        o.ok += e;
        if (NODE) o.nc += e;
        if (VG) o.gate += e;
        o.out += e;
        return o;
    }
};

// plane.cuh's cluster strips, one cluster per lane (blockIdx.y)
template <class Op>
__global__ void __launch_bounds__(kt::kStripThreads, 1)
batched_cluster(Op op, int n, int H, int W, int R, int descending) {
    namespace cg = cooperative_groups;
    extern __shared__ __align__(16) unsigned char smem[];
    const int g = blockIdx.x, G = gridDim.x;
    const int64_t FW = (int64_t)Op::kFields * W;
    unsigned long long* boxes =
        (unsigned long long*)(smem + kt::op_layout<Op>(R, W).total);
    for (int64_t i = threadIdx.x; i < 4 * FW; i += blockDim.x) boxes[i] = 0;
    cg::cluster_group cluster = cg::this_cluster();
    unsigned long long* up =
        g > 0 ? cluster.map_shared_rank(boxes, g - 1) : nullptr;
    unsigned long long* down =
        g + 1 < G ? cluster.map_shared_rank(boxes, g + 1) : nullptr;
    kt::MailHalo<typename Op::T, Op::kFields, true> halo{
        boxes, boxes + 2 * FW, up == nullptr ? nullptr : up + 2 * FW, down,
        g, G, W, n, nullptr, nullptr};
    kt::cluster_arrive();
    kt::cluster_wait();
    kt::sweep_strips<Op>(op.at_lane(blockIdx.y), halo, g, n, H, W, R,
                         descending);
    kt::cluster_arrive();
    kt::cluster_wait();
}

// plane.cuh's grid-wide strips, the strips of lane blockIdx.y; its
// mailboxes follow the other lanes' in `mail`
template <class Op>
__global__ void __launch_bounds__(kt::kStripThreads, 1)
batched_grid(Op op, unsigned long long* mail, int n, int H, int W, int R,
             int descending) {
    const int g = blockIdx.x, G = gridDim.x;
    const int64_t FW = (int64_t)Op::kFields * W;
    unsigned long long* lane_mail = mail + (int64_t)blockIdx.y * G * 4 * FW;
    auto box = [&](int strip, int bottom) {
        return lane_mail + (int64_t)(strip * 2 + bottom) * 2 * FW;
    };
    kt::MailHalo<typename Op::T, Op::kFields, false> halo{
        g > 0 ? box(g - 1, 1) : nullptr, g + 1 < G ? box(g + 1, 0) : nullptr,
        box(g, 0), box(g, 1), g, G, W, n, nullptr, nullptr};
    kt::sweep_strips<Op>(op.at_lane(blockIdx.y), halo, g, n, H, W, R,
                         descending);
}

// can `kern` hold one cluster of `ctas` CTAs of `threads` and `smem`?
inline bool cluster_fits(const void* kern, int ctas, int threads,
                         size_t smem) {
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess ||
        cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) != cudaSuccess) {
        cudaGetLastError();
        return false;
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) !=
        cudaSuccess) {
        cudaGetLastError();
        return false;
    }
    return clusters >= 1;
}

// How B4 runs B lanes of (H, W) planes (see above). The fewest CTAs a lane
// that hold a strip in one pass are the floor; above it, the most (up to
// 16) with B x CTAs <= SMs. Grid strips: the rows that spread the
// co-resident CTAs evenly over the lanes. Kept per (device, B, H, W,
// mode, vg).
template <bool NODE, bool VG>
kt::StripPlan plan_batched(int B, int H, int W) {
    static std::mutex lock;
    static std::map<std::tuple<int, int, int, int>, kt::StripPlan> plans;
    int dev = 0;
    cudaGetDevice(&dev);
    const std::tuple<int, int, int, int> key(dev, B, H, W);
    std::lock_guard<std::mutex> guard(lock);
    const auto found = plans.find(key);
    if (found != plans.end()) return found->second;
    using Op = BatchedOp<NODE, false, VG>;
    kt::StripPlan plan = {kt::kPerPlane, {0, 0}, 0, 0};
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const size_t optin = (size_t)kt::optin_smem();
    const void* kern = (const void*)batched_cluster<Op>;
    kt::StripPlan best = plan;
    for (int c = 1; c <= 16 && c <= H; ++c) {
        const kt::Strips strips = kt::make_strips(H, c);
        if (strips.count != c) continue;  // c is not a strip count of H
        if ((int64_t)((strips.rows + kt::kGroup - 1) / kt::kGroup) * W >
            kt::kStripThreads) {
            continue;  // a strip takes more than one pass
        }
        const size_t smem = kt::op_layout<Op>(strips.rows, W).total +
                            kt::cluster_box_bytes<Op>(W);
        if (smem > optin) continue;
        if (best.form == kt::kCluster && (int64_t)B * c > sms) break;
        const int threads = kt::strip_threads(strips.rows, W);
        if (!cluster_fits(kern, c, threads, smem)) continue;
        best = {kt::kCluster, strips, threads, smem};
    }
    if (best.form == kt::kCluster) {
        plan = best;
    } else if (kt::coresident_ctas() >= B) {
        const int per_lane = kt::coresident_ctas() / B;
        kt::StripPlan grid = {kt::kGridStrips, kt::make_strips(H, per_lane),
                              0, 0};
        grid.threads = kt::strip_threads(grid.strips.rows, W);
        grid.smem = kt::op_layout<Op>(grid.strips.rows, W).total;
        if (grid.smem <= optin) plan = grid;
    }
    plans[key] = plan;
    return plan;
}

template <bool NODE, bool CLAMP, bool VG>
int dispatch_batched(const BatchedOp<NODE, CLAMP, VG>& op, void* mail, int B,
                     int n, int H, int W, int descending, cudaStream_t st) {
    if (n <= 0 || H <= 0 || W <= 0) return 0;
    const kt::StripPlan plan = plan_batched<NODE, VG>(B, H, W);
    if (plan.form == kt::kPerPlane) {
        return run_batched<NODE, CLAMP, VG>(op, B, n, H, W, descending, st);
    }
    using Op = BatchedOp<NODE, CLAMP, VG>;
    int R = plan.strips.rows;
    if (plan.form == kt::kCluster) {
        void (*kern)(Op, int, int, int, int, int) = batched_cluster<Op>;
        cudaError_t e = cudaFuncSetAttribute(
            (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)plan.smem);
        if (e == cudaSuccess) {
            e = cudaFuncSetAttribute(
                (const void*)kern,
                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        }
        if (e != cudaSuccess) return (int)e;
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = plan.strips.count;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(plan.strips.count, B);
        cfg.blockDim = dim3(plan.threads);
        cfg.dynamicSmemBytes = plan.smem;
        cfg.stream = st;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        return (int)cudaLaunchKernelEx(&cfg, kern, op, n, H, W, R,
                                       descending);
    }
    if (mail == nullptr) return (int)cudaErrorInvalidValue;
    const void* kern = (const void*)batched_grid<Op>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (e != cudaSuccess) return (int)e;
    Op o = op;
    unsigned long long* m = (unsigned long long*)mail;
    void* args[] = {&o, &m, &n, &H, &W, &R, &descending};
    return (int)cudaLaunchCooperativeKernel(kern,
                                            dim3(plan.strips.count, B),
                                            dim3(plan.threads), args,
                                            plan.smem, st);
}

// fn(node, clamp, vg) with each flag as a std::integral_constant, so that
// fn instantiates the template of those flags
template <class Fn>
int by_flags(int node, int clamp, int vg, Fn fn) {
    using Y = std::true_type;
    using N = std::false_type;
    auto with_vg = [&](auto nd, auto cl) {
        return vg ? fn(nd, cl, Y{}) : fn(nd, cl, N{});
    };
    auto with_clamp = [&](auto nd) {
        return clamp ? with_vg(nd, Y{}) : with_vg(nd, N{});
    };
    return node ? with_clamp(Y{}) : with_clamp(N{});
}

// the operator's step costs and gate bits from the host's arrays, or a
// cudaError_t code
int read_costs_bits(const float* costs9, const int* bits9, kt::Costs9* costs,
                    Bits9* bits) {
    *costs = kt::make_costs9(costs9);
    for (int k = 0; k < 9; ++k) {
        bits->b[k] = bits9 ? bits9[k] : 0;
        if (bits->b[k] < 0 || bits->b[k] > 31) {
            return (int)cudaErrorInvalidValue;
        }
    }
    return 0;
}

}  // namespace

extern "C" {

// B4. d/out/nc: float32, ok: uint8 (bool), gate: uint32 (graph_into words
// of each lane), all (B, n, H, W) contiguous; nc may be NULL when node_mode
// is 0, gate and bits9 are both NULL or both given (bits9: the gate bit of
// each of the nine previous-plane neighbours in (dy, dz) order). mail:
// int64 (B * strips * 4 * W,) for the per-lane grid strips
// (kt_sweep_axis0_batched_plan form 1), zeroed by the caller before every
// call, else ignored. Returns a cudaError_t code (0 = success).
int kt_sweep_axis0_batched(const void* d, const void* ok, const void* nc,
                           const void* gate, void* mail, void* out, int B,
                           int n, int H, int W, const float* costs9,
                           const int* bits9, int node_mode, int clamp,
                           int descending, void* stream) {
    if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    if (node_mode && nc == nullptr) return (int)cudaErrorInvalidValue;
    if ((gate == nullptr) != (bits9 == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    kt::Costs9 costs;
    Bits9 bits;
    const int bad = read_costs_bits(costs9, bits9, &costs, &bits);
    if (bad) return bad;
    return by_flags(node_mode, clamp, gate != nullptr,
                    [&](auto nd, auto cl, auto vg) {
        const BatchedOp<decltype(nd)::value, decltype(cl)::value,
                        decltype(vg)::value> op = {
            {(const float*)d, (const uint8_t*)ok, (const float*)nc,
             (const uint32_t*)gate, (float*)out, costs, bits},
            (int64_t)n * H * W};
        return dispatch_batched(op, mail, B, n, H, W, descending,
                                (cudaStream_t)stream);
    });
}

// How B4 runs B lanes of (H, W) planes on the current device: returns the
// form (0 per plane, 1 per-lane grid strips, 2 one cluster a lane) with its
// rows per strip and its strips (CTAs) a lane.
int kt_sweep_axis0_batched_plan(int B, int H, int W, int node_mode,
                                int has_vg, int* rows, int* ctas) {
    if (B < 1 || H < 1 || W < 1) return -1;
    kt::StripPlan plan;
    if (node_mode) {
        plan = has_vg ? plan_batched<true, true>(B, H, W)
                      : plan_batched<true, false>(B, H, W);
    } else {
        plan = has_vg ? plan_batched<false, true>(B, H, W)
                      : plan_batched<false, false>(B, H, W);
    }
    *rows = plan.strips.rows;
    *ctas = plan.strips.count;
    return plan.form;
}

// B5. d/out/nc: float32, ok: uint8 (bool), gate: uint32 (graph_into
// words), all (n, H, W) contiguous; nc may be NULL when node_mode is 0,
// gate and bits9 are both NULL or both given (bits9: the gate bit of each
// of the nine previous-plane neighbours in (dy, dz) order). mail: int64
// (strips * 4 * W,) for the grid-wide strips (kt_sweep_axis0_plan form 1),
// zeroed by the caller before every call, else ignored. Returns a
// cudaError_t code (0 = success).
int kt_sweep_axis0(const void* d, const void* ok, const void* nc,
                   const void* gate, void* mail, void* out, int n, int H,
                   int W, const float* costs9, const int* bits9,
                   int node_mode, int clamp, int descending, void* stream) {
    if (node_mode && nc == nullptr) return (int)cudaErrorInvalidValue;
    if ((gate == nullptr) != (bits9 == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    kt::Costs9 costs;
    Bits9 bits;
    const int bad = read_costs_bits(costs9, bits9, &costs, &bits);
    if (bad) return bad;
    return by_flags(node_mode, clamp, gate != nullptr,
                    [&](auto nd, auto cl, auto vg) {
        const Axis0Op<decltype(nd)::value, decltype(cl)::value,
                      decltype(vg)::value> op = {
            (const float*)d, (const uint8_t*)ok, (const float*)nc,
            (const uint32_t*)gate, (float*)out, costs, bits};
        return dispatch_axis0(op, mail, n, H, W, descending,
                              (cudaStream_t)stream);
    });
}

// How B5 runs a plane of H x W on the current device (with a graph gate
// where has_vg): returns the form (0 per plane, 1 grid-wide strips, 2 one
// cluster) with its rows per strip and its strips (CTAs).
int kt_sweep_axis0_plan(int H, int W, int node_mode, int has_vg, int* rows,
                        int* ctas) {
    kt::StripPlan plan;
    if (node_mode) {
        plan = has_vg ? plan_axis0<true, true>(H, W)
                      : plan_axis0<true, false>(H, W);
    } else {
        plan = has_vg ? plan_axis0<false, true>(H, W)
                      : plan_axis0<false, false>(H, W);
    }
    *rows = plan.strips.rows;
    *ctas = plan.strips.count;
    return plan.form;
}

}  // extern "C"
