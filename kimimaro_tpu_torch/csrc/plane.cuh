// Shared pieces of the plane-sweep kernels (gsweep.cu, sweep.cu).
//
// A directed sweep along axis 0 of an (n, H, W) volume relaxes plane i from
// the already relaxed plane i-1 through the nine (dy, dz) offsets, so the
// planes of one sweep depend on each other in order. Three forms share this
// header:
//
//   * per plane (B4, and B1, B2, B5 for planes too large to hold): the host
//     entry point walks the planes and launches one 2-D stencil kernel per
//     plane on the caller's stream; the previous plane is read back from
//     the output in device memory. Its cost on this card is the launch
//     cadence (about 5-7 us a plane), not the bytes.
//   * persistent strips (B1, B2, and B5 above one cluster): one launch per
//     sweep. CTA g owns the rows [g * R, g * R + R) of every plane at full
//     width and walks the planes in a loop (`sweep_strips`); the previous
//     plane's strip stays in shared memory, the operands of the next plane
//     arrive through cp.async stages (`stage_copy`, any width and
//     alignment), and a CTA waits only for its two neighbours: each posts
//     its edge rows, every value with the step's number in one 64-bit
//     word, to a mailbox in device memory, and spins on the neighbours'
//     mailboxes for its halo rows (`MailHalo`). The grid is launched
//     co-resident (cudaLaunchCooperativeKernel), so every spin ends; a spin
//     that does not end traps.
//   * one thread-block cluster (B5 on the planes of label crops): the same
//     strip loop in a grid of one cluster of up to 16 CTAs; the mailboxes
//     of a CTA's halo rows lie in its own shared memory, and its neighbours
//     post their edge rows there through distributed shared memory, so a
//     CTA spins on its own shared memory and the cluster meets at a barrier
//     only at the start and the end of the sweep.
//
// A sweep's own arithmetic is an operator `Op` (gsweep.cu, sweep.cu):
//   T, kFields      the carried value type and the number of fields;
//   kIds            whether neighbours count only at an equal carried id;
//   kWords, kBytes  4-byte and 1-byte operands of a voxel in a stage;
//   operand(k)      the volume of operand k (the words, then the bytes);
//   fill()          the value of a cell that offers nothing;
//   halo_id(j)      the carried id of voxel j of the volume (kIds);
//   relax(first, in, i, v, id, rr, nv, cid)  the new values of voxel i of
//                   the strip (in.p[k]: operand k of the strip in the
//                   stage) from the carried 3 x 3 cells around it;
//   store(j, nv)    write them to the output.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

namespace kt {

// step costs of the nine (dy, dz) offsets in (-1,0,1) x (-1,0,1) order
struct Costs9 {
    float c[9];
};

inline Costs9 make_costs9(const float* host_costs) {
    Costs9 c;
    memcpy(c.c, host_costs, sizeof(c.c));
    return c;
}

constexpr int kBlockZ = 32;
constexpr int kBlockY = 8;

inline dim3 plane_block() { return dim3(kBlockZ, kBlockY); }

inline dim3 plane_grid(int H, int W) {
    return dim3((W + kBlockZ - 1) / kBlockZ, (H + kBlockY - 1) / kBlockY);
}

// plane index of sweep step s, and of the plane it relaxes from (-1 for
// the first plane, which passes through)
__host__ __device__ inline void sweep_planes(int s, int n, int descending,
                                             int64_t* plane, int64_t* prev) {
    *plane = descending ? (int64_t)(n - 1 - s) : (int64_t)s;
    if (s == 0) {
        *prev = -1;
    } else {
        *prev = descending ? *plane + 1 : *plane - 1;
    }
}

// ---------------------------------------------------------------------------
// strips: geometry and shared-memory layout

constexpr int kStripThreads = 512;
// operand stages: the plane being relaxed and the next one (three and
// four stages were slower on the H100)
constexpr int kStages = 2;
constexpr int kGroup = 4;  // rows of a column that one thread relaxes

// Rows per strip and strips per plane for at most `max_strips` strips: the
// fewest rows that still cover H.
struct Strips {
    int rows;   // R: rows of every strip but possibly the last
    int count;  // G: strips = CTAs
};

inline Strips make_strips(int H, int max_strips) {
    Strips s;
    s.rows = (H + max_strips - 1) / max_strips;
    if (s.rows < 1) s.rows = 1;
    s.count = (H + s.rows - 1) / s.rows;
    return s;
}

// Threads of a strip CTA: one per (group of four rows, column) item of the
// strip, in whole warps, from 64 to kStripThreads.
inline int strip_threads(int R, int W) {
    const int64_t items = (int64_t)((R + kGroup - 1) / kGroup) * W;
    int64_t t = (items + 31) / 32 * 32;
    if (t < 64) t = 64;
    if (t > kStripThreads) t = kStripThreads;
    return (int)t;
}

// streaming multiprocessors of the current device, or -1 where the device
// cannot launch a co-resident grid
inline int coresident_ctas() {
    int dev = 0, sms = 0, coop = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return -1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    return coop ? sms : -1;
}

inline int optin_smem() {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    return optin;
}

__host__ __device__ inline int64_t round16(int64_t b) {
    return (b + 15) / 16 * 16;
}

// Shared memory of one strip CTA, in this order:
//   carried: 2 copies x `arrays` x (R + 2) x (W + 2) words (the fields, then
//            the ids), a one-cell border and one halo row above and below;
//   stages:  2 x {`words` regions of R x W words, `bytes` regions of R x W
//            bytes}, each region 16 bytes longer than its rounded size for
//            the shift of `stage_copy`.
struct StripLayout {
    int64_t cells;        // (R + 2) * (W + 2)
    size_t stage_offset;  // bytes before the first stage
    size_t word_region;   // bytes of a region of words
    size_t byte_region;
    size_t stage_bytes;
    size_t total;
};

__host__ __device__ inline StripLayout strip_layout(int R, int W, int arrays,
                                                    int words, int bytes) {
    StripLayout l;
    const int64_t strip = (int64_t)R * W;
    l.cells = (int64_t)(R + 2) * (W + 2);
    l.stage_offset = (size_t)round16(2 * arrays * l.cells * 4);
    l.word_region = (size_t)(round16(strip * 4) + 16);
    l.byte_region = (size_t)(round16(strip) + 16);
    l.stage_bytes = words * l.word_region + bytes * l.byte_region;
    l.total = l.stage_offset + kStages * l.stage_bytes;
    return l;
}

template <class Op>
__host__ __device__ inline StripLayout op_layout(int R, int W) {
    return strip_layout(R, W, Op::kFields + (Op::kIds ? 1 : 0), Op::kWords,
                        Op::kBytes);
}

// ---------------------------------------------------------------------------
// 32-bit words of the carried values, and the mailboxes

__device__ __forceinline__ uint32_t word_of(float v) {
    return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t word_of(int32_t v) { return (uint32_t)v; }

template <class T>
__device__ __forceinline__ T value_of(uint32_t w);
template <>
__device__ __forceinline__ float value_of<float>(uint32_t w) {
    return __uint_as_float(w);
}
template <>
__device__ __forceinline__ int32_t value_of<int32_t>(uint32_t w) {
    return (int32_t)w;
}

// polls after which a wait gives up (seconds of spinning): a wrong
// protocol becomes an error, not a hung card
constexpr long long kMaxPolls = 1LL << 24;

// A mailbox cell is one 64-bit word: a value's 32 bits below (a float's or
// an int32's, cast bit for bit), the number of the step that wrote it (from
// 1; 0 is "never") above. An aligned 64-bit store or load is single-copy
// atomic, so a reader that sees the step it waits for has the value of that
// step: no fence and no separate flag. CLUSTER: the cell lies in the shared
// memory of a CTA of this cluster (a generic address), else in device
// memory.
template <bool CLUSTER = false, class T>
__device__ __forceinline__ void mail_post(unsigned long long* cell, T v,
                                          int step) {
    const unsigned long long w =
        ((unsigned long long)(unsigned)step << 32) | word_of(v);
    if (CLUSTER) {
        asm volatile("st.relaxed.cluster.u64 [%0], %1;"
                     :: "l"(cell), "l"(w) : "memory");
    } else {
        asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                     :: "l"(cell), "l"(w) : "memory");
    }
}

// Spin until the cell holds the value of `step`.
template <class T, bool CLUSTER = false>
__device__ __forceinline__ T mail_wait(const unsigned long long* cell,
                                       int step) {
    long long polls = 0;
    for (;;) {
        unsigned long long w;
        if (CLUSTER) {
            asm volatile("ld.relaxed.cluster.u64 %0, [%1];"
                         : "=l"(w) : "l"(cell) : "memory");
        } else {
            asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                         : "=l"(w) : "l"(cell) : "memory");
        }
        if ((int)(w >> 32) == step) return value_of<T>((uint32_t)w);
        if (++polls > kMaxPolls) {
            printf("plane sweep: strip %d waited for step %d in vain\n",
                   (int)blockIdx.x, step);
            __trap();
        }
    }
}

// ---------------------------------------------------------------------------
// stage copies

// 16-byte asynchronous copy from device to shared memory (both 16-byte
// aligned), bypassing L1
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until all of this thread's committed copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Copy the `bytes` contiguous bytes at `src` into the stage region
// `region` (16-byte aligned) by 16-byte cp.async chunks, one a thread in
// turn, over the 16-byte aligned span that holds them: they land from
// region + stage_shift(src) on, for any width and alignment of the rows.
// A chunk may take up to 15 bytes before or after the run; those lie in
// the same aligned 16 bytes as a byte of the run, so in a page the run's
// allocation maps, and land in the region's 16 spare bytes. The operands
// are read-only inputs, so the extra bytes are never written meanwhile.
__device__ __forceinline__ int stage_shift(const void* src) {
    return (int)((uintptr_t)src & 15);
}

__device__ __forceinline__ void stage_copy(unsigned char* region,
                                           const void* src, int64_t bytes) {
    const uintptr_t a = (uintptr_t)src;
    const uintptr_t lo = a & ~(uintptr_t)15;
    const int64_t chunks = (int64_t)((((a + bytes + 15) & ~(uintptr_t)15)
                                      - lo) >> 4);
    for (int64_t c = threadIdx.x; c < chunks; c += blockDim.x) {
        cp_async16(region + 16 * c, (const void*)(lo + 16 * c));
    }
}

// Where a step's operands lie in its stage: p[k] is operand k of the strip
// (the words, then the bytes).
template <int N>
struct StageView {
    const unsigned char* p[N];
};

// ---------------------------------------------------------------------------
// the strip loop

// One copy of the carried plane of a strip: the fields, then the ids.
template <class T, int F>
struct Carried {
    T* v[F];
    int32_t* id;
};

// Where a strip's halo rows come from: mailboxes, each an even and an odd
// step of F fields of W cells.
//
// MailHalo<.., false>: in device memory. The mailboxes of strip g are its
// top and its bottom edge row; it reads its halo rows from the upper
// neighbour's bottom box and the lower neighbour's top box.
// MailHalo<.., true>: in shared memory, in a grid of one cluster. The
// mailboxes of CTA g are its top and its bottom halo row; its neighbours
// post their edge rows into them through distributed shared memory.
// Either way a strip posts step s + 2 into a box only after it has read
// its neighbour's step s + 1, which the neighbour posted after reading
// step s from that box: two steps per box suffice. Nothing is posted after
// the last step. The ids of the halo rows are read from the volume
// (`Op::halo_id`).
template <class T, int F, bool CLUSTER>
struct MailHalo {
    unsigned long long* in_top;      // boxes of the halo rows
    unsigned long long* in_bottom;
    unsigned long long* out_top;     // where the edge rows go
    unsigned long long* out_bottom;
    int g, G, W, n;
    unsigned long long* top_out;     // this step's
    unsigned long long* bottom_out;

    __device__ unsigned long long* step_box(unsigned long long* base,
                                            int step) const {
        return base + (int64_t)(step & 1) * F * W;
    }

    // the halo rows of step s into `prev`, one column a thread
    template <class Op>
    __device__ void receive(const Op& op, int s, int64_t above,
                            int64_t below, int rows, int PW,
                            const Carried<T, F>& prev) {
        if (g > 0) {
            const unsigned long long* mb = step_box(in_top, s - 1);
            for (int z = threadIdx.x; z < W; z += blockDim.x) {
                if constexpr (Op::kIds) prev.id[1 + z] = op.halo_id(above + z);
#pragma unroll
                for (int f = 0; f < F; ++f) {
                    prev.v[f][1 + z] = mail_wait<T, CLUSTER>(mb + f * W + z, s);
                }
            }
        }
        if (g + 1 < G) {
            const int dst = (rows + 1) * PW + 1;
            const unsigned long long* mb = step_box(in_bottom, s - 1);
            for (int z = threadIdx.x; z < W; z += blockDim.x) {
                if constexpr (Op::kIds) {
                    prev.id[dst + z] = op.halo_id(below + z);
                }
#pragma unroll
                for (int f = 0; f < F; ++f) {
                    prev.v[f][dst + z] = mail_wait<T, CLUSTER>(mb + f * W + z,
                                                               s);
                }
            }
        }
    }

    __device__ void begin_step(int s) {
        const bool last = s + 1 >= n;
        top_out = g > 0 && !last ? step_box(out_top, s) : nullptr;
        bottom_out = g + 1 < G && !last ? step_box(out_bottom, s) : nullptr;
    }

    // an edge row goes to the neighbour's box as soon as it is relaxed
    __device__ void post(int r, int rows, int z, const T (&nv)[F], int s) {
        if (r == 0 && top_out != nullptr) {
#pragma unroll
            for (int f = 0; f < F; ++f) {
                mail_post<CLUSTER>(top_out + f * W + z, nv[f], s + 1);
            }
        }
        if (r == rows - 1 && bottom_out != nullptr) {
#pragma unroll
            for (int f = 0; f < F; ++f) {
                mail_post<CLUSTER>(bottom_out + f * W + z, nv[f], s + 1);
            }
        }
    }
};

// the cluster barrier's arrive (release semantics) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// bytes of a CTA's mailboxes in the cluster form: two rows, two steps, F
// fields of W cells
template <class Op>
__host__ __device__ inline size_t cluster_box_bytes(int W) {
    return (size_t)4 * Op::kFields * W * sizeof(unsigned long long);
}

// Relax column z of the rows [ra, ra + rc) of the strip (rc <= 4) from the
// carried plane `prev` into `next`: the (rc + 2) x 3 cells around them are
// read once for all rc voxels. A group of four rows goes in the order 0,
// 3, 1, 2, so that the strip's edge rows come first.
template <bool FULL, class Op, class Halo>
__device__ __forceinline__ void relax_column(
    const Op& op, Halo& halo, bool first,
    const StageView<Op::kWords + Op::kBytes>& in,
    const Carried<typename Op::T, Op::kFields>& prev,
    const Carried<typename Op::T, Op::kFields>& next, int ra, int z, int rc,
    int rows, int W, int PW, int64_t out_base, int s) {
    using T = typename Op::T;
    constexpr int F = Op::kFields;
    constexpr int order[kGroup] = {0, 3, 1, 2};
    T v[F][kGroup + 2][3];
    int32_t nid[kGroup + 2][3];
#pragma unroll
    for (int dy = 0; dy < kGroup + 2; ++dy) {
        if (FULL || dy < rc + 2) {
#pragma unroll
            for (int dz = 0; dz < 3; ++dz) {
                const int j = (ra + dy) * PW + z + dz;
                if constexpr (Op::kIds) nid[dy][dz] = prev.id[j];
#pragma unroll
                for (int f = 0; f < F; ++f) v[f][dy][dz] = prev.v[f][j];
            }
        }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
        if (!FULL && k >= rc) break;
        const int rr = FULL ? order[k] : k;
        const int r = ra + rr;
        const int i = r * W + z;
        T nv[F];
        int32_t cid = 0;
        op.relax(first, in, i, v, nid, rr, nv, cid);
        halo.post(r, rows, z, nv, s);
        op.store(out_base + i, nv);
        const int q = (r + 1) * PW + z + 1;
#pragma unroll
        for (int f = 0; f < F; ++f) next.v[f][q] = nv[f];
        if constexpr (Op::kIds) next.id[q] = cid;
    }
}

// One directed sweep of an (n, H, W) volume by strip g of G (R rows each,
// the last possibly fewer). Every cell of the carried plane that offers
// nothing holds the fill: the border, the halo rows outside the volume,
// and (the operators' contract) every voxel that is not occupied. So the
// carried id of such a cell never matters, and the ids are the volume's
// own (raw labels in minid mode, which may equal any id).
template <class Op, class Halo>
__device__ __forceinline__ void sweep_strips(const Op& op, Halo& halo, int g,
                                             int n, int H, int W, int R,
                                             int descending) {
    using T = typename Op::T;
    constexpr int F = Op::kFields;
    constexpr int A = F + (Op::kIds ? 1 : 0);
    constexpr int K = Op::kWords + Op::kBytes;
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int y0 = g * R;
    const int rows = min(R, H - y0);
    const int PW = W + 2;
    const int64_t HW = (int64_t)H * W;
    const StripLayout lay = op_layout<Op>(R, W);
    const T fill = op.fill();

    // carried copy c: the fields, then the ids
    auto carried = [&](int c) {
        Carried<T, F> k;
#pragma unroll
        for (int f = 0; f < F; ++f) k.v[f] = (T*)smem + (c * A + f) * lay.cells;
        k.id = Op::kIds ? (int32_t*)smem + (c * A + F) * lay.cells : nullptr;
        return k;
    };
    for (int64_t i = tid; i < lay.cells; i += nthreads) {
        for (int c = 0; c < 2; ++c) {
            const Carried<T, F> k = carried(c);
#pragma unroll
            for (int f = 0; f < F; ++f) k.v[f][i] = fill;
            if constexpr (Op::kIds) k.id[i] = 0;
        }
    }

    // the strip's first element in the volume at sweep step s; operand k
    // there (a contiguous run of rows x W elements) and its region of stage
    // s % 2
    auto first_element = [&](int s) {
        int64_t plane, prev;
        sweep_planes(s, n, descending, &plane, &prev);
        return plane * HW + (int64_t)y0 * W;
    };
    auto source = [&](int64_t e, int k) {
        return (const unsigned char*)op.operand(k)
            + (k < Op::kWords ? 4 * e : e);
    };
    auto region = [&](int s, int k) {
        return smem + lay.stage_offset
            + (size_t)(s % kStages) * lay.stage_bytes
            + (k < Op::kWords ? k * lay.word_region
                              : Op::kWords * lay.word_region
                                    + (k - Op::kWords) * lay.byte_region);
    };
    auto prefetch = [&](int s) {
        const int64_t e = first_element(s);
#pragma unroll
        for (int k = 0; k < K; ++k) {
            stage_copy(region(s, k), source(e, k),
                       (int64_t)rows * W * (k < Op::kWords ? 4 : 1));
        }
    };
    prefetch(0);
    cp_async_commit();

    const int groups = (rows + kGroup - 1) / kGroup;
    const int items = groups * W;
    const int item_g = tid / W, item_z = tid % W;  // item `tid`
    const int step_g = nthreads / W, step_z = nthreads % W;
    int p = 0;  // the carried copy that holds the previous plane
    for (int s = 0; s < n; ++s) {
        int64_t plane, prev;
        sweep_planes(s, n, descending, &plane, &prev);
        const Carried<T, F> from = carried(p), into = carried(p ^ 1);
        // where this step's operands lie in its stage (before the halo
        // wait, off the chain of the planes)
        const int64_t out_base = plane * HW + (int64_t)y0 * W;
        StageView<K> in;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            in.p[k] = region(s, k) + stage_shift(source(out_base, k));
        }
        if (s > 0) {
            halo.receive(op, s, prev * HW + (int64_t)(y0 - 1) * W,
                         prev * HW + (int64_t)(y0 + rows) * W, rows, PW,
                         from);
        }
        cp_async_wait_all();  // this thread's part of stage s % 2
        __syncthreads();
        // every thread is past step s - 1: its stage takes step s + 1
        if (s + 1 < n) prefetch(s + 1);
        cp_async_commit();

        halo.begin_step(s);
        // one item per (group of four rows, column); the groups that hold
        // the strip's edge rows first: the neighbours wait for them.
        // (it / W, it % W) walks on by nthreads items without a division.
        int gi = item_g, z = item_z;
        for (int it = tid; it < items; it += nthreads) {
            const int grp = gi == 0 ? 0 : (gi == 1 ? groups - 1 : gi - 1);
            const int ra = grp * kGroup;
            const int rc = min(kGroup, rows - ra);
            if (rc == kGroup) {
                relax_column<true>(op, halo, s == 0, in, from, into, ra, z,
                                   rc, rows, W, PW, out_base, s);
            } else {
                relax_column<false>(op, halo, s == 0, in, from, into, ra, z,
                                    rc, rows, W, PW, out_base, s);
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

// The two kernels of the strip loop: a co-resident grid whose strips
// exchange edge rows through `mail` in device memory, and a grid of one
// cluster whose CTAs keep their mailboxes after the strip's shared memory.
template <class Op>
__global__ void __launch_bounds__(kStripThreads, 1)
grid_strips(Op op, unsigned long long* mail, int n, int H, int W, int R,
            int descending) {
    const int g = blockIdx.x, G = gridDim.x;
    const int64_t FW = (int64_t)Op::kFields * W;
    auto box = [&](int strip, int bottom) {
        return mail + (int64_t)(strip * 2 + bottom) * 2 * FW;
    };
    MailHalo<typename Op::T, Op::kFields, false> halo{
        g > 0 ? box(g - 1, 1) : nullptr, g + 1 < G ? box(g + 1, 0) : nullptr,
        box(g, 0), box(g, 1), g, G, W, n, nullptr, nullptr};
    sweep_strips<Op>(op, halo, g, n, H, W, R, descending);
}

// Zeroing the boxes and a cluster barrier come before any CTA posts; a last
// barrier keeps every CTA resident until no neighbour posts into it.
template <class Op>
__global__ void __launch_bounds__(kStripThreads, 1)
cluster_strips(Op op, int n, int H, int W, int R, int descending) {
    namespace cg = cooperative_groups;
    extern __shared__ __align__(16) unsigned char smem[];
    const int g = blockIdx.x, G = gridDim.x;
    const int64_t FW = (int64_t)Op::kFields * W;
    unsigned long long* boxes =
        (unsigned long long*)(smem + op_layout<Op>(R, W).total);
    for (int64_t i = threadIdx.x; i < 4 * FW; i += blockDim.x) boxes[i] = 0;
    cg::cluster_group cluster = cg::this_cluster();
    // this CTA's top halo box, then its bottom one; a neighbour's by rank
    unsigned long long* up =
        g > 0 ? cluster.map_shared_rank(boxes, g - 1) : nullptr;
    unsigned long long* down =
        g + 1 < G ? cluster.map_shared_rank(boxes, g + 1) : nullptr;
    MailHalo<typename Op::T, Op::kFields, true> halo{
        boxes, boxes + 2 * FW, up == nullptr ? nullptr : up + 2 * FW, down,
        g, G, W, n, nullptr, nullptr};
    cluster_arrive();
    cluster_wait();
    sweep_strips<Op>(op, halo, g, n, H, W, R, descending);
    cluster_arrive();
    cluster_wait();
}

// How a sweep runs on the current device: the form a shape rule chose, and
// its geometry.
enum Form { kPerPlane = 0, kGridStrips = 1, kCluster = 2 };

struct StripPlan {
    int form;
    Strips strips;  // rows per strip, strips (= CTAs)
    int threads;
    size_t smem;
};

// The grid-wide strips of an operator: possible where the device holds one
// CTA per strip at once and the strip of the fewest rows (ceil(H / SMs))
// fits in a block's shared memory (the carried plane twice and two
// operand stages).
template <class Op>
StripPlan plan_grid_strips(int H, int W) {
    StripPlan plan = {kPerPlane, {0, 0}, 0, 0};
    const int ctas = coresident_ctas();
    if (ctas <= 0 || H <= 0 || W <= 0) return plan;
    plan.strips = make_strips(H, ctas);
    plan.threads = strip_threads(plan.strips.rows, W);
    plan.smem = op_layout<Op>(plan.strips.rows, W).total;
    if (plan.smem <= (size_t)optin_smem()) plan.form = kGridStrips;
    return plan;
}

// The largest cluster (at most 16 CTAs, one strip each) whose CTAs relax
// their strips in one pass of their threads (ceil(R / 4) x W items of up to
// kStripThreads), whose strips and mailboxes fit in a block's shared memory
// and that the device says it can hold at once
// (`cudaOccupancyMaxActiveClusters`); kPerPlane where none does. Beyond one
// pass the grid-wide strips were faster on the H100 at every plane tried.
template <class Op>
StripPlan plan_cluster(int H, int W) {
    StripPlan plan = {kPerPlane, {0, 0}, 0, 0};
    if (H <= 0 || W <= 0) return plan;
    const size_t optin = (size_t)optin_smem();
    const void* kern = (const void*)cluster_strips<Op>;
    for (int c = H < 16 ? H : 16; c >= 1; --c) {
        const Strips strips = make_strips(H, c);
        const size_t smem =
            op_layout<Op>(strips.rows, W).total + cluster_box_bytes<Op>(W);
        // fewer CTAs only make the strips longer
        if (smem > optin ||
            (int64_t)((strips.rows + kGroup - 1) / kGroup) * W >
                kStripThreads) {
            break;
        }
        if (strips.count != c) continue;  // c is not a strip count of H
        const int threads = strip_threads(strips.rows, W);
        if (cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem) != cudaSuccess ||
            cudaFuncSetAttribute(
                kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
                cudaSuccess) {
            cudaGetLastError();
            return plan;
        }
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = strips.count;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(strips.count);
        cfg.blockDim = dim3(threads);
        cfg.dynamicSmemBytes = smem;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int clusters = 0;
        if (cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) !=
            cudaSuccess) {
            cudaGetLastError();
            continue;
        }
        if (clusters >= 1) {
            plan = {kCluster, strips, threads, smem};
            return plan;
        }
    }
    return plan;
}

// One cooperative launch of the grid strips of `op` by `plan`.
template <class Op>
int run_grid_strips(const Op& op, unsigned long long* mail, int n, int H,
                    int W, int descending, const StripPlan& plan,
                    cudaStream_t st) {
    if (mail == nullptr) return (int)cudaErrorInvalidValue;
    const void* kern = (const void*)grid_strips<Op>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (e != cudaSuccess) return (int)e;
    Op o = op;
    int R = plan.strips.rows;
    void* args[] = {&o, &mail, &n, &H, &W, &R, &descending};
    return (int)cudaLaunchCooperativeKernel(kern, dim3(plan.strips.count),
                                            dim3(plan.threads), args,
                                            plan.smem, st);
}

// One launch of a grid of one cluster by `plan`.
template <class Op>
int run_cluster(const Op& op, int n, int H, int W, int descending,
                const StripPlan& plan, cudaStream_t st) {
    void (*kern)(Op, int, int, int, int, int) = cluster_strips<Op>;
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)plan.smem);
    if (e == cudaSuccess && plan.strips.count > 8) {
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
    cfg.gridDim = dim3(plan.strips.count);
    cfg.blockDim = dim3(plan.threads);
    cfg.dynamicSmemBytes = plan.smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, kern, op, n, H, W,
                                   plan.strips.rows, descending);
}

}  // namespace kt
