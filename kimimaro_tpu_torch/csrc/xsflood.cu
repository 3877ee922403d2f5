// X1: the section flood of windowed cross sections.
//
// Replaces JAX code that has no Pallas kernel: the "sweep" flood
// kimimaro_tpu/ops/xsslab.py `_sweep_rounds` and the "dilate" flood of
// kimimaro_tpu/ops/xsbatch.py `_finish_section` (a lax.scan of 8-neighbour
// dilations). Each lane holds a (Wx, Wy) window of words; bit k of a word
// is the cell at z = zb + k of its column (K = 5). A neighbour column's
// bits re-base into this column's frame by a variable shift of the zb
// delta, and a +-1 shift adds the true-z dilation:
//
//   dilate round: r' = (r | kd(r) | OR_8nbrs kd(vshift(r_n, zb_n - zb))) & sb
//   sweep round:  four directed sweeps (+x, -x, +y, -y); row i takes
//                 cand = r_i | OR_{dy} kd(vshift(r'_{i-1}[j+dy], dzb)),
//                 r'_i = infill(cand & sb, sb) (K - 1 in-word fill passes)
//
// Both loops of the JAX package run rounds + 1 rounds and report whether
// the last one changed a word. A round is a function of the words alone,
// so after a round that changes nothing every later round changes nothing
// too: a lane stops there, with the same (kept, changed). It also reports
// the rounds it ran.
//
// What bounds the sweep on the card: its chain of dependent row steps (4 W
// a round, each a few dozen integer operations), not its bytes. Three
// forms, chosen by `plan_sweep` from the window (exposed as
// ops.xsslab.section_flood_plan):
//
//   * one CTA per lane of one warp per 32 columns (windows up to 256
//     columns whose packed words fit in a block's shared memory): every
//     cell is one 32-bit word in shared memory (the word's 8 bits, the
//     section word's 8 bits, zb as int16), so W = 64 takes 16 KB a lane
//     and an SM holds a dozen lanes. A thread owns one column of a row
//     step and keeps its previous row in a register (with its zb); the
//     neighbours' come by warp shuffles, across warps through two words a
//     warp in shared memory and one named barrier a step, and the in-word
//     fill is one lookup in a 1 KB table.
//   * one thread-block cluster per lane (the W = 512 rungs): CTA c holds
//     the band of window rows x in [c Bx, c Bx + Bx) for all y in its
//     shared memory. The x sweeps pass the chain from band to band: a CTA
//     relaxes its rows with its whole block (one barrier a row) and posts
//     its last row once into the next CTA's shared memory. In the y sweeps
//     every CTA steps together, a warp over its band's columns, and posts
//     its edge columns into its neighbours' shared-memory mailboxes (each
//     value with its step's number in one 32-bit word) every step. The
//     chain stays 4 W steps a round; each step reads shared memory, not L2.
//     The lane's changed flag meets at one cluster barrier a round.
//   * one CTA per lane over the window in device memory (the first form), for
//     windows neither of the others holds.
//
// The dilation keeps the first form, one CTA per lane (shared memory up to
// W = 64).
//
// Every cell whose section word is 0 keeps the word 0 for ever (the seed
// is within the section and every step ANDs with it), so its zb never
// matters and the packed forms store 0 there; where the section word is
// not 0, zb lies in (-K, tz), which the wrapper checks fits int16.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int K = 5;
constexpr size_t kMaxSmem = 225 * 1024;
constexpr int kTable = 1024;          // infill table: (cand & sb) | sb << 5
constexpr int kClusterThreads = 512;  // CTA of the cluster form
constexpr int kLaneWarps = 8;         // warps of a lane's CTA (warps form)
constexpr long long kMaxPolls = 1LL << 24;

__host__ __device__ __forceinline__ uint32_t kdilate(uint32_t b) {
    return b | (b << 1) | (b >> 1);
}

// bits << delta for a signed delta clamped to +-31
__device__ __forceinline__ uint32_t var_shift(uint32_t bits, int delta) {
    const int d = max(-31, min(31, delta));
    return (bits << (d > 0 ? d : 0)) >> (d < 0 ? -d : 0);
}

__host__ __device__ __forceinline__ uint32_t infill(uint32_t r, uint32_t sb) {
#pragma unroll
    for (int s = 0; s < K - 1; ++s) r = (r | kdilate(r)) & sb;
    return r;
}

// ---------------------------------------------------------------------------
// The first form: one CTA per lane, words in shared memory or device memory

// One directed sweep, in place, over the rows along `axis` (0: rows are
// window x, 1: rows are window y). Returns whether this thread changed a
// word. Every thread of the block must call it (one barrier per row).
__device__ bool sweep_pass(uint32_t* r, const uint32_t* sb, const int32_t* zb,
                           int Wx, int Wy, int axis, bool reverse) {
    const int n = axis == 0 ? Wx : Wy;
    const int m = axis == 0 ? Wy : Wx;
    const int rs = axis == 0 ? Wy : 1;
    const int cs = axis == 0 ? 1 : Wy;
    bool any = false;
    for (int s = 0; s < n; ++s) {
        const int i = reverse ? n - 1 - s : s;
        const int p = reverse ? i + 1 : i - 1;
        for (int j = threadIdx.x; j < m; j += blockDim.x) {
            const int c = i * rs + j * cs;
            const uint32_t cur = r[c];
            const uint32_t msk = sb[c];
            uint32_t cand = cur;
            if (s > 0) {
                const int z = zb[c];
#pragma unroll
                for (int dy = -1; dy <= 1; ++dy) {
                    const int jj = j + dy;
                    if (jj < 0 || jj >= m) continue;
                    const int pc = p * rs + jj * cs;
                    cand |= kdilate(var_shift(r[pc], zb[pc] - z));
                }
            }
            const uint32_t nv = infill(cand & msk, msk);
            if (nv != cur) {
                r[c] = nv;
                any = true;
            }
        }
        __syncthreads();
    }
    return any;
}

// One 8-neighbour dilation round from r into nxt. Returns whether this
// thread changed a word.
__device__ bool dilate_round(const uint32_t* r, uint32_t* nxt,
                             const uint32_t* sb, const int32_t* zb, int Wx,
                             int Wy) {
    bool any = false;
    const int cells = Wx * Wy;
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
        const int x = c / Wy;
        const int y = c - x * Wy;
        const uint32_t cur = r[c];
        const int z = zb[c];
        uint32_t v = cur | kdilate(cur);
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
#pragma unroll
            for (int dy = -1; dy <= 1; ++dy) {
                if (dx == 0 && dy == 0) continue;
                const int xx = x + dx;
                const int yy = y + dy;
                if (xx < 0 || xx >= Wx || yy < 0 || yy >= Wy) continue;
                const int nb = xx * Wy + yy;
                v |= kdilate(var_shift(r[nb], zb[nb] - z));
            }
        }
        v &= sb[c];
        nxt[c] = v;
        any = any || v != cur;
    }
    return any;
}

template <bool SWEEP>
__global__ void __launch_bounds__(1024)
xs_flood_kernel(const int32_t* __restrict__ seed,
                const int32_t* __restrict__ secb,
                const int32_t* __restrict__ zb, int32_t* kept,
                int32_t* scratch, int32_t* __restrict__ changed,
                int32_t* __restrict__ nrun, int Wx, int Wy, int rounds,
                int use_smem) {
    extern __shared__ uint32_t smem[];
    __shared__ int flag;
    const int cells = Wx * Wy;
    const int64_t base = (int64_t)blockIdx.x * cells;
    const uint32_t* sb_g = (const uint32_t*)secb + base;
    const int32_t* zb_g = zb + base;
    const uint32_t* seed_g = (const uint32_t*)seed + base;
    uint32_t* out = (uint32_t*)kept + base;
    uint32_t* r = out;
    uint32_t* nxt = SWEEP ? nullptr : (uint32_t*)scratch + base;
    const uint32_t* sb = sb_g;
    const int32_t* z = zb_g;
    if (use_smem) {
        uint32_t* sbs = smem + cells;
        int32_t* zs = (int32_t*)(smem + 2 * cells);
        for (int c = threadIdx.x; c < cells; c += blockDim.x) {
            sbs[c] = sb_g[c];
            zs[c] = zb_g[c];
        }
        r = smem;
        nxt = SWEEP ? nullptr : smem + 3 * cells;
        sb = sbs;
        z = zs;
    }
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
        r[c] = SWEEP ? infill(seed_g[c], sb_g[c]) : seed_g[c];
    }
    __syncthreads();

    int ch = 1;
    int n = 0;
    for (int it = 0; it <= rounds; ++it) {
        if (threadIdx.x == 0) flag = 0;
        __syncthreads();
        bool any;
        if (SWEEP) {
            const bool a0 = sweep_pass(r, sb, z, Wx, Wy, 0, false);
            const bool a1 = sweep_pass(r, sb, z, Wx, Wy, 0, true);
            const bool a2 = sweep_pass(r, sb, z, Wx, Wy, 1, false);
            const bool a3 = sweep_pass(r, sb, z, Wx, Wy, 1, true);
            any = a0 || a1 || a2 || a3;
        } else {
            any = dilate_round(r, nxt, sb, z, Wx, Wy);
            uint32_t* t = r;
            r = nxt;
            nxt = t;
        }
        if (any) flag = 1;
        __syncthreads();
        ch = flag;
        ++n;
        __syncthreads();
        if (!ch) break;
    }
    if (r != out) {
        for (int c = threadIdx.x; c < cells; c += blockDim.x) out[c] = r[c];
    }
    if (threadIdx.x == 0) {
        changed[blockIdx.x] = ch;
        nrun[blockIdx.x] = n;
    }
}

template <bool SWEEP>
int launch(const void* seed, const void* secb, const void* zb, void* kept,
           void* scratch, void* changed, void* nrun, int B, int Wx, int Wy,
           int rounds, int threads, size_t smem, cudaStream_t st) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            xs_flood_kernel<SWEEP>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    xs_flood_kernel<SWEEP><<<B, threads, smem, st>>>(
        (const int32_t*)seed, (const int32_t*)secb, (const int32_t*)zb,
        (int32_t*)kept, (int32_t*)scratch, (int32_t*)changed, (int32_t*)nrun,
        Wx, Wy, rounds, smem > 0);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the packed forms: one CTA per lane, or one cluster per lane

// A cell in shared memory: its word (bits 0-7), its section word (8-15)
// and its zb (16-31, int16). A band holds rows x of Wy cells at a pitch of
// Wy + 1 words, so that a warp reading down a column (the y sweeps) hits 32
// banks.
__device__ __forceinline__ uint32_t pack_cell(uint32_t r, uint32_t sb,
                                              int z) {
    return (r & 0xffu) | ((sb & 0xffu) << 8) | ((uint32_t)(z & 0xffff) << 16);
}
__device__ __forceinline__ uint32_t cell_r(uint32_t w) { return w & 0xffu; }
__device__ __forceinline__ uint32_t cell_sb(uint32_t w) {
    return (w >> 8) & 0xffu;
}
__device__ __forceinline__ int cell_z(uint32_t w) {
    return (int)(int16_t)(w >> 16);
}

// a 32-bit mailbox cell: the step's number (from 1) above, the word below
__device__ __forceinline__ void box_post(uint32_t* cell, uint32_t r,
                                         uint32_t tag) {
    const uint32_t w = (tag << 8) | (r & 0xffu);
    asm volatile("st.relaxed.cluster.u32 [%0], %1;"
                 :: "l"(cell), "r"(w) : "memory");
}

__device__ __forceinline__ uint32_t box_wait(const uint32_t* cell,
                                             uint32_t tag) {
    long long polls = 0;
    const uint32_t want = tag & 0xffffffu;
    for (;;) {
        uint32_t w;
        asm volatile("ld.relaxed.cluster.u32 %0, [%1];"
                     : "=r"(w) : "l"(cell) : "memory");
        if ((w >> 8) == want) return w & 0xffu;
        if (++polls > kMaxPolls) {
            printf("section flood: CTA %d of lane %d waited for step %u in "
                   "vain\n", (int)blockIdx.x, (int)blockIdx.y, want);
            __trap();
        }
    }
}

__device__ __forceinline__ void cluster_sync_all() {
    asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Shared memory of one CTA of the packed forms, in this order: the infill
// table (bytes), the band's cells, the zb of the two halo rows (x0 - 1 and
// x0 + bx, int32), the halo-row mailboxes of the x sweeps (two rows of Wy),
// the halo-column mailboxes of the y sweeps (two sides, four steps), the
// warps' edge words (two steps, two sides), the round flags (two rounds,
// 16 CTAs).
struct PackedLayout {
    size_t cells, hz, rowbox, colbox, edge, flags, total;
};

__host__ __device__ inline PackedLayout packed_layout(int Bx, int Wy,
                                                      int warps) {
    PackedLayout l;
    const size_t pitch = (size_t)Wy + 1;
    l.cells = kTable;
    l.hz = l.cells + 4 * (size_t)Bx * pitch;
    l.rowbox = l.hz + 4 * 2 * (size_t)Wy;
    l.colbox = l.rowbox + 4 * 2 * (size_t)Wy;
    l.edge = l.colbox + 4 * 2 * 4;
    l.flags = l.edge + 4 * 2 * 2 * (size_t)warps;
    l.total = l.flags + 4 * 2 * 16;
    return l;
}

struct Band {
    const uint8_t* tab;
    uint32_t* cell;     // [x - x0][y] at pitch Wy + 1
    int32_t* hz;        // [0][y]: zb at x0 - 1, [1][y]: at x0 + bx
    uint32_t* rowbox;   // [0][y]: row x0 - 1, [1][y]: row x0 + bx
    uint32_t* colbox;   // [side][step & 3], side 0: x0 - 1, 1: x0 + bx
    uint32_t* edge;     // [step & 1][warp][side]
    uint32_t* flags;    // [round & 1][cta], read in CTA 0
    int Wy, pitch, bx;
};

// A thread carries the previous row's cell of its column as a packed
// word: zb << 8 | the new word (the zb sign-extends back with >> 8).
__device__ __forceinline__ int pack_prev(uint32_t r, int z) {
    return (int)(((uint32_t)z << 8) | (r & 0xffu));
}

// the candidate bits from a previous-row cell (packed) into a cell of zb z
__device__ __forceinline__ uint32_t pull(int prev, int z) {
    return kdilate(var_shift((uint32_t)prev & 0xffu, (prev >> 8) - z));
}

// One row step of the columns [jlo, jhi) of one warp, one a thread: the
// thread of lane `lane` owns column jlo + lane. pr holds the previous
// row's packed cell of this thread's column (0 where there is none); left
// and right are the previous row's packed cells at jlo - 1 and jhi. The
// step's load comes before its store. Writes the new word to the band
// and to pr; returns whether it changed.
template <int AXIS>
__device__ __forceinline__ bool row_step(const Band& b, int i, bool first,
                                         int jlo, int jhi, int lane, int& pr,
                                         int left, int right) {
    const int j = jlo + lane;
    const int idx = AXIS == 0 ? i * b.pitch + j : j * b.pitch + i;
    const uint32_t cw = j < jhi ? b.cell[idx] : 0u;
    int from_left = 0, from_right = 0;
    if (!first) {
        from_left = __shfl_up_sync(0xffffffffu, pr, 1);
        from_right = __shfl_down_sync(0xffffffffu, pr, 1);
    }
    if (j >= jhi) {
        pr = 0;
        return false;
    }
    const uint32_t sb = cell_sb(cw) & 31u;
    const int z = cell_z(cw);
    uint32_t cand = cell_r(cw);
    if (!first) {
        const int l = j > jlo ? from_left : left;
        const int r = j + 1 < jhi ? from_right : right;
        cand |= pull(l, z) | pull(pr, z) | pull(r, z);
    }
    const uint32_t nv = b.tab[(cand & sb) | (sb << 5)];
    pr = pack_prev(nv, z);
    if (nv == cell_r(cw)) return false;
    reinterpret_cast<uint8_t*>(b.cell + idx)[0] = (uint8_t)nv;
    return true;
}

// Where a row's warps meet: the first and last packed cells of each warp's
// columns for the next step (slot s & 1 holds row s - 1's), then one
// barrier (`bar`: 0 for __syncthreads, else a named barrier of `warps`
// warps); one warp needs only __syncwarp.
__device__ __forceinline__ void exchange_edges(const Band& b, int s,
                                               int warps, int w, int lane,
                                               int last, int pr, int bar) {
    if (warps == 1) {
        __syncwarp();
        return;
    }
    uint32_t* e = b.edge + (s & 1) * 2 * warps;
    if (lane == 0) e[2 * w] = (uint32_t)pr;
    if (lane == last) e[2 * w + 1] = (uint32_t)pr;
    if (bar == 0) {
        __syncthreads();
    } else {
        asm volatile("bar.sync 1, %0;" :: "r"(warps * 32) : "memory");
    }
}

// the previous row's packed cells just outside warp w's columns
__device__ __forceinline__ void edge_cells(const Band& b, int s, int warps,
                                           int w, bool has_right, int& left,
                                           int& right) {
    if (warps == 1) return;
    const uint32_t* e = b.edge + (s & 1) * 2 * warps;
    if (w > 0) left = (int)e[2 * (w - 1) + 1];
    if (has_right) right = (int)e[2 * (w + 1)];
}

// A sweep along x (rows are the band's x, columns all Wy), by every warp
// of the block, warp w over the columns [32 w, 32 w + 32). With `halo_in`
// the previous row of the band's first row arrives in this CTA's row
// mailbox (side 0: x0 - 1, 1: x0 + bx) with `tag`; `post` is where this
// CTA's last row goes (a neighbour's row mailbox), or null.
__device__ __forceinline__ bool sweep_x(const Band& b, bool reverse,
                                        bool halo_in, uint32_t* post,
                                        uint32_t tag) {
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const int m = b.Wy;
    const int jlo = min(m, 32 * w);
    const int jhi = min(m, jlo + 32);
    const int last = max(jhi - jlo - 1, 0);
    const int side = reverse ? m : 0;
    const int j = jlo + lane;
    int pr = halo_in && j < jhi
                 ? pack_prev(box_wait(b.rowbox + side + j, tag),
                             b.hz[side + j])
                 : 0;
    if (halo_in) exchange_edges(b, 0, warps, w, lane, last, pr, 0);
    bool any = false;
    for (int s = 0; s < b.bx; ++s) {
        const int i = reverse ? b.bx - 1 - s : s;
        const bool first = s == 0 && !halo_in;
        int left = 0, right = 0;
        if (!first) {
            edge_cells(b, s, warps, w, w + 1 < warps && jhi < m, left,
                       right);
        }
        any |= row_step<0>(b, i, first, jlo, jhi, lane, pr, left, right);
        exchange_edges(b, s + 1, warps, w, lane, last, pr, 0);
    }
    if (post != nullptr && j < jhi) box_post(post + j, (uint32_t)pr, tag);
    return any;
}

// The warps that own a y sweep's columns (the band's x, 32 a warp).
__host__ __device__ __forceinline__ int y_warps(int bx) {
    return (bx + 31) / 32;
}

// A sweep along y (rows are y, columns the band's x), by the first
// y_warps(bx) warps of the block, warp w over the columns [32 w, 32 w +
// 32), meeting at named barrier 1. With neighbours, the previous row's
// words just outside the band arrive in this CTA's column mailboxes
// (side 0: x0 - 1, 1: x0 + bx), and the band's edge columns go to the
// neighbours' every step (`to_lo`: the lower neighbour's mailboxes,
// `to_hi`: the upper one's). `tick` numbers the steps of the y sweeps.
__device__ __forceinline__ bool sweep_y(const Band& b, bool reverse,
                                        uint32_t* to_lo, uint32_t* to_hi,
                                        uint32_t& tick) {
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int warps = y_warps(b.bx);
    const int m = b.bx;
    const int jlo = 32 * w;
    const int jhi = min(m, jlo + 32);
    const int last = jhi - jlo - 1;
    const bool lo_edge = w == 0 && to_lo != nullptr;
    const bool hi_edge = jhi == m && to_hi != nullptr;
    int pr = 0;
    bool any = false;
    for (int s = 0; s < b.Wy; ++s) {
        ++tick;
        const int i = reverse ? b.Wy - 1 - s : s;
        const bool first = s == 0;
        int left = 0, right = 0;
        if (!first) {
            const int p = reverse ? i + 1 : i - 1;
            edge_cells(b, s, warps, w, w + 1 < warps, left, right);
            if (lo_edge && lane == 0) {
                left = pack_prev(
                    box_wait(b.colbox + ((tick - 1) & 3), tick - 1), b.hz[p]);
            }
            if (hi_edge && lane == last) {
                right = pack_prev(
                    box_wait(b.colbox + 4 + ((tick - 1) & 3), tick - 1),
                    b.hz[b.Wy + p]);
            }
        }
        any |= row_step<1>(b, i, first, jlo, jhi, lane, pr, left, right);
        if (lo_edge && lane == 0) {
            box_post(to_lo + 4 + (tick & 3), (uint32_t)pr, tick);
        }
        if (hi_edge && lane == last) {
            box_post(to_hi + (tick & 3), (uint32_t)pr, tick);
        }
        exchange_edges(b, s + 1, warps, w, lane, last, pr, 1);
    }
    return any;
}

// The packed sweep of one lane (blockIdx.y) by a cluster of gridDim.x CTAs
// (one CTA: the warps form), CTA c over the window rows [c Bx, c Bx + bx).
__global__ void __launch_bounds__(kClusterThreads)
xs_sweep_packed(const int32_t* __restrict__ seed,
                const int32_t* __restrict__ secb,
                const int32_t* __restrict__ zb, int32_t* __restrict__ kept,
                int32_t* __restrict__ changed, int32_t* __restrict__ nrun,
                int Wx, int Wy, int Bx, int rounds) {
    namespace cg = cooperative_groups;
    extern __shared__ __align__(16) unsigned char psmem[];
    __shared__ int round_changed;
    const int C = gridDim.x;
    const int c = blockIdx.x;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int x0 = c * Bx;
    const int bx = min(Bx, Wx - x0);
    const PackedLayout lay = packed_layout(Bx, Wy, nthreads >> 5);
    Band b;
    b.tab = psmem;
    b.cell = (uint32_t*)(psmem + lay.cells);
    b.hz = (int32_t*)(psmem + lay.hz);
    b.rowbox = (uint32_t*)(psmem + lay.rowbox);
    b.colbox = (uint32_t*)(psmem + lay.colbox);
    b.edge = (uint32_t*)(psmem + lay.edge);
    b.flags = (uint32_t*)(psmem + lay.flags);
    b.Wy = Wy;
    b.pitch = Wy + 1;
    b.bx = bx;

    const int64_t base = (int64_t)blockIdx.y * Wx * Wy;
    uint8_t* tab = psmem;
    for (int k = tid; k < kTable; k += nthreads) {
        const uint32_t sb = (uint32_t)k >> 5;
        tab[k] = (uint8_t)infill((uint32_t)k & 31u & sb, sb);
    }
    for (int k = tid; k < bx * Wy; k += nthreads) {
        const int x = k / Wy;
        const int y = k - x * Wy;
        const int64_t g = base + (int64_t)(x0 + x) * Wy + y;
        const uint32_t sb = (uint32_t)secb[g];
        const uint32_t r = infill((uint32_t)seed[g], sb);
        b.cell[x * b.pitch + y] = pack_cell(r, sb, sb ? zb[g] : 0);
    }
    for (int y = tid; y < Wy; y += nthreads) {
        int zl = 0, zh = 0;
        if (x0 > 0) {
            const int64_t g = base + (int64_t)(x0 - 1) * Wy + y;
            zl = secb[g] ? zb[g] : 0;
        }
        if (x0 + bx < Wx) {
            const int64_t g = base + (int64_t)(x0 + bx) * Wy + y;
            zh = secb[g] ? zb[g] : 0;
        }
        b.hz[y] = (int)(int16_t)zl;
        b.hz[Wy + y] = (int)(int16_t)zh;
        b.rowbox[y] = 0;
        b.rowbox[Wy + y] = 0;
    }
    if (tid < 8) b.colbox[tid] = 0;
    __syncthreads();

    uint32_t* lo_rowbox = nullptr;  // the neighbours' row mailboxes
    uint32_t* hi_rowbox = nullptr;
    uint32_t* lo_colbox = nullptr;  // and column mailboxes
    uint32_t* hi_colbox = nullptr;
    uint32_t* flags0 = b.flags;     // CTA 0's round flags
    if (C > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        if (c > 0) {
            lo_rowbox = cluster.map_shared_rank(b.rowbox, c - 1);
            lo_colbox = cluster.map_shared_rank(b.colbox, c - 1);
        }
        if (c + 1 < C) {
            hi_rowbox = cluster.map_shared_rank(b.rowbox, c + 1);
            hi_colbox = cluster.map_shared_rank(b.colbox, c + 1);
        }
        flags0 = cluster.map_shared_rank(b.flags, 0);
        cluster_sync_all();  // every mailbox is zero before any post
    }

    uint32_t tick = 0;
    int ch = 1;
    int n = 0;
    for (int it = 0; it <= rounds; ++it) {
        const uint32_t tag = 2u * (uint32_t)it + 1u;
        bool any = sweep_x(b, false, c > 0, hi_rowbox, tag);
        __syncthreads();
        any |= sweep_x(b, true, c + 1 < C,
                       lo_rowbox == nullptr ? nullptr : lo_rowbox + Wy,
                       tag + 1u);
        __syncthreads();
        if (tid < 32 * y_warps(bx)) {
            any |= sweep_y(b, false, lo_colbox, hi_colbox, tick);
            any |= sweep_y(b, true, lo_colbox, hi_colbox, tick);
        }
        const int cta_any = __syncthreads_or(any);
        if (C > 1) {
            if (tid == 0) {
                volatile uint32_t* f = flags0;
                f[(it & 1) * 16 + c] = (uint32_t)cta_any;
            }
            cluster_sync_all();
            if (tid == 0) {
                volatile const uint32_t* f = flags0;
                int v = 0;
                for (int k = 0; k < C; ++k) v |= (int)f[(it & 1) * 16 + k];
                round_changed = v;
            }
            __syncthreads();
            ch = round_changed;
        } else {
            ch = cta_any;
        }
        ++n;
        if (!ch) break;
    }
    if (C > 1) cluster_sync_all();  // no CTA leaves while others read it

    for (int k = tid; k < bx * Wy; k += nthreads) {
        const int x = k / Wy;
        const int y = k - x * Wy;
        kept[base + (int64_t)(x0 + x) * Wy + y] =
            (int32_t)cell_r(b.cell[x * b.pitch + y]);
    }
    if (c == 0 && tid == 0) {
        changed[blockIdx.y] = ch;
        nrun[blockIdx.y] = n;
    }
}

// ---------------------------------------------------------------------------
// the shape rule

enum FloodForm { kLaneCta = 0, kWarps = 1, kCluster = 2 };

struct FloodPlan {
    int form;
    int ctas;     // CTAs a lane (1 but in the cluster form)
    int threads;  // a CTA's
    size_t smem;
};

inline int optin_smem() {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    return optin;
}

// the first form: one CTA per lane, the window in shared memory while it fits
inline FloodPlan lane_cta_plan(int Wx, int Wy, bool sweep) {
    const int64_t cells = (int64_t)Wx * Wy;
    const size_t need = (size_t)(sweep ? 3 : 4) * cells * sizeof(uint32_t);
    int64_t threads = sweep ? (Wx > Wy ? Wx : Wy) : cells;
    threads = ((threads + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    return {kLaneCta, 1, (int)threads, need <= kMaxSmem ? need : 0};
}

// How the sweep runs a (Wx, Wy) window on the current device: one CTA a
// lane of one warp per 32 columns (at most kLaneWarps) where the packed
// window fits in a block's shared memory; else one cluster a lane of the
// most CTAs (16, 8, 4, 2) whose bands fit one warp's columns (Bx <= 32,
// for the y sweeps) and whose rows fit the CTA's warps (Wy <= 512, for the
// x sweeps), in a block's shared memory, and that the device can hold;
// else the first form. The answer depends on the shape and the device only.
inline FloodPlan plan_sweep(int Wx, int Wy) {
    const size_t optin = (size_t)optin_smem();
    const int warps = ((Wx > Wy ? Wx : Wy) + 31) / 32;
    if (warps <= kLaneWarps) {
        const size_t smem = packed_layout(Wx, Wy, warps).total;
        if (smem <= optin) return {kWarps, 1, 32 * warps, smem};
    }
    const void* kern = (const void*)xs_sweep_packed;
    for (int C = 16; C >= 2 && Wy <= kClusterThreads; C /= 2) {
        const int Bx = (Wx + C - 1) / C;
        if ((C - 1) * Bx >= Wx || Bx > 32) continue;
        const size_t smem = packed_layout(Bx, Wy, kClusterThreads / 32).total;
        if (smem > optin) continue;
        if (cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem) != cudaSuccess ||
            (C > 8 && cudaFuncSetAttribute(
                          kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                          1) != cudaSuccess)) {
            cudaGetLastError();
            continue;
        }
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = C;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(C, 1);
        cfg.blockDim = dim3(kClusterThreads);
        cfg.dynamicSmemBytes = smem;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int clusters = 0;
        if (cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) !=
                cudaSuccess ||
            clusters < 1) {
            cudaGetLastError();
            continue;
        }
        return {kCluster, C, kClusterThreads, smem};
    }
    return lane_cta_plan(Wx, Wy, true);
}

inline FloodPlan cached_plan(int Wx, int Wy, bool sweep) {
    if (!sweep) return lane_cta_plan(Wx, Wy, false);
    static std::mutex lock;
    static std::map<std::tuple<int, int, int>, FloodPlan> plans;
    int dev = 0;
    cudaGetDevice(&dev);
    const std::tuple<int, int, int> key(dev, Wx, Wy);
    std::lock_guard<std::mutex> guard(lock);
    const auto found = plans.find(key);
    if (found != plans.end()) return found->second;
    const FloodPlan plan = plan_sweep(Wx, Wy);
    plans[key] = plan;
    return plan;
}

int run_packed(const FloodPlan& plan, const void* seed, const void* secb,
               const void* zb, void* kept, void* changed, void* nrun, int B,
               int Wx, int Wy, int rounds, cudaStream_t st) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)xs_sweep_packed,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (e == cudaSuccess && plan.ctas > 8) {
        e = cudaFuncSetAttribute(
            (const void*)xs_sweep_packed,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e != cudaSuccess) return (int)e;
    const int Bx = (Wx + plan.ctas - 1) / plan.ctas;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = plan.ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(plan.ctas, B);
    cfg.blockDim = dim3(plan.threads);
    cfg.dynamicSmemBytes = plan.smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = plan.ctas > 1 ? 1 : 0;
    return (int)cudaLaunchKernelEx(
        &cfg, xs_sweep_packed, (const int32_t*)seed, (const int32_t*)secb,
        (const int32_t*)zb, (int32_t*)kept, (int32_t*)changed,
        (int32_t*)nrun, Wx, Wy, Bx, rounds);
}

}  // namespace

extern "C" {

// seed, secb, zb, kept, scratch: (B, Wx, Wy) int32 contiguous (scratch is
// used by the dilation only and may be NULL for the sweep); changed, nrun:
// (B,) int32. secb and seed hold K-bit words; where secb is not 0, zb fits
// int16 (the packed forms store it so). Returns a cudaError_t code (0 =
// success).
int kt_xs_flood(const void* seed, const void* secb, const void* zb,
                void* kept, void* scratch, void* changed, void* nrun, int B,
                int Wx, int Wy, int rounds, int sweep, void* stream) {
    if (B < 1 || B > 65535 || Wx < 1 || Wy < 1 || rounds < 0) {
        return (int)cudaErrorInvalidValue;
    }
    const int64_t cells = (int64_t)Wx * Wy;
    if (cells > (1 << 28) || (!sweep && scratch == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
    const FloodPlan plan = cached_plan(Wx, Wy, sweep != 0);
    if (plan.form != kLaneCta) {
        return run_packed(plan, seed, secb, zb, kept, changed, nrun, B, Wx,
                          Wy, rounds, st);
    }
    if (sweep) {
        return launch<true>(seed, secb, zb, kept, scratch, changed, nrun, B,
                            Wx, Wy, rounds, plan.threads, plan.smem, st);
    }
    return launch<false>(seed, secb, zb, kept, scratch, changed, nrun, B, Wx,
                         Wy, rounds, plan.threads, plan.smem, st);
}

// How X1 runs a (Wx, Wy) window on the current device: returns the form (0
// one CTA a lane, 1 one CTA of a warp per 32 columns a lane, 2 one cluster
// a lane) with the CTAs a lane and whether the window lies in shared
// memory.
int kt_xs_flood_plan(int Wx, int Wy, int sweep, int* ctas, int* in_smem) {
    if (Wx < 1 || Wy < 1) return -1;
    const FloodPlan plan = cached_plan(Wx, Wy, sweep != 0);
    *ctas = plan.ctas;
    *in_smem = plan.form != kLaneCta || plan.smem > 0;
    return plan.form;
}

}  // extern "C"
