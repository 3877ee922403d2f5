// X1: the section flood of windowed cross sections.
//
// Replaces JAX code that has no Pallas kernel: the "sweep" flood
// kimimaro_tpu/ops/xsslab.py `_sweep_rounds` and the "dilate" flood of
// kimimaro_tpu/ops/xsbatch.py `_finish_section` (a lax.scan of 8-neighbour
// dilations). Each lane holds a (Wx, Wy) window of uint32 words; bit k of a
// word is the cell at z = zb + k of its column (K = 5). A neighbour
// column's bits re-base into this column's frame by a variable shift of the
// zb delta, and a +-1 shift adds the true-z dilation:
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
// Design: one CTA per lane. A directed sweep walks the rows in order, one
// thread per column (looping when the row is wider than the block), with a
// __syncthreads() per row; the carry is the previous row, updated in place.
// The dilation rounds are double-buffered. The words, section words and
// zb live in shared memory when they fit (W <= 128 for the sweep, three 64
// KB planes; W <= 64 for the dilation's four planes), else in device
// memory, where the L2 holds them. What bounds it on the card: the
// dependent row steps of the sweep (one barrier per row, 4 W per round)
// and, for the dilation, a few dozen integer operations per cell and
// round; the bytes are a few words per cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 5;
constexpr size_t kMaxSmem = 225 * 1024;

__device__ __forceinline__ uint32_t kdilate(uint32_t b) {
    return b | (b << 1) | (b >> 1);
}

// bits << delta for a signed delta clamped to +-31
__device__ __forceinline__ uint32_t var_shift(uint32_t bits, int delta) {
    const int d = max(-31, min(31, delta));
    return (bits << (d > 0 ? d : 0)) >> (d < 0 ? -d : 0);
}

__device__ __forceinline__ uint32_t infill(uint32_t r, uint32_t sb) {
#pragma unroll
    for (int s = 0; s < K - 1; ++s) r = (r | kdilate(r)) & sb;
    return r;
}

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

}  // namespace

extern "C" {

// seed, secb, zb, kept, scratch: (B, Wx, Wy) int32 contiguous (scratch is
// used by the dilation only and may be NULL for the sweep); changed, nrun:
// (B,) int32. Returns a cudaError_t code (0 = success).
int kt_xs_flood(const void* seed, const void* secb, const void* zb,
                void* kept, void* scratch, void* changed, void* nrun, int B,
                int Wx, int Wy, int rounds, int sweep, void* stream) {
    if (B < 1 || Wx < 1 || Wy < 1 || rounds < 0) {
        return (int)cudaErrorInvalidValue;
    }
    const int64_t cells = (int64_t)Wx * Wy;
    if (cells > (1 << 28) || (!sweep && scratch == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t need = (size_t)(sweep ? 3 : 4) * cells * sizeof(uint32_t);
    const size_t smem = need <= kMaxSmem ? need : 0;
    int64_t threads = sweep ? (Wx > Wy ? Wx : Wy) : cells;
    threads = ((threads + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    cudaStream_t st = (cudaStream_t)stream;
    if (sweep) {
        return launch<true>(seed, secb, zb, kept, scratch, changed, nrun, B,
                            Wx, Wy, rounds, (int)threads, smem, st);
    }
    return launch<false>(seed, secb, zb, kept, scratch, changed, nrun, B, Wx,
                         Wy, rounds, (int)threads, smem, st);
}

}  // extern "C"
