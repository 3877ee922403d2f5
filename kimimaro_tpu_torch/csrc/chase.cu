// C1: the rail chase of the crop engine's path loop, every lane of a lane
// set walked to its rail in one launch.
//
// Replaces no Pallas kernel. The JAX package's chase is the jnp loop
// kimimaro_tpu/ops/fused_trace.py `_chase`, vmapped over the lanes of the
// crop engine; the port's plain version (ops/chase.py
// `_chase_batched_plain`) is a Python loop of one step at a time, some
// forty tensor operations a step and a blocking read every eight steps,
// until the slowest lane reaches a rail.
//
// Per lane: from `start`, while the lane has fewer than L vertices, write
// the vertex, stop if the rail field at it is <= 0 (reached), else step to
// the 26-neighbour of least rail distance (the first minimum in
// lexicographic offset order, the centre excluded; a window of +inf alone
// steps to offset 0, (-1, -1, -1), as argmin does; NaN is the least, as
// torch.argmin and jnp.argmin take it). Under a voxel graph a neighbour
// counts only where its bit for the move back is set. The reads follow
// JAX's index rule for scalar reads and dynamic slices on the padded field
// (a negative index counts from the end once, then clamps): the rail test
// reads wrap_clamp(cur + 1, size, size - 1), the window starts at
// wrap_clamp(cur, size, size - 3). The two differ at clamped edges, so the
// rail voxel is read apart from the window.
//
// What bounds it on the card: latency. A step is one dependent round trip
// to L2 (the next window depends on this step's argmin) and a few hundred
// bytes (27 floats, and 27 graph words); the lanes walk side by side. The
// least time of a chase is its longest walk's steps times one L2 round trip.
//
// The design: one warp a lane, one warp a block, so that the lanes spread
// over the SMs. Threads 0-26 each read one cell of the 3 x 3 x 3 window
// (and its graph word), thread 31 the rail voxel, all in the same step;
// the argmin is a butterfly of warp shuffles over (value, index) with the
// lower index winning ties, so every thread holds the step and no shared
// memory or barrier is needed. Lane 0 writes the path row; the rows after
// the last vertex are written -1 by the whole warp at the end.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRailThread = 31;

struct ChaseBits {
    int8_t bit[27];  // the graph bit that opens the step to window cell k
};

__device__ __forceinline__ int64_t wrap_clamp(int64_t idx, int64_t size,
                                              int64_t hi) {
    if (idx < 0) idx += size;
    if (idx < 0) idx = 0;
    return idx < hi ? idx : hi;
}

// (a, ka) before (b, kb) in argmin's order: NaN least, then smaller, then
// the lower index
__device__ __forceinline__ bool before(float a, int ka, float b, int kb) {
    const bool na = isnan(a), nb = isnan(b);
    if (na != nb) return na;
    if (!na && a != b) return a < b;
    return ka < kb;
}

template <bool kGraph>
__global__ void __launch_bounds__(32)
chase_lanes(const float* __restrict__ field, const int32_t* __restrict__ vg,
            const int64_t* __restrict__ start, int X, int Y, int Z, int L,
            ChaseBits bits, int64_t* __restrict__ path,
            int64_t* __restrict__ length, bool* __restrict__ reached) {
    const int lane = blockIdx.x;
    const int t = threadIdx.x;
    const int64_t vox = (int64_t)X * Y * Z;
    const float* f = field + lane * vox;
    const int32_t* g = kGraph ? vg + lane * vox : nullptr;
    const int64_t sy = Z, sx = (int64_t)Y * Z;
    // this thread's window cell, offsets + 1 along x, y, z
    const bool cell = t < 27 && t != 13;
    const int64_t woff = (t / 9) * sx + ((t / 3) % 3) * sy + t % 3;
    const int bit = t < 27 ? bits.bit[t] : 31;
    int64_t* row = path + (int64_t)lane * L * 3;

    int64_t cx = start[3 * lane + 0];
    int64_t cy = start[3 * lane + 1];
    int64_t cz = start[3 * lane + 2];
    int i = 0;
    bool hit = false;
    while (i < L) {
        if (t == 0) {
            row[3 * i + 0] = cx;
            row[3 * i + 1] = cy;
            row[3 * i + 2] = cz;
        }
        ++i;
        float v = INFINITY;
        int rail = 0;
        if (cell) {
            const int64_t base = wrap_clamp(cx, X, X - 3) * sx
                + wrap_clamp(cy, Y, Y - 3) * sy + wrap_clamp(cz, Z, Z - 3);
            v = __ldg(f + base + woff);
            if (kGraph && !((__ldg(g + base + woff) >> bit) & 1)) {
                v = INFINITY;
            }
        } else if (t == kRailThread) {
            const int64_t at = wrap_clamp(cx + 1, X, X - 1) * sx
                + wrap_clamp(cy + 1, Y, Y - 1) * sy
                + wrap_clamp(cz + 1, Z, Z - 1);
            rail = __ldg(f + at) <= 0.0f ? 1 : 0;
        }
        if (__shfl_sync(kFull, rail, kRailThread)) {
            hit = true;
            break;
        }
        int k = t;
        for (int s = 16; s > 0; s >>= 1) {
            const float ov = __shfl_xor_sync(kFull, v, s);
            const int ok = __shfl_xor_sync(kFull, k, s);
            if (before(ov, ok, v, k)) {
                v = ov;
                k = ok;
            }
        }
        cx += k / 9 - 1;
        cy += (k / 3) % 3 - 1;
        cz += k % 3 - 1;
    }
    for (int64_t e = 3 * (int64_t)i + t; e < 3 * (int64_t)L; e += 32) {
        row[e] = -1;
    }
    if (t == 0) {
        length[lane] = i;
        reached[lane] = hit;
    }
}

}  // namespace

extern "C" {

// field: float32 (B, X, Y, Z), the lanes' rail fields padded by one voxel
// (X, Y, Z >= 3); vg: int32 (B, X, Y, Z) padded voxel graphs, or null for
// the ungated form; start: int64 (B, 3); bits27: the graph bit of each
// window cell (host memory, copied into the launch). Outputs: path int64
// (B, L, 3), length int64 (B,), reached bool (B,). Returns a cudaError_t
// code.
int kt_chase_batched(const void* field, const void* vg, const void* start,
                     int B, int X, int Y, int Z, int L, const int* bits27,
                     void* path, void* length, void* reached, void* stream) {
    if (B <= 0) return 0;
    ChaseBits bits;
    for (int k = 0; k < 27; ++k) bits.bit[k] = (int8_t)bits27[k];
    cudaStream_t st = (cudaStream_t)stream;
    if (vg != nullptr) {
        chase_lanes<true><<<B, 32, 0, st>>>(
            (const float*)field, (const int32_t*)vg, (const int64_t*)start,
            X, Y, Z, L, bits, (int64_t*)path, (int64_t*)length,
            (bool*)reached);
    } else {
        chase_lanes<false><<<B, 32, 0, st>>>(
            (const float*)field, nullptr, (const int64_t*)start, X, Y, Z, L,
            bits, (int64_t*)path, (int64_t*)length, (bool*)reached);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
