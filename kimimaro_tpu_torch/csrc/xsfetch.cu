// B6: the window foreground fetch of windowed cross sections.
//
// Replaces the Pallas kernel kimimaro_tpu/ops/xsfetch.py `fetch_secb`
// (`_fetch_impl`, `_kernel_factory`) and the element gather of
// kimimaro_tpu/ops/xsbatch.py `slab_sections_volume`. Per query lane b and
// window cell (i, j) it packs the K = 5 label tests of the cell's column:
//
//   bit k = [vol[wx0[b] + i, wy0[b] + j, zb[b, i, j] + k] == labels[b]]
//
// with bits whose z falls outside [0, tz) set to 0 (the gather path's
// z-validity mask). Windows start anywhere and have any (Wx, Wy): the TPU
// kernel's 128-aligned y starts and (16, 128) tiles are gone.
//
// Layout: the volume is the permuted contiguous copy with the plane's
// dominant axis LAST ((x, y, z) of the permuted frame), the copy the plain
// version gathers too. A cell's K values are then K consecutive int32, one
// or two 32-byte sectors whatever the plane's slope. The (x, z, y) layout
// of the TPU kernel would give neighbouring threads neighbouring addresses
// only for flat planes: the slope bound lets zb step by one cell per
// column, so a steep warp spreads over up to 32 z rows per k.
//
// What bounds it on the card: bytes. Each cell reads its zb word and K
// volume values and writes one word; no arithmetic to speak of. One thread
// per window cell, consecutive threads on consecutive window columns, a 1-D
// grid over lanes x cell tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 5;
constexpr int kThreads = 256;

__global__ void xs_fetch_kernel(const int32_t* __restrict__ vol,
                                const int32_t* __restrict__ zb,
                                const int32_t* __restrict__ wx0,
                                const int32_t* __restrict__ wy0,
                                const int32_t* __restrict__ labels,
                                int32_t* __restrict__ out, int tx, int ty,
                                int tz, int Wx, int Wy, int64_t tiles) {
    const int64_t b = blockIdx.x / tiles;
    const int64_t cells = (int64_t)Wx * Wy;
    const int64_t cell = (blockIdx.x % tiles) * kThreads + threadIdx.x;
    if (cell >= cells) return;
    const int i = (int)(cell / Wy);
    const int j = (int)(cell % Wy);
    const int gx = wx0[b] + i;
    const int gy = wy0[b] + j;
    const int64_t o = b * cells + cell;
    uint32_t bits = 0;
    if (gx >= 0 && gx < tx && gy >= 0 && gy < ty) {
        const int z0 = zb[o];
        const int lab = labels[b];
        const int32_t* col = vol + ((int64_t)gx * ty + gy) * tz;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int z = z0 + k;
            if (z >= 0 && z < tz && __ldg(col + z) == lab) bits |= 1u << k;
        }
    }
    out[o] = (int32_t)bits;
}

}  // namespace

extern "C" {

// vol: (tx, ty, tz) int32; zb, out: (B, Wx, Wy) int32; wx0, wy0, labels:
// (B,) int32; all contiguous. Returns a cudaError_t code (0 = success).
int kt_xs_fetch(const void* vol, const void* zb, const void* wx0,
                const void* wy0, const void* labels, void* out, int tx, int ty,
                int tz, int B, int Wx, int Wy, void* stream) {
    if (B < 1 || Wx < 1 || Wy < 1 || tx < 1 || ty < 1 || tz < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const int64_t tiles = ((int64_t)Wx * Wy + kThreads - 1) / kThreads;
    const int64_t blocks = tiles * B;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    xs_fetch_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)vol, (const int32_t*)zb, (const int32_t*)wx0,
        (const int32_t*)wy0, (const int32_t*)labels, (int32_t*)out, tx, ty,
        tz, Wx, Wy, tiles);
    return (int)cudaGetLastError();
}

}  // extern "C"
