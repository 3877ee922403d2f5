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
// or two 32-byte sectors whatever the plane's slope.
//
// What bounds it on this card: not device memory, nor arithmetic (there
// is next to none), but the L2 sectors its column reads touch.
// Neighbouring window columns lie tz * 4 bytes apart (2 KB at 512^3), so
// each warp load touches 32 sectors whatever the form, and a cell's 20
// bytes take one or two 32-byte sectors; the windows of a batch overlap,
// so the distinct bytes (its bound) are a small part of that traffic,
// served from L2. The first form did one cell a thread with three 64-bit
// divisions by runtime sizes and five dependent 4-byte loads, one chain
// of loads in flight a thread. This form:
// - a 2-D grid, the lane in blockIdx.y (strided past 65,535 lanes) and the
//   lane's cells in blockIdx.x; 32-bit index arithmetic, one division-free
//   split of a thread's first cell into (i, j);
// - four consecutive window cells a thread: their zb as one 16-byte load
//   and their words as one 16-byte store where the lane's cells start on a
//   16-byte boundary (Wx * Wy % 4 == 0), four 4-byte ones otherwise;
// - every column load of the four cells issued before any compare, each
//   load unconditional (addresses clamped into the volume, the results
//   masked), so 8 to 20 loads are in flight a thread;
// - where tz % 4 == 0 and the volume's base is 16-byte aligned (decided
//   by the wrapper, ops.xsfetch.fetch_plan), a cell's five values come as
//   two 16-byte read-only loads of the aligned 8-word span holding zb ..
//   zb + 4; each half lies wholly inside or wholly outside [0, tz), and
//   the five bits are one shift of the span's 8 match bits (no indexing
//   of registers). Other volumes take five 4-byte loads a cell.
// No shared memory and no TMA: with z last, the columns of a tile of
// cells span up to Wx + Wy + K planes in z, so a box copy would fetch more
// than ten times the bytes the cells use. Neighbouring lanes' windows
// overlap along a skeleton; those repeats are L2's to serve.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 5;
constexpr int kCells = 4;  // window cells a thread
constexpr int kMaxThreads = 256;
constexpr int kMaxLanesY = 65535;

// n / Wy for n < 2^31 by its magic divisor (see csrc/fma.cu)
__device__ __forceinline__ unsigned divide(unsigned n, unsigned magic,
                                           unsigned shift) {
    return (__umulhi(n, magic) + n) >> shift;
}

// bit e = [v's word e == lab]
__device__ __forceinline__ uint32_t match4(int4 v, int lab) {
    return (uint32_t)(v.x == lab) | (uint32_t)(v.y == lab) << 1 |
           (uint32_t)(v.z == lab) << 2 | (uint32_t)(v.w == lab) << 3;
}

// The words of n (<= kCells) consecutive cells of lane b, from cell c0 =
// (i0, j0).
template <bool kVec>
__device__ __forceinline__ void fetch_cells(
    const int32_t* __restrict__ vol, const int32_t* __restrict__ zb,
    const int32_t* __restrict__ wx0, const int32_t* __restrict__ wy0,
    const int32_t* __restrict__ labels, int32_t* __restrict__ out, int tx,
    int ty, int tz, int Wy, unsigned cells, bool vec_io, int b, unsigned c0,
    int n, int i0, int j0) {
    const long long lane = (long long)b * cells;
    const int lab = __ldg(labels + b);
    const int bx = __ldg(wx0 + b), by = __ldg(wy0 + b);
    int z0[kCells];
    if (vec_io && n == kCells) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(zb + lane + c0));
        z0[0] = v.x, z0[1] = v.y, z0[2] = v.z, z0[3] = v.w;
    } else {
#pragma unroll
        for (int k = 0; k < kCells; ++k) {
            z0[k] = k < n ? __ldg(zb + lane + c0 + k) : 0;
        }
    }
    // each cell's column (a clamped one outside the volume)
    const int32_t* col[kCells];
    bool inside[kCells];
    int i = i0, j = j0;
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
        const int gx = bx + i, gy = by + j;
        inside[k] = k < n && gx >= 0 && gx < tx && gy >= 0 && gy < ty;
        const int cx = inside[k] ? gx : 0, cy = inside[k] ? gy : 0;
        col[k] = vol + (long long)(cx * ty + cy) * tz;
        if (++j == Wy) {
            j = 0;
            ++i;
        }
    }
    uint32_t bits[kCells];
    if (kVec) {
        // the aligned 8-word span base .. base + 7 holding z0 .. z0 + 4
        int4 lo[kCells], hi[kCells];
        bool lo_in[kCells], hi_in[kCells];
#pragma unroll
        for (int k = 0; k < kCells; ++k) {
            const int base = z0[k] & ~3;
            lo_in[k] = base >= 0 && base < tz;
            hi_in[k] = base + 4 >= 0 && base + 4 < tz;
            const int4* p = reinterpret_cast<const int4*>(col[k]);
            lo[k] = __ldg(p + (lo_in[k] ? base >> 2 : 0));
            hi[k] = __ldg(p + (hi_in[k] ? (base >> 2) + 1 : 0));
        }
#pragma unroll
        for (int k = 0; k < kCells; ++k) {
            const uint32_t span = (lo_in[k] ? match4(lo[k], lab) : 0u) |
                                  (hi_in[k] ? match4(hi[k], lab) : 0u) << 4;
            bits[k] = inside[k] ? (span >> (z0[k] & 3)) & 31u : 0u;
        }
    } else {
        int v[kCells][K];
#pragma unroll
        for (int k = 0; k < kCells; ++k) {
#pragma unroll
            for (int e = 0; e < K; ++e) {
                const int z = min(max(z0[k] + e, 0), tz - 1);
                v[k][e] = __ldg(col[k] + z);
            }
        }
#pragma unroll
        for (int k = 0; k < kCells; ++k) {
            uint32_t w = 0;
#pragma unroll
            for (int e = 0; e < K; ++e) {
                const int z = z0[k] + e;
                w |= (uint32_t)(z >= 0 && z < tz && v[k][e] == lab) << e;
            }
            bits[k] = inside[k] ? w : 0u;
        }
    }
    if (vec_io && n == kCells) {
        *reinterpret_cast<int4*>(out + lane + c0) = make_int4(
            (int)bits[0], (int)bits[1], (int)bits[2], (int)bits[3]);
    } else {
#pragma unroll
        for (int k = 0; k < kCells; ++k) {
            if (k < n) out[lane + c0 + k] = (int32_t)bits[k];
        }
    }
}

// blockIdx.x: a run of kCells * blockDim.x cells of a window; blockIdx.y:
// the lane (strided by the grid's y extent past 65,535 lanes)
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
xs_fetch_kernel(const int32_t* __restrict__ vol,
                const int32_t* __restrict__ zb,
                const int32_t* __restrict__ wx0,
                const int32_t* __restrict__ wy0,
                const int32_t* __restrict__ labels,
                int32_t* __restrict__ out, int tx, int ty, int tz, int B,
                int Wy, unsigned cells, unsigned magic, unsigned shift,
                int vec_io) {
    const unsigned c0 = kCells * (blockIdx.x * blockDim.x + threadIdx.x);
    if (c0 >= cells) return;
    const int n = min(kCells, (int)(cells - c0));
    const unsigned i0 = divide(c0, magic, shift);
    const int j0 = (int)(c0 - i0 * (unsigned)Wy);
    for (int b = blockIdx.y; b < B; b += gridDim.y) {
        fetch_cells<kVec>(vol, zb, wx0, wy0, labels, out, tx, ty, tz, Wy,
                          cells, vec_io != 0, b, c0, n, (int)i0, j0);
    }
}

}  // namespace

extern "C" {

// vol: (tx, ty, tz) int32; zb, out: (B, Wx, Wy) int32; wx0, wy0, labels:
// (B,) int32; all contiguous. vec: read a cell's column as two 16-byte
// loads (needs tz % 4 == 0 and a 16-byte aligned vol). magic, shift:
// the division-free split by Wy (ops.fma.magic_divisor). Returns a
// cudaError_t code (0 = success).
int kt_xs_fetch(const void* vol, const void* zb, const void* wx0,
                const void* wy0, const void* labels, void* out, int tx, int ty,
                int tz, int B, int Wx, int Wy, int vec, unsigned magic,
                unsigned shift, void* stream) {
    if (B < 1 || Wx < 1 || Wy < 1 || tx < 1 || ty < 1 || tz < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const long long cells = (long long)Wx * Wy;
    if (cells >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    if (vec && (tz % 4 != 0 || ((uintptr_t)vol & 15) != 0)) {
        return (int)cudaErrorInvalidValue;
    }
    // 16-byte zb loads and word stores where every lane's cells start on
    // a 16-byte boundary
    const int vec_io = cells % 4 == 0 && ((uintptr_t)zb & 15) == 0 &&
                       ((uintptr_t)out & 15) == 0;
    const long long quads = (cells + kCells - 1) / kCells;
    int threads = kMaxThreads;
    if (quads < kMaxThreads) threads = (int)((quads + 31) / 32 * 32);
    const dim3 grid((unsigned)((quads + threads - 1) / threads),
                    (unsigned)(B < kMaxLanesY ? B : kMaxLanesY));
    if (vec) {
        xs_fetch_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)vol, (const int32_t*)zb, (const int32_t*)wx0,
            (const int32_t*)wy0, (const int32_t*)labels, (int32_t*)out, tx,
            ty, tz, B, Wy, (unsigned)cells, magic, shift, vec_io);
    } else {
        xs_fetch_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)vol, (const int32_t*)zb, (const int32_t*)wx0,
            (const int32_t*)wy0, (const int32_t*)labels, (int32_t*)out, tx,
            ty, tz, B, Wy, (unsigned)cells, magic, shift, vec_io);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
