// B3: per-lane masked argmax over a box of a full volume.
//
// Replaces the Pallas kernel kimimaro_tpu/ops/pallas_argmax.py
// `crop_argmax` (`_kernel_factory`). Per lane: the first maximum of an f32
// field over the voxels with cc == lid inside the lane's box, a sub-box of
// its crop window [off, off + crop). Ties go to the first maximum in
// (x, y, z) lexicographic order, which is jnp.argmax over the crop's ravel
// for any box that holds the label's voxels of the window; a lane whose
// label holds only -inf (or no voxel at all, or whose box is empty)
// answers -inf at the window origin, like jnp.argmax. Returns global
// coordinates and the value.
//
// What bounds it on the card: bytes. Each voxel of a box is read once (4
// bytes of field, 4 of cc) and nothing else is done with it, so the least
// time is the union of the boxes over the memory rate. What kept the first
// form (one CTA per lane over the lane's whole window, one launch per crop
// tier) far from that: it read the windows, not the labels (2,048 windows
// of 96^3 are 14 times a 512^3 volume), a lane was one CTA however large,
// and padding lanes and finished lanes were scanned like any other.
//
// The design: the caller passes each lane's own box (the label's bounding
// box; size 0 for a lane with nothing to scan), and all lanes of all tiers
// go through one group of three launches.
//   1. `argmax_prep` (one CTA) counts each lane's (x, y) rows, takes their
//      running sum and resets each lane's key.
//   2. `argmax_scan` cuts the concatenated rows of all lanes into equal
//      runs, one per warp of a grid sized from the SM count, whatever the
//      lanes' sizes: a large label is shared by many CTAs, many small ones
//      by one. A warp reads a row along z (coalesced) and keeps per thread
//      a packed 64-bit key: the value's bits made order-preserving in the
//      high word, the complement of the box-relative flat index in the low
//      word, so that max(key) is "larger value, then smaller index". When
//      its run crosses into the next lane the warp reduces with shuffles
//      and makes one 64-bit atomicMax into the lane's slot. A maximum
//      does not depend on the order of the atomics, so the result is the
//      same in every run.
//   3. `argmax_decode` turns each key back into global coordinates and
//      reads the value there (so that -0.0 comes back as it was stored:
//      the keys order it equal to 0.0, as the comparison does).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 16;

// key of (-inf, index 0): what a lane answers when nothing beats it
constexpr uint32_t kEmptyHi = 0x007FFFFFu;
constexpr unsigned long long kEmptyKey =
    ((unsigned long long)kEmptyHi << 32) | 0xFFFFFFFFull;

__device__ __forceinline__ unsigned long long pack_key(float v, uint32_t idx) {
    if (v == 0.0f) v = 0.0f;  // -0.0 and 0.0 compare equal: one key
    const uint32_t u = __float_as_uint(v);
    const uint32_t hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((unsigned long long)hi << 32) | (0xFFFFFFFFu - idx);
}

__device__ __forceinline__ int64_t lane_rows(const int32_t* box_size, int i) {
    const int bx = box_size[3 * i + 0];
    const int by = box_size[3 * i + 1];
    const int bz = box_size[3 * i + 2];
    return (bx > 0 && by > 0 && bz > 0) ? (int64_t)bx * by : 0;
}

// row_start[i]: (x, y) rows of the lanes before lane i; row_start[N]: all.
__global__ void argmax_prep(const int32_t* __restrict__ box_size, int N,
                            int64_t* __restrict__ row_start,
                            unsigned long long* __restrict__ keys) {
    __shared__ int64_t part[kThreads];
    const int chunk = (N + kThreads - 1) / kThreads;
    const int lo = min((int)threadIdx.x * chunk, N);
    const int hi = min(lo + chunk, N);
    int64_t sum = 0;
    for (int i = lo; i < hi; ++i) sum += lane_rows(box_size, i);
    part[threadIdx.x] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
        int64_t run = 0;
        for (int t = 0; t < kThreads; ++t) {
            const int64_t s = part[t];
            part[t] = run;
            run += s;
        }
        row_start[N] = run;
    }
    __syncthreads();
    int64_t run = part[threadIdx.x];
    for (int i = lo; i < hi; ++i) {
        row_start[i] = run;
        run += lane_rows(box_size, i);
        keys[i] = kEmptyKey;
    }
}

__global__ void __launch_bounds__(kThreads)
argmax_scan(const float* __restrict__ field, const int32_t* __restrict__ cc,
            const int32_t* __restrict__ lids,
            const int32_t* __restrict__ box_off,
            const int32_t* __restrict__ box_size,
            const int64_t* __restrict__ row_start, int N, int Y, int Z,
            unsigned long long* keys) {
    const int64_t total = row_start[N];
    const int64_t c0 = total * blockIdx.x / gridDim.x;
    const int64_t c1 = total * (blockIdx.x + 1) / gridDim.x;
    const int warp = threadIdx.x / 32;
    const int wl = threadIdx.x % 32;
    const int64_t r0 = c0 + (c1 - c0) * warp / kWarps;
    const int64_t r1 = c0 + (c1 - c0) * (warp + 1) / kWarps;
    if (r0 >= r1) return;

    // the lane that holds row r0: row_start[lane] <= r0 < row_start[lane+1]
    int lane = 0;
    for (int hi = N; hi - lane > 1;) {
        const int mid = (lane + hi) / 2;
        if (row_start[mid] <= r0) {
            lane = mid;
        } else {
            hi = mid;
        }
    }

    unsigned long long best = kEmptyKey;
    auto flush = [&]() {
        for (int s = 16; s > 0; s >>= 1) {
            const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, best, s);
            best = o > best ? o : best;
        }
        if (wl == 0 && best != kEmptyKey) atomicMax(keys + lane, best);
        best = kEmptyKey;
    };

    int64_t start = row_start[lane];
    int64_t next = row_start[lane + 1];
    int ox = box_off[3 * lane + 0], oy = box_off[3 * lane + 1];
    int oz = box_off[3 * lane + 2];
    int by = box_size[3 * lane + 1], bz = box_size[3 * lane + 2];
    int32_t lid = lids[lane];
    for (int64_t r = r0; r < r1; ++r) {
        if (r >= next) {
            flush();
            do {
                ++lane;
                next = row_start[lane + 1];
            } while (r >= next);
            start = row_start[lane];
            ox = box_off[3 * lane + 0];
            oy = box_off[3 * lane + 1];
            oz = box_off[3 * lane + 2];
            by = box_size[3 * lane + 1];
            bz = box_size[3 * lane + 2];
            lid = lids[lane];
        }
        const uint32_t rr = (uint32_t)(r - start);
        const int x = (int)(rr / (uint32_t)by);
        const int y = (int)(rr - (uint32_t)x * (uint32_t)by);
        const int64_t gbase = ((int64_t)(ox + x) * Y + (oy + y)) * Z + oz;
        const uint32_t fbase = rr * (uint32_t)bz;
#pragma unroll 2
        for (int z = wl; z < bz; z += 32) {
            const int32_t c = __ldg(cc + gbase + z);
            const float v = __ldg(field + gbase + z);
            if (c == lid) {
                const unsigned long long k = pack_key(v, fbase + (uint32_t)z);
                best = k > best ? k : best;
            }
        }
    }
    flush();
}

__global__ void argmax_decode(const float* __restrict__ field,
                              const int32_t* __restrict__ offs,
                              const int32_t* __restrict__ box_off,
                              const int32_t* __restrict__ box_size,
                              const unsigned long long* __restrict__ keys,
                              int N, int Y, int Z,
                              int32_t* __restrict__ coords,
                              float* __restrict__ vals) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    const unsigned long long key = keys[i];
    if ((uint32_t)(key >> 32) == kEmptyHi) {
        coords[3 * i + 0] = offs[3 * i + 0];
        coords[3 * i + 1] = offs[3 * i + 1];
        coords[3 * i + 2] = offs[3 * i + 2];
        vals[i] = -INFINITY;
        return;
    }
    const uint32_t idx = 0xFFFFFFFFu - (uint32_t)key;
    const uint32_t by = (uint32_t)box_size[3 * i + 1];
    const uint32_t bz = (uint32_t)box_size[3 * i + 2];
    const uint32_t x = idx / (by * bz);
    const uint32_t rem = idx - x * (by * bz);
    const uint32_t y = rem / bz;
    const uint32_t z = rem - y * bz;
    const int gx = box_off[3 * i + 0] + (int)x;
    const int gy = box_off[3 * i + 1] + (int)y;
    const int gz = box_off[3 * i + 2] + (int)z;
    coords[3 * i + 0] = gx;
    coords[3 * i + 1] = gy;
    coords[3 * i + 2] = gz;
    vals[i] = field[((int64_t)gx * Y + gy) * Z + gz];
}

}  // namespace

extern "C" {

// field: float32 (X, Y, Z); cc: int32 (X, Y, Z); offs: int32 (N, 3) window
// origins; lids: int32 (N,); box_off, box_size: int32 (N, 3), each box
// inside the volume and of fewer than 2^32 voxels, size 0 allowed.
// Scratch from the caller: row_start int64 (N + 1,), keys int64 (N,).
// Outputs: coords int32 (N, 3), vals float32 (N,). Returns a cudaError_t
// code.
int kt_crop_argmax(const void* field, const void* cc, const void* offs,
                   const void* lids, const void* box_off,
                   const void* box_size, int N, int X, int Y, int Z,
                   void* row_start, void* keys, void* coords, void* vals,
                   void* stream) {
    (void)X;
    if (N <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    argmax_prep<<<1, kThreads, 0, st>>>(
        (const int32_t*)box_size, N, (int64_t*)row_start,
        (unsigned long long*)keys);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    argmax_scan<<<sms * kCtasPerSm, kThreads, 0, st>>>(
        (const float*)field, (const int32_t*)cc, (const int32_t*)lids,
        (const int32_t*)box_off, (const int32_t*)box_size,
        (const int64_t*)row_start, N, Y, Z, (unsigned long long*)keys);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    argmax_decode<<<(N + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        (const float*)field, (const int32_t*)offs, (const int32_t*)box_off,
        (const int32_t*)box_size, (const unsigned long long*)keys, N, Y, Z,
        (int32_t*)coords, (float*)vals);
    return (int)cudaGetLastError();
}

}  // extern "C"
