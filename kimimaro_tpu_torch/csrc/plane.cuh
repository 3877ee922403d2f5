// Shared pieces of the plane-sweep kernels (gsweep.cu, sweep.cu).
//
// A directed sweep along axis 0 of an (n, H, W) volume relaxes plane i from
// the already relaxed plane i-1 through the nine (dy, dz) offsets, so the
// planes of one sweep depend on each other in order. Two forms share this
// header:
//
//   * per plane (B1, B4, B5, and B2 for planes too large to hold): the host
//     entry point walks the planes and launches one 2-D stencil kernel per
//     plane on the caller's stream; the previous plane is read back from
//     the output in device memory. Its cost on this card is the launch
//     cadence (about 7 us a plane), not the bytes.
//   * persistent strips (B2): one launch per sweep. CTA g owns the rows
//     [g * R, g * R + R) of every plane at full width and walks the planes
//     in a loop; the previous plane's strip stays in shared memory, the
//     operands of the next plane arrive through cp.async stages, and a CTA
//     waits only for its two neighbours: each posts its edge rows, every
//     value with the step's number in one 64-bit word, to a mailbox in
//     device memory, and spins on the neighbours' mailboxes for its halo
//     rows. The grid is launched co-resident
//     (cudaLaunchCooperativeKernel), so every spin ends; a spin that does
//     not end traps.
//
// The strip geometry, the mailboxes and the stage copies below are what a
// kernel of the second form is built from.
#pragma once

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
// persistent strips

constexpr int kStripThreads = 512;
// operand stages: the plane being relaxed and the next one (three and
// four stages were slower on the H100)
constexpr int kStages = 2;

// Rows per strip and strips per plane for a grid of at most `max_ctas`
// co-resident CTAs: the fewest rows that still cover H.
struct Strips {
    int rows;   // R: rows of every strip but possibly the last
    int count;  // G: strips = CTAs
};

inline Strips make_strips(int H, int max_ctas) {
    Strips s;
    s.rows = (H + max_ctas - 1) / max_ctas;
    if (s.rows < 1) s.rows = 1;
    s.count = (H + s.rows - 1) / s.rows;
    return s;
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

// polls after which a wait gives up (seconds of spinning): a wrong
// protocol becomes an error, not a hung card
constexpr long long kMaxPolls = 1LL << 24;

// A mailbox cell is one 64-bit word: a float's bits below, the number of
// the step that wrote it (from 1; 0 is "never") above. An aligned 64-bit
// store or load is single-copy atomic, so a reader that sees the step it
// waits for has the value of that step: no fence and no separate flag.
__device__ __forceinline__ void mail_post(unsigned long long* cell, float v,
                                          int step) {
    const unsigned long long w =
        ((unsigned long long)(unsigned)step << 32) | __float_as_uint(v);
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                 :: "l"(cell), "l"(w) : "memory");
}

// Spin until the cell holds the value of `step`.
__device__ __forceinline__ float mail_wait(const unsigned long long* cell,
                                           int step) {
    long long polls = 0;
    for (;;) {
        unsigned long long w;
        asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                     : "=l"(w) : "l"(cell) : "memory");
        if ((int)(w >> 32) == step) return __uint_as_float((unsigned)w);
        if (++polls > kMaxPolls) {
            printf("plane sweep: strip %d waited for step %d in vain\n",
                   (int)blockIdx.x, step);
            __trap();
        }
    }
}

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

// Copy `bytes` contiguous bytes into a stage: 16 bytes a thread through
// cp.async where ASYNC (source, destination and size multiples of 16),
// else plain 4-byte or 1-byte loads (bytes a multiple of ELEM).
template <bool ASYNC, int ELEM>
__device__ __forceinline__ void stage_copy(void* smem, const void* gmem,
                                           int64_t bytes) {
    if (ASYNC) {
        const int64_t chunks = bytes / 16;
        for (int64_t c = threadIdx.x; c < chunks; c += blockDim.x) {
            cp_async16((char*)smem + 16 * c, (const char*)gmem + 16 * c);
        }
    } else if (ELEM == 4) {
        const int64_t words = bytes / 4;
        for (int64_t c = threadIdx.x; c < words; c += blockDim.x) {
            ((uint32_t*)smem)[c] = __ldg((const uint32_t*)gmem + c);
        }
    } else {
        for (int64_t c = threadIdx.x; c < bytes; c += blockDim.x) {
            ((uint8_t*)smem)[c] = __ldg((const uint8_t*)gmem + c);
        }
    }
}

}  // namespace kt
