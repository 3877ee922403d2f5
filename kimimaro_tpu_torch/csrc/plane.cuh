// Shared pieces of the plane-sweep kernels (gsweep.cu, sweep.cu).
//
// A directed sweep along axis 0 of an (n, H, W) volume relaxes plane i from
// the already relaxed plane i-1 through the nine (dy, dz) offsets. Planes
// depend on each other in order, so the host entry point walks the planes
// and launches one 2-D stencil kernel per plane on the caller's stream; the
// previous plane is read back from the output in device memory (it was
// written by the previous launch, which stream order completes first).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
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
inline void sweep_planes(int s, int n, int descending, int64_t* plane,
                         int64_t* prev) {
    *plane = descending ? (int64_t)(n - 1 - s) : (int64_t)s;
    if (s == 0) {
        *prev = -1;
    } else {
        *prev = descending ? *plane + 1 : *plane - 1;
    }
}

}  // namespace kt
