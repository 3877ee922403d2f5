// G1: the graph gate of a voxel graph, the word that B1-vg, B4-vg and
// B5-vg read at each voxel (ops.stencils.graph_into): bit GRAPH_BITS[o] of
// the gate at v is set where u = v + o lies in the volume and u's bit
// GRAPH_BITS[-o] (the move u -> v) is set. The moves run along the last
// three axes of a (lanes, X, Y, Z) batch; a lane never reads another.
//
// Replaces the per-move lookup of the JAX package's graph-gated scans,
// kimimaro_tpu/ops/geodesic.py:444 (`shifted(graph_allows(vgp, neg_o),
// po, False)`, also ops/ccl.py:86), which the port hoists out of the
// sweeps into one word per voxel. Its plain torch version reads the 26
// shifted copies one after another: four elementwise passes a move, over
// 100 launches and about 1.2 KB of memory traffic a voxel (0.47-0.59 s of
// a self-touch 512^3 run on the H100, built once per crop-engine lane
// set). Here one thread a voxel reads its 26 neighbours' words (through
// the read-only cache: a warp's rows overlap) and writes its gate once:
// 8 bytes a voxel of HBM traffic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the bit of each of the 27 offsets (dx + 1) * 9 + (dy + 1) * 3 + dz + 1
// (the centre unused), and the bit of its reverse
struct GateBits {
    int bit[27];
    int back[27];
};

__global__ void graph_into_kernel(const uint32_t* __restrict__ vg,
                                  uint32_t* __restrict__ gate,
                                  int64_t lane_rows, int X, int Y, int Z,
                                  GateBits t) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (y >= Y || z >= Z) return;
    const int64_t YZ = (int64_t)Y * Z;
    for (int64_t row = blockIdx.z; row < lane_rows; row += gridDim.z) {
        const int x = (int)(row % X);
        const int64_t v = row * YZ + (int64_t)y * Z + z;
        uint32_t g = 0u;
#pragma unroll
        for (int k = 0; k < 27; ++k) {
            if (k == 13) continue;
            const int dx = k / 9 - 1, dy = (k / 3) % 3 - 1, dz = k % 3 - 1;
            if (x + dx < 0 || x + dx >= X || y + dy < 0 || y + dy >= Y ||
                z + dz < 0 || z + dz >= Z) {
                continue;
            }
            const uint32_t w = __ldg(vg + v + dx * YZ + dy * Z + dz);
            g |= ((w >> t.back[k]) & 1u) << t.bit[k];
        }
        gate[v] = g;
    }
}

}  // namespace

extern "C" {

// vg, gate: uint32 (lanes, X, Y, Z) contiguous; bits: 54 ints, the bit of
// each offset of the 3 x 3 x 3 neighbourhood in (dx, dy, dz) order, then
// the bit of each reverse (the centre's ignored). Returns a cudaError_t
// code (0 = success).
int kt_graph_into(const void* vg, void* gate, long long lanes, int X, int Y,
                  int Z, const int* bits, void* stream) {
    if (lanes < 0 || X < 0 || Y < 0 || Z < 0) return (int)cudaErrorInvalidValue;
    if (lanes == 0 || X == 0 || Y == 0 || Z == 0) return 0;
    GateBits t;
    for (int k = 0; k < 27; ++k) {
        t.bit[k] = bits[k];
        t.back[k] = bits[27 + k];
        if (k != 13 && (t.bit[k] < 0 || t.bit[k] > 31 || t.back[k] < 0 ||
                        t.back[k] > 31)) {
            return (int)cudaErrorInvalidValue;
        }
    }
    const int64_t rows = (int64_t)lanes * X;
    const dim3 block(32, 8);
    const dim3 grid((Z + 31) / 32, (Y + 7) / 8,
                    (unsigned)(rows < 65535 ? rows : 65535));
    graph_into_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)vg, (uint32_t*)gate, rows, X, Y, Z, t);
    return (int)cudaGetLastError();
}

}  // extern "C"
