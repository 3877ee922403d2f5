// G1: the graph gate of a voxel graph, the word that B1-vg, B4-vg and
// B5-vg read at each voxel (ops.stencils.graph_into), in two forms:
//
//   lane sets (B4-vg, B5-vg): bit GRAPH_BITS[o] of the gate at v is set
//     where u = v + o lies in the volume and u's bit GRAPH_BITS[-o] (the
//     move u -> v) is set;
//   CCL (B1-vg, labels given): the same bit only where also
//     labels[u] == labels[v] != 0, and bit 26 (OCC) where labels[v] != 0,
//     so that the CCL's sweeps read the ids and this word alone.
//
// The moves run along the last three axes of a (lanes, X, Y, Z) batch; a
// lane never reads another.
//
// Replaces the per-move lookup of the JAX package's graph-gated scans,
// kimimaro_tpu/ops/geodesic.py:444 (`shifted(graph_allows(vgp, neg_o),
// po, False)`), and with labels the label compare and that lookup of
// kimimaro_tpu/ops/ccl.py:76-90 (`nb_l == cur_l`, the neighbour's bit for
// the move into the voxel), which the port hoists out of the sweeps into
// one word per voxel.
//
// What bounds it: 8 bytes a voxel of HBM traffic (12 with labels), and 26
// bit moves a voxel (with labels 26 label compares too) of integer work,
// which a voxel's 26 reads of its neighbours must not multiply. A CTA owns
// a (TY x TZ) tile of one lane and walks that lane's X planes in order:
//   * the planes of the tile with their one-cell border land in shared
//     memory by 4-byte cp.async, two planes ahead of the one read (a ring
//     of three slots); cells outside the volume or the lane are filled
//     with zero words by the copy itself (src-size 0), and a zero word
//     opens no move, so no bounds test is left in the stencil;
//   * a thread gates a column of 4 voxels (2 in the CCL form); it keeps
//     its 6 x 3 (4 x 3) cells of words (and labels) of the planes x - 1, x
//     and x + 1 in three register sets that take turns (the plane loop
//     unrolled by three), and reads only the new cells of x + 1 a plane;
//   * the 26 bit moves go by shift: the bit of a neighbour moves from
//     GRAPH_BITS[-o] to GRAPH_BITS[o], and those 26 moves take only eight
//     distances (+-1, 3, 5, 7), so the bits of one distance are masked into
//     one word (an and-or each; with labels a label compare before each)
//     and shifted once;
//   * the gate is stored coalesced along z.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOcc = 26;  // the CCL form's occupancy bit

// GRAPH_BITS (ops.stencils) of the offset k = (dx + 1) * 9 + (dy + 1) * 3 +
// dz + 1 of the 3 x 3 x 3 neighbourhood (the centre -1); the reverse of
// offset k is offset 26 - k
__host__ __device__ constexpr int graph_bit(int k) {
    constexpr int t[27] = {25, 9,  21, 15, 1,  11, 23, 7, 19,
                           17, 3,  13, 5,  -1, 4,  16, 2, 12,
                           24, 8,  20, 14, 0,  10, 22, 6, 18};
    return t[k];
}

// the distance a neighbour's bit moves: GRAPH_BITS[o] - GRAPH_BITS[-o]
__host__ __device__ constexpr int move_shift(int k) {
    return graph_bit(k) - graph_bit(26 - k);
}

// 4-byte asynchronous copy into shared memory of the first n (4 or 0)
// bytes at gmem, the rest filled with zero (n = 0: nothing is read)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          unsigned n) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Rows of a tile column that one thread gates: the cells of a plane that
// it reads are (rows + 2) x 3 for `rows` voxels. The CCL form keeps twice
// the words in registers, so it takes fewer rows.
template <bool LABELS>
__host__ __device__ constexpr int rows() {
    return LABELS ? 2 : 4;
}

template <bool LABELS>
__host__ __device__ constexpr int col() {
    return (rows<LABELS>() + 2) * 3;
}

// The gate word of the voxel in row r of a thread's column from its
// 3 x 3 x 3 neighbourhood: the words (and labels: LABELS) of the planes
// x - 1 (a), x (b) and x + 1 (c), each at (r + dy + 1) * 3 + dz + 1.
template <bool LABELS, int C = col<LABELS>()>
__device__ __forceinline__ uint32_t gate_word(
    int r, const uint32_t (&wa)[C], const int32_t (&la)[C],
    const uint32_t (&wb)[C], const int32_t (&lb)[C], const uint32_t (&wc)[C],
    const int32_t (&lc)[C]) {
    const int32_t lv = lb[3 * r + 4];
    // the bits of each shift distance -7, -5, ..., 7 gathered apart
    uint32_t acc[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 27; ++k) {
        if (k == 13) continue;
        const int j = 3 * r + k % 9;
        const int d = (move_shift(k) + 7) / 2;
        const uint32_t w = k < 9 ? wa[j] : (k < 18 ? wb[j] : wc[j]);
        const uint32_t m = 1u << graph_bit(26 - k);
        if (LABELS) {
            const int32_t l = k < 9 ? la[j] : (k < 18 ? lb[j] : lc[j]);
            if (l == lv) acc[d] |= w & m;
        } else {
            acc[d] |= w & m;
        }
    }
    uint32_t g = 0u;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
        const int s = 2 * d - 7;
        g |= s > 0 ? acc[d] << s : acc[d] >> -s;
    }
    if (LABELS) g = lv != 0 ? (g | (1u << kOcc)) : 0u;
    return g;
}

// CTAs an SM holds at once
constexpr int kMinCtas = 2;

template <int TZ, bool LABELS>
__global__ void __launch_bounds__(kThreads, kMinCtas)
graph_into_tiles(const uint32_t* __restrict__ vg,
                 const int32_t* __restrict__ lab, uint32_t* __restrict__ gate,
                 int64_t lanes, int X, int Y, int Z) {
    constexpr int R = rows<LABELS>();
    constexpr int C = col<LABELS>();
    constexpr int TY = R * kThreads / TZ;
    constexpr int PW = TZ + 2;
    constexpr int CELLS = (TY + 2) * PW;
    constexpr int LOADS = (CELLS + kThreads - 1) / kThreads;
    constexpr int A = LABELS ? 2 : 1;
    // plane x + 1 is read while x + 2 and x + 3 are in flight
    constexpr int SLOTS = 3;
    __shared__ uint32_t ring[SLOTS][A][CELLS];

    const int tid = threadIdx.x;
    const int ty = tid / TZ * R, tz = tid % TZ;
    const int tiles_z = (Z + TZ - 1) / TZ;
    const int64_t per_lane = (int64_t)((Y + TY - 1) / TY) * tiles_z;
    const int64_t YZ = (int64_t)Y * Z;
    const int64_t XYZ = YZ * X;

    for (int64_t t = blockIdx.x; t < lanes * per_lane; t += gridDim.x) {
        const int64_t lane = t / per_lane;
        const int r = (int)(t - lane * per_lane);
        const int y0 = r / tiles_z * TY, z0 = r % tiles_z * TZ;
        const int64_t base = lane * XYZ;
        // this thread's cells of the bordered tile: the element of the next
        // plane to copy (the lane's first for a cell outside the lane,
        // which is filled with zero words), its bytes (4 or 0) and its step
        // from plane to plane
        int64_t e[LOADS], inc[LOADS];
        unsigned nb[LOADS];
#pragma unroll
        for (int q = 0; q < LOADS; ++q) {
            const int c = tid + q * kThreads;
            const int cy = y0 - 1 + c / PW, cz = z0 - 1 + c % PW;
            const bool in = cy >= 0 && cy < Y && cz >= 0 && cz < Z;
            e[q] = base + (in ? (int64_t)cy * Z + cz : 0);
            inc[q] = in ? YZ : 0;
            nb[q] = in ? 4u : 0u;
        }
        // plane x of the tile into its slot, one commit group a plane: the
        // plane past the lane's last one is all zero words, beyond it the
        // groups are empty; x runs 0, 1, 2, ... in order
        auto issue = [&](int x) {
            if (x <= X) {
                const int slot = x % SLOTS;
                const bool last = x == X;
#pragma unroll
                for (int q = 0; q < LOADS; ++q) {
                    const int c = tid + q * kThreads;
                    if (c >= CELLS) break;
                    const int64_t at = last ? base : e[q];
                    const unsigned n = last ? 0u : nb[q];
                    cp_async4(&ring[slot][0][c], vg + at, n);
                    if (LABELS) cp_async4(&ring[slot][A - 1][c], lab + at, n);
                    e[q] += inc[q];
                }
            }
            cp_async_commit();
        };
        // this thread's (R + 2) x 3 cells of plane x
        auto read = [&](int x, uint32_t (&w)[C], int32_t (&l)[C]) {
            const int slot = x % SLOTS;
#pragma unroll
            for (int j = 0; j < C; ++j) {
                const int c = (ty + j / 3) * PW + tz + j % 3;
                w[j] = ring[slot][0][c];
                l[j] = LABELS ? (int32_t)ring[slot][A - 1][c] : 0;
            }
        };
        const int y = y0 + ty, z = z0 + tz;
        uint32_t* out = gate + base + (int64_t)y * Z + z;
        // gates of plane x from the planes x - 1 (a), x (b), x + 1 (read
        // into c): the three register sets take turns, so no word moves
        auto step = [&](int x, const uint32_t (&wa)[C], const int32_t (&la)[C],
                        const uint32_t (&wb)[C], const int32_t (&lb)[C],
                        uint32_t (&wc)[C], int32_t (&lc)[C]) {
            // plane x + 1 has landed (x + 2 may still be in flight), and
            // every thread is past reading plane x - 1, whose slot takes
            // plane x + 3
            asm volatile("cp.async.wait_group 1;" ::: "memory");
            __syncthreads();
            read(x + 1, wc, lc);
            issue(x + 3);
#pragma unroll
            for (int rr = 0; rr < R; ++rr) {
                const uint32_t g =
                    gate_word<LABELS>(rr, wa, la, wb, lb, wc, lc);
                if (z < Z && y + rr < Y) out[(int64_t)rr * Z] = g;
            }
            out += YZ;
        };

        uint32_t w0[C], w1[C], w2[C];
        int32_t l0[C], l1[C], l2[C];
#pragma unroll
        for (int j = 0; j < C; ++j) {
            w0[j] = 0u;
            l0[j] = 0;
        }
        issue(0);
        issue(1);
        issue(2);
        asm volatile("cp.async.wait_group 2;" ::: "memory");
        __syncthreads();
        read(0, w1, l1);
        for (int x = 0; x < X; x += 3) {
            step(x, w0, l0, w1, l1, w2, l2);
            if (x + 1 < X) step(x + 1, w1, l1, w2, l2, w0, l0);
            if (x + 2 < X) step(x + 2, w2, l2, w0, l0, w1, l1);
        }
        cp_async_wait_all();
        __syncthreads();  // the slots are free for the next tile
    }
}

template <int TZ, bool LABELS>
int launch(const void* vg, const void* lab, void* gate, long long lanes,
           int X, int Y, int Z, cudaStream_t st) {
    constexpr int TY = rows<LABELS>() * kThreads / TZ;
    const int64_t tiles = (int64_t)lanes * ((Y + TY - 1) / TY) *
                          ((Z + TZ - 1) / TZ);
    const unsigned grid =
        (unsigned)(tiles < ((int64_t)1 << 20) ? tiles : ((int64_t)1 << 20));
    graph_into_tiles<TZ, LABELS><<<grid, kThreads, 0, st>>>(
        (const uint32_t*)vg, (const int32_t*)lab, (uint32_t*)gate, lanes, X,
        Y, Z);
    return (int)cudaGetLastError();
}

// the tile's width: a warp along z where the lanes are that wide
template <bool LABELS>
int dispatch(const void* vg, const void* lab, void* gate, long long lanes,
             int X, int Y, int Z, cudaStream_t st) {
    if (Z > 16) return launch<32, LABELS>(vg, lab, gate, lanes, X, Y, Z, st);
    if (Z > 8) return launch<16, LABELS>(vg, lab, gate, lanes, X, Y, Z, st);
    return launch<8, LABELS>(vg, lab, gate, lanes, X, Y, Z, st);
}

}  // namespace

extern "C" {

// vg, gate: uint32 (lanes, X, Y, Z) contiguous; labels: int32 of that
// shape for the CCL form, or NULL; bits: 54 ints, the bit of each offset of
// the 3 x 3 x 3 neighbourhood in (dx, dy, dz) order, then the bit of each
// reverse (the centre's ignored), which must be the table this file was
// built with (cc3d's convention). Returns a cudaError_t code (0 = success).
int kt_graph_into(const void* vg, const void* labels, void* gate,
                  long long lanes, int X, int Y, int Z, const int* bits,
                  void* stream) {
    if (lanes < 0 || X < 0 || Y < 0 || Z < 0) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < 27; ++k) {
        if (k != 13 && (bits[k] != graph_bit(k) ||
                        bits[27 + k] != graph_bit(26 - k))) {
            return (int)cudaErrorInvalidValue;
        }
    }
    if (lanes == 0 || X == 0 || Y == 0 || Z == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    return labels != nullptr
               ? dispatch<true>(vg, labels, gate, lanes, X, Y, Z, st)
               : dispatch<false>(vg, nullptr, gate, lanes, X, Y, Z, st);
}

}  // extern "C"
