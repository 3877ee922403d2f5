// F1: the fused multiply-add of float32 operands, out = fma(a, b, c), one
// rounding, elementwise with broadcasting.
//
// Replaces no Pallas kernel: XLA:CPU contracts the JAX package's
// elementwise `a*b + c` into fused multiply-adds (the PDRF, the
// invalidation radii, the cross sections' planes and areas), and the
// port computes those lines with ops.fma.fma_f32. Its
// plain version (CPU tensors) takes the float64 sum made round-to-odd, a
// dozen float64 passes; on the card this kernel is one pass of
// __fmaf_rn, which is exact by construction (the library is built with
// --fmad=false, which does not touch the explicit intrinsic).
//
// What bounds it: the bytes, each operand read once and the output
// written once (a broadcast operand is read from L2). Every operand is a
// 4-D view of the output's shape with element strides (0 along a
// broadcast dimension), or a constant.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Operand {
    const float* p;  // null: the constant `value`
    float value;
    long long s[4];  // element strides of the 4-D view
};

__device__ __forceinline__ float load(const Operand& o, long long i0,
                                      long long i1, long long i2,
                                      long long i3) {
    if (o.p == nullptr) return o.value;
    return o.p[i0 * o.s[0] + i1 * o.s[1] + i2 * o.s[2] + i3 * o.s[3]];
}

__global__ void fma_kernel(Operand a, Operand b, Operand c,
                           float* __restrict__ out, long long n1,
                           long long n2, long long n3, long long total) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += step) {
        const long long i3 = i % n3;
        long long r = i / n3;
        const long long i2 = r % n2;
        r /= n2;
        const long long i1 = r % n1;
        const long long i0 = r / n1;
        out[i] = __fmaf_rn(load(a, i0, i1, i2, i3), load(b, i0, i1, i2, i3),
                           load(c, i0, i1, i2, i3));
    }
}

Operand operand(const void* p, float value, const long long* strides) {
    Operand o;
    o.p = (const float*)p;
    o.value = value;
    for (int k = 0; k < 4; ++k) o.s[k] = p == nullptr ? 0 : strides[k];
    return o;
}

}  // namespace

extern "C" {

// out: (n0, n1, n2, n3) float32 contiguous. Each operand is a pointer to
// float32 with its four element strides, or a null pointer and a
// constant. Returns a cudaError_t code (0 = success).
int kt_fma_f32(const void* a, float va, const long long* sa, const void* b,
               float vb, const long long* sb, const void* c, float vc,
               const long long* sc, void* out, long long n0, long long n1,
               long long n2, long long n3, void* stream) {
    if (n0 < 0 || n1 < 1 || n2 < 1 || n3 < 1) return (int)cudaErrorInvalidValue;
    const long long total = n0 * n1 * n2 * n3;
    if (total == 0) return 0;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    fma_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        operand(a, va, sa), operand(b, vb, sb), operand(c, vc, sc),
        (float*)out, n1, n2, n3, total);
    return (int)cudaGetLastError();
}

}  // extern "C"
