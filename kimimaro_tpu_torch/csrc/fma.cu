// F1: the fused multiply-add of float32 operands, out = fma(+-a, b, c), one
// rounding, elementwise with broadcasting.
//
// Replaces no Pallas kernel: XLA:CPU contracts the JAX package's
// elementwise `a*b + c` into fused multiply-adds (the PDRF, the
// invalidation radii, the cross sections' planes and areas), and the
// port computes those lines with ops.fma.fma_f32. Its plain version (CPU
// tensors) takes the float64 sum made round-to-odd, a dozen float64
// passes; on the card this kernel is one pass of __fmaf_rn, which is
// exact by construction (the library is built with --fmad=false, which
// does not touch the explicit intrinsic). `negate` makes it c - a*b: the
// sign flip of a is exact, so this is the correctly rounded c - a*b, and
// the callers need no negated copy of a whole field.
//
// What bounds it on this card: the bytes, each operand read once and the
// output written once. Its first form did three 64-bit `%` and `/` by
// runtime sizes per element, 4-byte loads and stores, over a grid capped
// at 132 x 32 blocks: at 512^3 the integer divisions, not the memory,
// set its time. Two routes now, chosen by the wrapper (ops.fma.fma_plan):
//
// - flat: every tensor operand walks the output's layout with stride 1,
//   or is one element (stride 0), or the operand is a constant. A thread
//   takes four consecutive elements: one 16-byte load of each aligned
//   operand, four 4-byte loads of an operand whose base is not 16-byte
//   aligned (a view at an offset), one 16-byte store (the output is
//   fresh, so aligned), and a scalar tail for n % 4. No index arithmetic
//   beyond the thread's offset.
// - strided: any broadcast, as up to four collapsed dimensions with
//   32-bit element strides. A thread takes four consecutive output
//   elements: it splits the first index into its coordinates with
//   precomputed 32-bit magic divisors (a multiply-high, an add and a
//   shift each; no division), steps the other three by carrying, and
//   stores the four with one 16-byte store. The wrapper sends here only outputs
//   under 2^31 elements whose operand offsets fit in 32 bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// how a flat-route operand is read
enum FlatMode : int {
    kConst = 0,     // the constant `value`
    kScalar = 1,    // one element, p[0]
    kVector = 2,    // stride 1, 16-byte aligned base
    kUnaligned = 3  // stride 1, any 4-byte aligned base
};

struct Flat {
    const float* p;
    float value;
    int mode;
};

__device__ __forceinline__ float4 load4(const Flat& o, long long i) {
    switch (o.mode) {
        case kVector:
            return __ldg(reinterpret_cast<const float4*>(o.p + i));
        case kUnaligned:
            return make_float4(__ldg(o.p + i), __ldg(o.p + i + 1),
                               __ldg(o.p + i + 2), __ldg(o.p + i + 3));
        case kScalar: {
            const float v = __ldg(o.p);
            return make_float4(v, v, v, v);
        }
        default:
            return make_float4(o.value, o.value, o.value, o.value);
    }
}

__device__ __forceinline__ float load1(const Flat& o, long long i) {
    if (o.mode == kConst) return o.value;
    return __ldg(o.p + (o.mode == kScalar ? 0 : i));
}

__device__ __forceinline__ float fma1(float a, float b, float c, bool neg) {
    return __fmaf_rn(neg ? -a : a, b, c);
}

__global__ void __launch_bounds__(kThreads)
fma_flat_kernel(Flat a, Flat b, Flat c, float* __restrict__ out,
                long long n, int negate) {
    const long long i =
        4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
    const bool neg = negate != 0;
    if (i + 4 <= n) {
        const float4 x = load4(a, i), y = load4(b, i), z = load4(c, i);
        float4 r;
        r.x = fma1(x.x, y.x, z.x, neg);
        r.y = fma1(x.y, y.y, z.y, neg);
        r.z = fma1(x.z, y.z, z.z, neg);
        r.w = fma1(x.w, y.w, z.w, neg);
        *reinterpret_cast<float4*>(out + i) = r;
    } else {
        for (long long k = i; k < n; ++k) {
            out[k] = fma1(load1(a, k), load1(b, k), load1(c, k), neg);
        }
    }
}

// q = n / d for n < 2^31: (umulhi(n, magic) + n) >> shift
struct Div {
    unsigned d, magic, shift;
};

__device__ __forceinline__ unsigned divide(const Div& v, unsigned n) {
    return (__umulhi(n, v.magic) + n) >> v.shift;
}

struct Strided {
    const float* p;  // null: the constant `value`
    float value;
    int s[4];  // element strides of the 4-D view
};

__device__ __forceinline__ float load_at(const Strided& o, unsigned i0,
                                         unsigned i1, unsigned i2,
                                         unsigned i3) {
    if (o.p == nullptr) return o.value;
    return __ldg(o.p + (int)(i0 * o.s[0] + i1 * o.s[1] + i2 * o.s[2] +
                             i3 * o.s[3]));
}

__global__ void __launch_bounds__(kThreads)
fma_strided_kernel(Strided a, Strided b, Strided c, float* __restrict__ out,
                   unsigned total, Div d1, Div d2, Div d3, int negate) {
    const unsigned i = 4u * (blockIdx.x * kThreads + threadIdx.x);
    if (i >= total) return;
    const bool neg = negate != 0;
    unsigned q = divide(d3, i);
    unsigned i3 = i - q * d3.d;
    unsigned r = divide(d2, q);
    unsigned i2 = q - r * d2.d;
    unsigned i0 = divide(d1, r);
    unsigned i1 = r - i0 * d1.d;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        v[k] = i + k < total
                   ? fma1(load_at(a, i0, i1, i2, i3),
                          load_at(b, i0, i1, i2, i3),
                          load_at(c, i0, i1, i2, i3), neg)
                   : 0.0f;
        if (++i3 == d3.d) {
            i3 = 0;
            if (++i2 == d2.d) {
                i2 = 0;
                if (++i1 == d1.d) {
                    i1 = 0;
                    ++i0;
                }
            }
        }
    }
    if (i + 4 <= total) {
        *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
    } else {
        for (unsigned k = 0; i + k < total; ++k) out[i + k] = v[k];
    }
}

Strided strided(const void* p, float value, const int* strides) {
    Strided o;
    o.p = (const float*)p;
    o.value = value;
    for (int k = 0; k < 4; ++k) o.s[k] = p == nullptr ? 0 : strides[k];
    return o;
}

}  // namespace

extern "C" {

// The flat route. out: n float32, contiguous, 16-byte aligned. Each
// operand is a pointer, a constant and its FlatMode. Returns a
// cudaError_t code (0 = success).
int kt_fma_f32_flat(const void* a, float va, int ma, const void* b, float vb,
                    int mb, const void* c, float vc, int mc, int negate,
                    void* out, long long n, void* stream) {
    if (n < 0 || ((uintptr_t)out & 15) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const int modes[3] = {ma, mb, mc};
    const void* ptrs[3] = {a, b, c};
    for (int k = 0; k < 3; ++k) {
        if (modes[k] < kConst || modes[k] > kUnaligned) {
            return (int)cudaErrorInvalidValue;
        }
        if (modes[k] != kConst && ptrs[k] == nullptr) {
            return (int)cudaErrorInvalidValue;
        }
        if (modes[k] == kVector && ((uintptr_t)ptrs[k] & 15) != 0) {
            return (int)cudaErrorInvalidValue;
        }
    }
    if (n == 0) return 0;
    if ((n + 3) / 4 / kThreads >= 0x7fffffffLL) {
        return (int)cudaErrorInvalidValue;
    }
    const long long blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
    fma_flat_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        Flat{(const float*)a, va, ma}, Flat{(const float*)b, vb, mb},
        Flat{(const float*)c, vc, mc}, (float*)out, n, negate);
    return (int)cudaGetLastError();
}

// The strided route. out: `total` (< 2^31) float32, contiguous, 16-byte
// aligned, of the 4-D shape (n0, n1, n2, n3). Each operand is a pointer
// to float32 with its four 32-bit element strides, or a null pointer and
// a constant. divs: (d, magic, shift) for n1, n2 and n3. Returns a
// cudaError_t code (0 = success).
int kt_fma_f32_strided(const void* a, float va, const int* sa, const void* b,
                       float vb, const int* sb, const void* c, float vc,
                       const int* sc, int negate, void* out, long long total,
                       const unsigned* divs, void* stream) {
    if (total < 0 || total >= (1LL << 31) || ((uintptr_t)out & 15) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    for (int k = 0; k < 3; ++k) {
        if (divs[3 * k] < 1) return (int)cudaErrorInvalidValue;
    }
    if (total == 0) return 0;
    const Div d1{divs[0], divs[1], divs[2]}, d2{divs[3], divs[4], divs[5]},
        d3{divs[6], divs[7], divs[8]};
    const long long blocks = ((total + 3) / 4 + kThreads - 1) / kThreads;
    fma_strided_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
        strided(a, va, sa), strided(b, vb, sb), strided(c, vc, sc),
        (float*)out, (unsigned)total, d1, d2, d3, negate);
    return (int)cudaGetLastError();
}

}  // extern "C"
