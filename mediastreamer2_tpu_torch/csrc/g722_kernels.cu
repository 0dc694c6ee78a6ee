// Hand-written Hopper (sm_90a) kernels of the G.722 codec (ITU-T G.722,
// 64 kbit/s SB-ADPCM): encode and decode of one 10 ms tick for every leg.
//
// They replace the lax.scan loops of g722_encode and g722_decode
// (mediastreamer2_tpu/ops/g722.py:213 and :221), which XLA compiles into one
// loop on the device. In eager PyTorch each of the 80 code slots of a tick
// would be ~150 integer operations launched one by one; here one launch
// runs the whole tick.
//
// Built by ops/kernels.py with the flags of ms2_kernels.cu into a shared
// library with a plain C interface, loaded with ctypes. Each entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError().
//
// Design: one thread per leg. The leg's codec state (two ADPCM bands of 28
// int32 each and the 24-sample QMF delay line: 320 bytes) is loaded into
// registers, the 80 slots run in a loop, and the state is stored back; the
// slot loop is unrolled inside (the predictor's arrays stay in registers).
// What bounds it is the serial chain: every slot's predictor depends on the
// previous slot's, so a leg's 80 slots run one after another at the latency
// of their dependent integer operations, not at the card's throughput (the
// bytes, ~2 KB a leg, take well under a microsecond at 3.35 TB/s). The data-
// dependent table lookups (quantizer levels, inverse quantizers, the log
// scale factor table) read shared memory: the legs of a warp index them at
// different entries, which the constant cache would serialise. The QMF and
// threshold coefficients, indexed by unrolled loop counters (one entry for
// the whole warp), stay in the constant bank. The next slot's input is
// loaded one slot ahead, so the global load's latency stays off the chain.
//
// Arithmetic is the JAX package's, bit for bit: int32 with wrap-around, an
// arithmetic >>, the decoder's output wrapped (not saturated) to int16, and
// the log-scale shift branching on its sign instead of shifting by a
// negative count.

#include <cuda_runtime.h>
#include <stdint.h>

#define G722_THREADS 128

namespace {

// ITU G.722 tables (the same values as mediastreamer2_tpu/ops/g722.py)
__device__ const int kILN[32] = {
    0, 63, 62, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
    16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 0};
__device__ const int kILP[32] = {
    0, 61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 51, 50, 49, 48, 47, 46, 45,
    44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33, 32, 0};
__device__ const int kWL[8] = {-60, -30, 58, 172, 334, 538, 1198, 3042};
__device__ const int kRL42[16] = {0, 7, 6, 5, 4, 3, 2, 1, 7, 6, 5, 4, 3, 2, 1, 0};
__device__ const int kILB[32] = {
    2048, 2093, 2139, 2186, 2233, 2282, 2332, 2383, 2435, 2489, 2543, 2599,
    2656, 2714, 2774, 2834, 2896, 2960, 3025, 3091, 3158, 3228, 3298, 3371,
    3444, 3520, 3597, 3676, 3756, 3838, 3922, 4008};
__device__ const int kWH[4] = {0, -214, 798, 0};
__device__ const int kRH2[4] = {2, 1, 2, 1};
__device__ const int kQM2[4] = {-7408, -1616, 7408, 1616};
__device__ const int kQM4[16] = {
    0, -20456, -12896, -8968, -6288, -4240, -2584, -1200,
    20456, 12896, 8968, 6288, 4240, 2584, 1200, 0};
__device__ const int kQM6[64] = {
    -136, -136, -136, -136, -24808, -21904, -19008, -16704, -14984, -13512,
    -12280, -11192, -10232, -9360, -8576, -7856, -7192, -6576, -6000, -5456,
    -4944, -4464, -4008, -3576, -3168, -2776, -2400, -2032, -1688, -1360,
    -1040, -728, 24808, 21904, 19008, 16704, 14984, 13512, 12280, 11192,
    10232, 9360, 8576, 7856, 7192, 6576, 6000, 5456, 4944, 4464, 4008, 3576,
    3168, 2776, 2400, 2032, 1688, 1360, 1040, 728, 432, 136, -432, -136};
// indexed by unrolled loop counters only, the same entry for every thread:
// the constant bank, read as instruction operands
__constant__ int kQ6[30] = {
    0, 35, 72, 110, 150, 190, 233, 276, 323, 370, 422, 473, 530, 587, 650,
    714, 786, 858, 940, 1023, 1121, 1219, 1339, 1458, 1612, 1765, 1980,
    2195, 2557, 2919};
__constant__ int kQMF[12] = {3, -11, 12, 32, -210, 951, 3876, -805, 362, -156, 53, -11};

// Shared-memory copies of the data-dependent tables, one per block.
struct SharedTables {
    int iln[32], ilp[32], wl[8], rl42[16], ilb[32], wh[4], rh2[4], qm2[4],
        qm4[16], qm6[64];
};

__device__ __forceinline__ void load_tables(SharedTables* t)
{
    for (int i = threadIdx.x; i < 32; i += blockDim.x) {
        t->iln[i] = kILN[i];
        t->ilp[i] = kILP[i];
        t->ilb[i] = kILB[i];
    }
    for (int i = threadIdx.x; i < 64; i += blockDim.x) t->qm6[i] = kQM6[i];
    for (int i = threadIdx.x; i < 16; i += blockDim.x) {
        t->rl42[i] = kRL42[i];
        t->qm4[i] = kQM4[i];
    }
    for (int i = threadIdx.x; i < 8; i += blockDim.x) t->wl[i] = kWL[i];
    for (int i = threadIdx.x; i < 4; i += blockDim.x) {
        t->wh[i] = kWH[i];
        t->rh2[i] = kRH2[i];
        t->qm2[i] = kQM2[i];
    }
    __syncthreads();
}

__device__ __forceinline__ int sat16(int x) { return min(max(x, -32768), 32767); }

// One ADPCM band's predictor state, in registers.
struct Band {
    int s, sp, sz, r[3], a[3], p[3], d[7], b[7], nb, det;
};

// Pointers to one band's state leaves in device memory ([B] or [B, k]).
struct BandPtrs {
    int *s, *sp, *sz, *r, *a, *p, *d, *b, *nb, *det;
};

__device__ __forceinline__ void band_load(Band& z, const BandPtrs& q, int leg)
{
    z.s = q.s[leg];
    z.sp = q.sp[leg];
    z.sz = q.sz[leg];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        z.r[k] = q.r[3 * leg + k];
        z.a[k] = q.a[3 * leg + k];
        z.p[k] = q.p[3 * leg + k];
    }
#pragma unroll
    for (int k = 0; k < 7; ++k) {
        z.d[k] = q.d[7 * leg + k];
        z.b[k] = q.b[7 * leg + k];
    }
    z.nb = q.nb[leg];
    z.det = q.det[leg];
}

__device__ __forceinline__ void band_store(const Band& z, const BandPtrs& q, int leg)
{
    q.s[leg] = z.s;
    q.sp[leg] = z.sp;
    q.sz[leg] = z.sz;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        q.r[3 * leg + k] = z.r[k];
        q.a[3 * leg + k] = z.a[k];
        q.p[3 * leg + k] = z.p[k];
    }
#pragma unroll
    for (int k = 0; k < 7; ++k) {
        q.d[7 * leg + k] = z.d[k];
        q.b[7 * leg + k] = z.b[k];
    }
    q.nb[leg] = z.nb;
    q.det[leg] = z.det;
}

// LOGSCL/LOGSCH + SCALEL/SCALEH (g722.py _scalel): the band's log scale
// factor nb and its linear step det.
__device__ __forceinline__ void scalel(Band& z, int wl_entry, int nb_max, int shift_base,
                                       const int* ilb)
{
    int nb = ((z.nb * 127) >> 7) + wl_entry;
    nb = min(max(nb, 0), nb_max);
    const int wd1 = (nb >> 6) & 31;
    const int wd2 = shift_base - (nb >> 11);
    const int v = ilb[wd1];
    const int wd3 = wd2 < 0 ? (v << (-wd2)) : (v >> wd2);
    z.nb = nb;
    z.det = wd3 << 2;
}

// ITU G.722 block 4 (g722.py _block4): pole/zero predictor adaptation with
// the quantized difference d, then the next prediction s.
__device__ __forceinline__ void block4(Band& z, int d)
{
    const int r0 = sat16(z.s + d);                         // RECONS
    const int p0 = sat16(z.sz + d);                        // PARREC
    const int sg0 = p0 >> 15, sg1 = z.p[1] >> 15, sg2 = z.p[2] >> 15;
    // UPPOL2
    int wd1 = sat16(z.a[1] * 4);
    int wd2 = (sg0 == sg1) ? -wd1 : wd1;
    wd2 = min(wd2, 32767);
    int wd3 = (sg0 == sg2) ? 128 : -128;
    wd3 = wd3 + (wd2 >> 7) + ((z.a[2] * 32512) >> 15);
    const int ap2 = min(max(wd3, -12288), 12288);
    // UPPOL1
    wd1 = (sg0 == sg1) ? 192 : -192;
    wd2 = (z.a[1] * 32640) >> 15;
    int ap1 = sat16(wd1 + wd2);
    wd3 = sat16(15360 - ap2);
    ap1 = min(max(ap1, -wd3), wd3);
    // UPZERO, then DELAYA
    const int step = d == 0 ? 0 : 128;
    const int sgd = d >> 15;
    int bp[7];
#pragma unroll
    for (int i = 1; i < 7; ++i) {
        const int w2 = ((z.d[i] >> 15) == sgd) ? step : -step;
        bp[i] = sat16(w2 + ((z.b[i] * 32640) >> 15));
    }
#pragma unroll
    for (int i = 6; i >= 1; --i) z.d[i] = z.d[i - 1];
    z.d[1] = d;
    z.d[0] = d;
#pragma unroll
    for (int i = 1; i < 7; ++i) z.b[i] = bp[i];
    z.r[2] = z.r[1];
    z.r[1] = r0;
    z.r[0] = r0;
    z.p[2] = z.p[1];
    z.p[1] = p0;
    z.p[0] = p0;
    z.a[1] = ap1;
    z.a[2] = ap2;
    // FILTEP
    const int f1 = (z.a[1] * sat16(z.r[1] + z.r[1])) >> 15;
    const int f2 = (z.a[2] * sat16(z.r[2] + z.r[2])) >> 15;
    z.sp = sat16(f1 + f2);
    // FILTEZ
    int acc = 0;
#pragma unroll
    for (int i = 1; i < 7; ++i) acc += (z.b[i] * sat16(z.d[i] + z.d[i])) >> 15;
    z.sz = sat16(acc);
    z.s = sat16(z.sp + z.sz);
}

__global__ void __launch_bounds__(G722_THREADS)
g722_encode_kernel(const int* __restrict__ pcm, int* __restrict__ codes,
                   BandPtrs lo_p, BandPtrs hi_p, int* __restrict__ x_p, int B, int C)
{
    __shared__ SharedTables t;
    load_tables(&t);
    const int leg = blockIdx.x * blockDim.x + threadIdx.x;
    if (leg >= B) return;
    Band lo, hi;
    band_load(lo, lo_p, leg);
    band_load(hi, hi_p, leg);
    int x[24];
#pragma unroll
    for (int k = 0; k < 24; ++k) x[k] = x_p[24 * leg + k];
    const int2* in = reinterpret_cast<const int2*>(pcm + (size_t)leg * 2 * C);
    int* out = codes + (size_t)leg * C;
    int2 next = C > 0 ? in[0] : make_int2(0, 0);
    for (int j = 0; j < C; ++j) {
        const int2 xt = next;
        if (j + 1 < C) next = in[j + 1];               // one slot ahead
        // QMF transmit: shift in the two new samples, split the bands
#pragma unroll
        for (int k = 0; k < 22; ++k) x[k] = x[k + 2];
        x[22] = xt.x;
        x[23] = xt.y;
        int sumodd = 0, sumeven = 0;
#pragma unroll
        for (int k = 0; k < 12; ++k) {
            sumodd += x[2 * k] * kQMF[k];
            sumeven += x[2 * k + 1] * kQMF[11 - k];
        }
        const int xlow = (sumeven + sumodd) >> 13;
        const int xhigh = (sumeven - sumodd) >> 13;

        // lower band (6-bit)
        const int el = sat16(xlow - lo.s);
        int wd = el >= 0 ? el : -(el + 1);
        int i = 1;
#pragma unroll
        for (int k = 1; k < 30; ++k) i += wd >= ((kQ6[k] * lo.det) >> 12);
        const int ilow = el < 0 ? t.iln[i] : t.ilp[i];
        const int ril = ilow >> 2;
        const int dlow = (lo.det * t.qm4[ril]) >> 15;
        scalel(lo, t.wl[t.rl42[ril]], 18432, 8, t.ilb);
        block4(lo, dlow);

        // higher band (2-bit)
        const int eh = sat16(xhigh - hi.s);
        wd = eh >= 0 ? eh : -(eh + 1);
        const int mih = wd >= ((564 * hi.det) >> 12) ? 2 : 1;
        const int ihigh = eh < 0 ? (mih == 1 ? 1 : 0) : (mih == 1 ? 3 : 2);   // IHN / IHP
        const int dhigh = (hi.det * t.qm2[ihigh]) >> 15;
        scalel(hi, t.wh[t.rh2[ihigh]], 22528, 10, t.ilb);
        block4(hi, dhigh);

        out[j] = (ihigh << 6) | ilow;
    }
    band_store(lo, lo_p, leg);
    band_store(hi, hi_p, leg);
#pragma unroll
    for (int k = 0; k < 24; ++k) x_p[24 * leg + k] = x[k];
}

__global__ void __launch_bounds__(G722_THREADS)
g722_decode_kernel(const int* __restrict__ codes, int* __restrict__ pcm,
                   BandPtrs lo_p, BandPtrs hi_p, int* __restrict__ x_p, int B, int C)
{
    __shared__ SharedTables t;
    load_tables(&t);
    const int leg = blockIdx.x * blockDim.x + threadIdx.x;
    if (leg >= B) return;
    Band lo, hi;
    band_load(lo, lo_p, leg);
    band_load(hi, hi_p, leg);
    int x[24];
#pragma unroll
    for (int k = 0; k < 24; ++k) x[k] = x_p[24 * leg + k];
    const int* in = codes + (size_t)leg * C;
    int2* out = reinterpret_cast<int2*>(pcm + (size_t)leg * 2 * C);
    int next = C > 0 ? in[0] : 0;
    for (int j = 0; j < C; ++j) {
        const int code = next;
        if (j + 1 < C) next = in[j + 1];               // one slot ahead
        const int ilow = code & 0x3F;
        const int ihigh = (code >> 6) & 3;
        // lower band: 6-bit inverse quantizer for the signal, 4-bit for
        // the adaptation
        const int rlow = min(max(lo.s + ((lo.det * t.qm6[ilow]) >> 15), -16384), 16383);
        const int dlowt = (lo.det * t.qm4[ilow >> 2]) >> 15;
        scalel(lo, t.wl[t.rl42[ilow >> 2]], 18432, 8, t.ilb);
        block4(lo, dlowt);
        // higher band
        const int dhigh = (hi.det * t.qm2[ihigh]) >> 15;
        const int rhigh = min(max(dhigh + hi.s, -16384), 16383);
        scalel(hi, t.wh[t.rh2[ihigh]], 22528, 10, t.ilb);
        block4(hi, dhigh);
        // QMF receive: recombine into two 16 kHz samples
#pragma unroll
        for (int k = 0; k < 22; ++k) x[k] = x[k + 2];
        x[22] = rlow + rhigh;
        x[23] = rlow - rhigh;
        int xout1 = 0, xout2 = 0;
#pragma unroll
        for (int k = 0; k < 12; ++k) {
            xout2 += x[2 * k] * kQMF[k];
            xout1 += x[2 * k + 1] * kQMF[11 - k];
        }
        // (int16_t)(xout >> 12): wrap, not saturate
        out[j] = make_int2((((xout1 >> 12) + 32768) & 0xFFFF) - 32768,
                           (((xout2 >> 12) + 32768) & 0xFFFF) - 32768);
    }
    band_store(lo, lo_p, leg);
    band_store(hi, hi_p, leg);
#pragma unroll
    for (int k = 0; k < 24; ++k) x_p[24 * leg + k] = x[k];
}

// state: 21 device pointers, the leaves of g722_state in this order:
// lo.{s, sp, sz, r, a, p, d, b, nb, det}, hi.{the same}, x.
__host__ void unpack_state(void* const* state, BandPtrs* lo, BandPtrs* hi, int** x)
{
    BandPtrs* bands[2] = {lo, hi};
    for (int k = 0; k < 2; ++k) {
        void* const* s = state + 10 * k;
        *bands[k] = BandPtrs{(int*)s[0], (int*)s[1], (int*)s[2], (int*)s[3], (int*)s[4],
                             (int*)s[5], (int*)s[6], (int*)s[7], (int*)s[8], (int*)s[9]};
    }
    *x = (int*)state[20];
}

}  // namespace

extern "C" {

// pcm int32 [B, 2C] (16 kHz) -> codes int32 [B, C]; state updated in place.
int ms2_g722_encode(int device, const void* pcm, void* codes, void* const* state,
                    int B, int C, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return (int)cudaGetLastError();
    BandPtrs lo, hi;
    int* x;
    unpack_state(state, &lo, &hi, &x);
    g722_encode_kernel<<<(B + G722_THREADS - 1) / G722_THREADS, G722_THREADS, 0,
                         (cudaStream_t)stream>>>((const int*)pcm, (int*)codes, lo, hi, x, B, C);
    return (int)cudaGetLastError();
}

// codes int32 [B, C] -> pcm int32 [B, 2C] (16 kHz); state updated in place.
int ms2_g722_decode(int device, const void* codes, void* pcm, void* const* state,
                    int B, int C, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return (int)cudaGetLastError();
    BandPtrs lo, hi;
    int* x;
    unpack_state(state, &lo, &hi, &x);
    g722_decode_kernel<<<(B + G722_THREADS - 1) / G722_THREADS, G722_THREADS, 0,
                         (cudaStream_t)stream>>>((const int*)codes, (int*)pcm, lo, hi, x, B, C);
    return (int)cudaGetLastError();
}

}  // extern "C"
