// Hand-written Hopper (sm_90a) kernels of the two sample-serial ADPCM codecs:
// DVI4 (IMA ADPCM, RFC 3551) and G.726 at 16, 24, 32 and 40 kbit/s, encode
// and decode of one 10 ms tick for every leg.
//
// They replace the lax.scan loops of adpcm_encode / adpcm_decode
// (mediastreamer2_tpu/ops/adpcm.py:78 and :84) and of g726_encode /
// g726_decode (mediastreamer2_tpu/ops/g726.py:172 and :180), which XLA
// compiles into one loop on the device. In eager PyTorch each of a tick's 80
// samples would be ~25 (DVI4) or ~90 (G.726) small operations launched one
// by one; here one launch runs the whole tick.
//
// Built by ops/kernels.py with the flags of ms2_kernels.cu (-fmad=false, no
// fast-math flag) into a shared library with a plain C interface, loaded
// with ctypes. Each entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError().
//
// Design, as csrc/g722_kernels.cu: one thread per leg. The leg's state (2
// int32 for DVI4, 24 float32 for G.726) is loaded into registers, the tick's
// samples run in a loop (the count comes from the shape), and the state is
// stored back in place. What bounds them is the serial chain: every sample's
// predictor needs the previous sample's, so a leg's samples run one after
// another at the latency of their dependent operations (for G.726 a log2f,
// two exp2f and ~40 dependent float operations a sample); the bytes, 0.66 MB
// a call at 1,024 legs, take 0.2 microseconds at 3.35 TB/s. The tables
// indexed by data (DVI4's step and index tables; G.726's reconstruction
// levels and W / F multipliers) are copied to shared memory: the legs of a
// warp read different entries, which the constant cache would serialise.
// G.726's decision thresholds are indexed by an unrolled loop counter, the
// same entry for the whole warp, and stay in the constant bank. The next
// sample's input is loaded one sample ahead, so most of the global load's
// latency stays off the chain. A block is ADPCM_THREADS = 32 legs, one warp:
// 1,024 legs then spread over 32 of the 132 SMs (measured on an H100 at
// 1,024 legs with tools/adpcm_block_size.py: 32 threads a block were the
// fastest for all four kernels, 64 were 2-24% slower and 128 3-77% slower).
// Input and output are [B, S] row-major, so a thread walks global memory at
// a stride of S * 4 bytes; staging the block's rows through a shared-memory
// tile, filled row by row with one load in flight a thread, was measured
// three times slower for DVI4 (the fill serialises ~100 global-memory
// latencies), so the samples are read and written in place.
//
// Arithmetic. DVI4 is the JAX package's int32 arithmetic, bit for bit.
// G.726 is float32 in the JAX package's association order, every expression
// written out the same way: the six-tap sum is a left-to-right chain, no
// multiply-add is contracted (-fmad=false), log2f and exp2f are the library
// functions (not the __ intrinsics), and every division is by a power of
// two, which is exact.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ADPCM_THREADS
#define ADPCM_THREADS 32
#endif

namespace {

// ---------------------------------------------------------------------------
// DVI4 (IMA ADPCM)
// ---------------------------------------------------------------------------
__device__ const int kStep[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37, 41,
    45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173, 190,
    209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658, 724,
    796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066, 2272,
    2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132,
    7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500,
    20350, 22385, 24623, 27086, 29794, 32767};
__device__ const int kIndex[8] = {-1, -1, -1, -1, 2, 4, 6, 8};

struct Dvi4Tables {
    int step[89], index[8];
};

__device__ __forceinline__ void dvi4_load_tables(Dvi4Tables* t)
{
    for (int i = threadIdx.x; i < 89; i += blockDim.x) t->step[i] = kStep[i];
    for (int i = threadIdx.x; i < 8; i += blockDim.x) t->index[i] = kIndex[i];
    __syncthreads();
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// adpcm.py _enc_step
__global__ void __launch_bounds__(ADPCM_THREADS)
dvi4_encode_kernel(const int* __restrict__ pcm, int* __restrict__ codes,
                   int* __restrict__ pred_p, int* __restrict__ index_p, int B, int S)
{
    __shared__ Dvi4Tables t;
    dvi4_load_tables(&t);
    const int leg = blockIdx.x * blockDim.x + threadIdx.x;
    if (leg >= B) return;
    int pred = pred_p[leg], index = index_p[leg];
    const int* in = pcm + (size_t)leg * S;
    int* out = codes + (size_t)leg * S;
    int next = S > 0 ? in[0] : 0;
    for (int j = 0; j < S; ++j) {
        const int x = next;
        if (j + 1 < S) next = in[j + 1];               // one sample ahead
        const int step = t.step[index];
        int diff = x - pred;
        const int sign = diff < 0 ? 8 : 0;
        diff = abs(diff);
        int vpdiff = step >> 3;
        const int b2 = diff >= step;
        if (b2) { diff -= step; vpdiff += step; }
        const int b1 = diff >= (step >> 1);
        if (b1) { diff -= step >> 1; vpdiff += step >> 1; }
        const int b0 = diff >= (step >> 2);
        if (b0) vpdiff += step >> 2;
        const int delta = (b2 << 2) | (b1 << 1) | b0;
        pred = clampi(sign ? pred - vpdiff : pred + vpdiff, -32768, 32767);
        index = clampi(index + t.index[delta], 0, 88);
        out[j] = sign | delta;
    }
    pred_p[leg] = pred;
    index_p[leg] = index;
}

// adpcm.py _dec_step
__global__ void __launch_bounds__(ADPCM_THREADS)
dvi4_decode_kernel(const int* __restrict__ codes, int* __restrict__ pcm,
                   int* __restrict__ pred_p, int* __restrict__ index_p, int B, int S)
{
    __shared__ Dvi4Tables t;
    dvi4_load_tables(&t);
    const int leg = blockIdx.x * blockDim.x + threadIdx.x;
    if (leg >= B) return;
    int pred = pred_p[leg], index = index_p[leg];
    const int* in = codes + (size_t)leg * S;
    int* out = pcm + (size_t)leg * S;
    int next = S > 0 ? in[0] : 0;
    for (int j = 0; j < S; ++j) {
        const int code = next;
        if (j + 1 < S) next = in[j + 1];               // one sample ahead
        const int step = t.step[index];
        const int delta = code & 7;
        const int vpdiff = (step >> 3) + ((delta & 4) ? step : 0)
                           + ((delta & 2) ? step >> 1 : 0) + ((delta & 1) ? step >> 2 : 0);
        pred = clampi((code & 8) ? pred - vpdiff : pred + vpdiff, -32768, 32767);
        index = clampi(index + t.index[delta], 0, 88);
        out[j] = pred;
    }
    pred_p[leg] = pred;
    index_p[leg] = index;
}

// ---------------------------------------------------------------------------
// G.726
// ---------------------------------------------------------------------------
// Per-rate tables (the same values as mediastreamer2_tpu/ops/g726.py
// _RATE_TABLES), row = bits - 2, padded to 16 entries.
__constant__ float kQtab[4][16] = {
    {261},
    {-8, 171, 285},
    {-124, 80, 178, 246, 300, 349, 400},
    {-122, -16, 67, 138, 197, 249, 297, 338, 377, 412, 444, 474, 501, 527, 552}};
__device__ const float kDqln[4][16] = {
    {116, 365},
    {-2048, 135, 273, 373},
    {-2048, 4, 135, 213, 273, 323, 373, 425},
    {-2048, -66, 28, 104, 169, 224, 274, 318, 358, 395, 429, 459, 488, 514, 539, 566}};
__device__ const float kW[4][16] = {
    {-22, 439},
    {-4, 30, 137, 582},
    {-12, 18, 41, 64, 112, 198, 355, 1122},
    {14, 14, 24, 39, 40, 41, 58, 100, 141, 179, 219, 280, 358, 440, 529, 696}};
__device__ const float kF[4][16] = {
    {0, 7},
    {0, 1, 2, 7},
    {0, 0, 0, 1, 1, 1, 3, 7},
    {0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 6}};

struct G726Tables {
    float dqln[16], W[16], F[16];
};

template <int BITS>
__device__ __forceinline__ void g726_load_tables(G726Tables* t)
{
    for (int i = threadIdx.x; i < 16; i += blockDim.x) {
        t->dqln[i] = kDqln[BITS - 2][i];
        t->W[i] = kW[BITS - 2][i];
        t->F[i] = kF[BITS - 2][i];
    }
    __syncthreads();
}

// One leg's codec state (g726.py g726_state), in registers.
struct G726 {
    float b[6], dq[6], a1, a2, sr1, sr2, p1, p2, yu, yl, dms, dml, ap, td;
};

// Pointers to the state leaves in device memory, in g726_state's order:
// b [B, 6], dq [B, 6], then twelve [B] leaves.
struct G726Ptrs {
    float *b, *dq, *a1, *a2, *sr1, *sr2, *p1, *p2, *yu, *yl, *dms, *dml, *ap, *td;
};

__device__ __forceinline__ void g726_load(G726& z, const G726Ptrs& q, int leg)
{
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        z.b[k] = q.b[6 * leg + k];
        z.dq[k] = q.dq[6 * leg + k];
    }
    z.a1 = q.a1[leg];
    z.a2 = q.a2[leg];
    z.sr1 = q.sr1[leg];
    z.sr2 = q.sr2[leg];
    z.p1 = q.p1[leg];
    z.p2 = q.p2[leg];
    z.yu = q.yu[leg];
    z.yl = q.yl[leg];
    z.dms = q.dms[leg];
    z.dml = q.dml[leg];
    z.ap = q.ap[leg];
    z.td = q.td[leg];
}

__device__ __forceinline__ void g726_store(const G726& z, const G726Ptrs& q, int leg)
{
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        q.b[6 * leg + k] = z.b[k];
        q.dq[6 * leg + k] = z.dq[k];
    }
    q.a1[leg] = z.a1;
    q.a2[leg] = z.a2;
    q.sr1[leg] = z.sr1;
    q.sr2[leg] = z.sr2;
    q.p1[leg] = z.p1;
    q.p2[leg] = z.p2;
    q.yu[leg] = z.yu;
    q.yl[leg] = z.yl;
    q.dms[leg] = z.dms;
    q.dml[leg] = z.dml;
    q.ap[leg] = z.ap;
    q.td[leg] = z.td;
}

__device__ __forceinline__ float clipf(float x, float lo, float hi)
{
    return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float signf(float x)
{
    return (float)((x > 0.0f) - (x < 0.0f));
}

// g726.py _scale: the quantizer scale factor y, mixed from yu and yl by al.
__device__ __forceinline__ float g726_scale(const G726& z)
{
    const float al = clipf(z.ap / 256.0f, 0.0f, 1.0f);
    return al * z.yu + (1.0f - al) * (z.yl / 64.0f);
}

// g726.py: the six-tap zero-section estimate, summed left to right.
__device__ __forceinline__ float g726_sez(const G726& z)
{
    float acc = z.b[0] * z.dq[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc = acc + z.b[k] * z.dq[k];
    return acc;
}

// g726.py reconstruct + _adapt: the back half the encoder and the decoder
// share. code -> the reconstructed sample sr; z is advanced one sample.
// sez, se and y are the values of this sample's state before the update.
template <int BITS>
__device__ __forceinline__ float g726_reconstruct(G726& z, int code, float sez, float se,
                                                  float y, const G726Tables& t)
{
    constexpr int half = 1 << (BITS - 1);
    // a code outside [0, 2^BITS) reads the table's last entry, as the JAX
    // package's clamped gather does
    const int mag = min(code >= half ? code - half : half - 1 - code, half - 1);
    const float sign = code >= half ? 1.0f : -1.0f;
    const float dql = t.dqln[mag] + y / 4.0f;                  // log domain
    float dq = sign * exp2f(dql / 128.0f);
    dq = dql < -1024.0f ? 0.0f : dq;                           // "-2048" = zero level
    const float sr = se + dq;
    // _adapt: scale factor (yu fast / yl locked)
    const float w = t.W[mag];
    const float yu = clipf(y + (w * 32.0f - y) / 32.0f, 544.0f, 5120.0f);
    float yl = z.yl + (yu - z.yl / 64.0f);
    yl = clipf(yl, 544.0f * 64.0f, 5120.0f * 64.0f);
    // adaptation speed
    const float f = t.F[mag];
    const float dms = z.dms + (f * 32.0f - z.dms) / 32.0f;
    const float dml = z.dml + (f * 128.0f - z.dml) / 128.0f;
    // tone / transition detection
    const float td = z.a2 < -0.71875f ? 1.0f : 0.0f;
    const bool tr = (z.td > 0.0f) && (fabsf(dq) > 1.5f * exp2f(z.yl / 64.0f / 128.0f));
    const float ax = ((y < 1536.0f) || (td > 0.0f)
                      || (fabsf(dms / 4.0f - dml / 16.0f) >= dml / 128.0f)) ? 1.0f : 0.0f;
    const float ap = tr ? 256.0f : z.ap + (ax * 512.0f - z.ap) / 16.0f;
    // predictor update (sign-sign LMS with leakage + stability clamps)
    const float sign_dq = signf(dq);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        const float bk = z.b[k] * 0.99609375f + (0.0078125f * sign_dq) * signf(z.dq[k]);
        z.b[k] = tr ? 0.0f : bk;
    }
    const float p0 = dq + sez;
    const float sign_p0 = signf(p0);
    const float sign_p1 = signf(z.p1);
    float a2 = z.a2 * 0.9921875f
               + 0.0078125f * (sign_p0 * signf(z.p2)
                               - 4.0f * clipf((z.a1 * sign_p0) * sign_p1, -0.25f, 0.25f));
    a2 = clipf(a2, -0.75f, 0.75f);
    float a1 = z.a1 * 0.99609375f + (0.01171875f * sign_p0) * sign_p1;
    const float lim = 0.9375f - a2;
    a1 = clipf(a1, -lim, lim);
    z.a1 = tr ? 0.0f : a1;
    z.a2 = tr ? 0.0f : a2;
#pragma unroll
    for (int k = 5; k >= 1; --k) z.dq[k] = z.dq[k - 1];
    z.dq[0] = dq;
    z.sr2 = z.sr1;
    z.sr1 = sr;
    z.p2 = z.p1;
    z.p1 = p0;
    z.yu = yu;
    z.yl = yl;
    z.dms = dms;
    z.dml = dml;
    z.ap = ap;
    z.td = td;
    return sr;
}

// g726.py enc_step over a tick: pcm int32 (int16 range) -> codes.
template <int BITS>
__global__ void __launch_bounds__(ADPCM_THREADS)
g726_encode_kernel(const int* __restrict__ pcm, int* __restrict__ codes, G726Ptrs q, int B, int S)
{
    __shared__ G726Tables t;
    g726_load_tables<BITS>(&t);
    const int leg = blockIdx.x * blockDim.x + threadIdx.x;
    if (leg >= B) return;
    constexpr int half = 1 << (BITS - 1);
    G726 z;
    g726_load(z, q, leg);
    const int* in = pcm + (size_t)leg * S;
    int* out = codes + (size_t)leg * S;
    int next = S > 0 ? in[0] : 0;
    for (int j = 0; j < S; ++j) {
        const float x = (float)next / 4.0f;            // 14-bit domain
        if (j + 1 < S) next = in[j + 1];               // one sample ahead
        const float sez = g726_sez(z);
        const float se = sez + z.a1 * z.sr1 + z.a2 * z.sr2;
        const float d = x - se;
        const float y = g726_scale(z);
        const float dl = log2f(fmaxf(fabsf(d), 1e-6f)) * 128.0f;
        const float dln = dl - y / 4.0f;
        int mag = 0;
#pragma unroll
        for (int k = 0; k < half - 1; ++k) mag += dln >= kQtab[BITS - 2][k];
        mag = min(mag, half - 1);
        const int code = d >= 0.0f ? half + mag : half - 1 - mag;
        g726_reconstruct<BITS>(z, code, sez, se, y, t);
        out[j] = code;
    }
    g726_store(z, q, leg);
}

// g726.py dec_step over a tick: codes -> pcm float32, sr * 4 clipped to int16.
template <int BITS>
__global__ void __launch_bounds__(ADPCM_THREADS)
g726_decode_kernel(const int* __restrict__ codes, float* __restrict__ pcm, G726Ptrs q, int B,
                   int S)
{
    __shared__ G726Tables t;
    g726_load_tables<BITS>(&t);
    const int leg = blockIdx.x * blockDim.x + threadIdx.x;
    if (leg >= B) return;
    G726 z;
    g726_load(z, q, leg);
    const int* in = codes + (size_t)leg * S;
    float* out = pcm + (size_t)leg * S;
    int next = S > 0 ? in[0] : 0;
    for (int j = 0; j < S; ++j) {
        const int code = next;
        if (j + 1 < S) next = in[j + 1];               // one sample ahead
        const float sez = g726_sez(z);
        const float se = sez + z.a1 * z.sr1 + z.a2 * z.sr2;
        const float y = g726_scale(z);
        const float sr = g726_reconstruct<BITS>(z, code, sez, se, y, t);
        out[j] = clipf(sr * 4.0f, -32768.0f, 32767.0f);
    }
    g726_store(z, q, leg);
}

// state: 14 device pointers, the leaves of g726_state in its order.
__host__ G726Ptrs g726_ptrs(void* const* s)
{
    return G726Ptrs{(float*)s[0], (float*)s[1], (float*)s[2], (float*)s[3], (float*)s[4],
                    (float*)s[5], (float*)s[6], (float*)s[7], (float*)s[8], (float*)s[9],
                    (float*)s[10], (float*)s[11], (float*)s[12], (float*)s[13]};
}

inline int blocks(int B) { return (B + ADPCM_THREADS - 1) / ADPCM_THREADS; }

}  // namespace

extern "C" {

// pcm int32 [B, S] -> codes int32 [B, S] (0..15); pred, index int32 [B]
// updated in place.
int ms2_dvi4_encode(int device, const void* pcm, void* codes, void* pred, void* index,
                    int B, int S, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return (int)cudaGetLastError();
    dvi4_encode_kernel<<<blocks(B), ADPCM_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)pcm, (int*)codes, (int*)pred, (int*)index, B, S);
    return (int)cudaGetLastError();
}

// codes int32 [B, S] -> pcm int32 [B, S]; pred, index updated in place.
int ms2_dvi4_decode(int device, const void* codes, void* pcm, void* pred, void* index,
                    int B, int S, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return (int)cudaGetLastError();
    dvi4_decode_kernel<<<blocks(B), ADPCM_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)codes, (int*)pcm, (int*)pred, (int*)index, B, S);
    return (int)cudaGetLastError();
}

// pcm int32 [B, S] (int16 range) -> codes int32 [B, S] in [0, 2^bits);
// state updated in place. bits outside 2..5: cudaErrorInvalidValue.
int ms2_g726_encode(int device, int bits, const void* pcm, void* codes, void* const* state,
                    int B, int S, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (bits < 2 || bits > 5) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaGetLastError();
    const G726Ptrs q = g726_ptrs(state);
    const cudaStream_t st = (cudaStream_t)stream;
    const int* in = (const int*)pcm;
    int* out = (int*)codes;
    switch (bits) {
    case 2: g726_encode_kernel<2><<<blocks(B), ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    case 3: g726_encode_kernel<3><<<blocks(B), ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    case 4: g726_encode_kernel<4><<<blocks(B), ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    default: g726_encode_kernel<5><<<blocks(B), ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    }
    return (int)cudaGetLastError();
}

// codes int32 [B, S] -> pcm float32 [B, S]; state updated in place.
int ms2_g726_decode(int device, int bits, const void* codes, void* pcm, void* const* state,
                    int B, int S, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (bits < 2 || bits > 5) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaGetLastError();
    const G726Ptrs q = g726_ptrs(state);
    const cudaStream_t st = (cudaStream_t)stream;
    const int* in = (const int*)codes;
    float* out = (float*)pcm;
    switch (bits) {
    case 2: g726_decode_kernel<2><<<blocks(B), ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    case 3: g726_decode_kernel<3><<<blocks(B), ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    case 4: g726_decode_kernel<4><<<blocks(B), ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    default: g726_decode_kernel<5><<<blocks(B), ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
