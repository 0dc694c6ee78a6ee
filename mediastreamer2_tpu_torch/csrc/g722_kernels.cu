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
// Design: the lanes of a warp per leg (G722_LANES lanes a leg: 16 by
// default, two legs a warp; 32 gives a leg the whole warp, 8 puts four
// legs in one). Only the two ADPCM recurrences are serial: every slot's
// predictor needs the previous slot's. Every lane of the leg runs them as
// the same scalar code on the same values (the band state in registers;
// the data-dependent tables in shared memory, read as broadcasts), so no
// lane waits for another. What does not depend on the previous slot
// leaves that chain:
// - the QMF. Encode stages the tick's samples in shared memory behind the
//   22 carried samples of the delay line (one coalesced fill, every load
//   issued before the first store), and lane l splits the bands of slots
//   l, l + G722_LANES, ... before the slot loop. Decode writes each slot's
//   reconstructed pair into that line and recombines it over the lanes
//   after the loop. Codes, samples and the new line are stored coalesced.
// - the 6-bit quantizer's 29 threshold products and compares: each lane
//   holds its kQ6 entries in registers and tests them; the count is the
//   popc of a ballot (of the leg's segment of it).
// What bounds it: integer issue within one warp. The slot loop is 364
// (encode) and ~300 (decode) SASS instructions, nearly all integer, and
// the integer pipes take a warp-instruction in 2 cycles; a warp's slots run
// one after another. Lanes repeating a leg's scalar code cost no issue, but
// warps do: at B = 1,024, 16 lanes give 512 warps (one a scheduler on 128
// SMs), 32 lanes 1,024 (two a scheduler, each issuing the whole loop).
// Measured on an H100 at 700 W (tools/g722_variants.py, one call), encode /
// decode ms a launch at B = 1,024: 16 lanes 0.0314 / 0.0245, within 7% and
// 2% of 2 cycles an instruction; 8 lanes 0.0335 / 0.0250; 32 lanes 0.0496 /
// 0.0408; the earlier design, a thread per leg with the QMF and the
// threshold count on that thread (544 / 391 instructions a slot, 32 warps
// on 8 SMs), 0.0480 / 0.0360. A tick longer than G722_CHUNK slots runs in chunks, the
// line carried between.
//
// Arithmetic is the JAX package's, bit for bit: int32 with wrap-around, an
// arithmetic >>, the decoder's output wrapped (not saturated) to int16, and
// the log-scale shift branching on its sign instead of shifting by a
// negative count.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef G722_LANES
#define G722_LANES 16          // lanes a leg: 16, 8 or 32
#endif
#define G722_THREADS 128       // 4 warps a block
#define G722_CHUNK 96          // code slots staged in shared memory at a time

namespace {

static_assert(G722_LANES == 8 || G722_LANES == 16 || G722_LANES == 32,
              "G722_LANES must be 8, 16 or 32");
static_assert(G722_CHUNK % 32 == 0, "G722_CHUNK must be a multiple of 32");
constexpr int kLanes = G722_LANES;
constexpr int kLegsPerBlock = G722_THREADS / kLanes;
constexpr int kLegsPerWarp = 32 / kLanes;
constexpr int kThresholdsPerLane = 32 / kLanes;   // the 29 thresholds over a leg's lanes
constexpr int kChunk = G722_CHUNK;
constexpr int kCarried = 11;                      // the line's 22 carried samples, as pairs
constexpr unsigned kFullMask = 0xFFFFFFFFu;

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
// kQ6 is read once a lane into a register; kQMF by unrolled loop counters
// only (one entry for the whole warp): the constant bank
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

// A leg's staging area in shared memory. line: the QMF delay line as
// sample pairs, the 22 carried samples and then the chunk's 2 samples a
// slot (encode: the input; decode: rlow + rhigh, rlow - rhigh); band: the
// split bands (xlow, xhigh) a slot; code: the codes a slot.
struct EncodeLeg {
    int2 line[kCarried + kChunk];
    int2 band[kChunk];
    int code[kChunk];
};
struct DecodeLeg {
    int2 line[kCarried + kChunk];
    int code[kChunk];
};

// Which leg a thread serves. A warp whose legs all lie past B returns as a
// whole (the result); a leg past B in a live warp (when a warp holds
// several legs) reads the last leg and stores nothing, so that every
// ballot and __syncwarp of the warp sees all 32 lanes.
struct LegMap {
    int lane;     // lane within the leg
    int local;    // leg within the block
    int src;      // the leg read
    bool live;    // the leg is < B: its results are stored
};

__device__ __forceinline__ bool map_leg(LegMap& m, int B)
{
    m.lane = threadIdx.x % kLanes;
    m.local = threadIdx.x / kLanes;
    const int leg = (int)blockIdx.x * kLegsPerBlock + m.local;
    m.live = leg < B;
    m.src = m.live ? leg : B - 1;
    return (int)blockIdx.x * kLegsPerBlock + (int)(threadIdx.x / 32) * kLegsPerWarp < B;
}

// Stage n <= kChunk elements of a leg's row in shared memory: the leg's
// lanes on consecutive elements, every load issued before the first store.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int n, int lane)
{
    constexpr int kPer = kChunk / kLanes;
    T v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
        if (lane + k * kLanes < n) v[k] = __ldg(src + lane + k * kLanes);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
        if (lane + k * kLanes < n) dst[lane + k * kLanes] = v[k];
}

// The line's 22 carried samples from the state's delay line x[2..23].
__device__ __forceinline__ void line_load(int2* line, const int* x, int lane)
{
    int* l = reinterpret_cast<int*>(line);
    for (int k = lane; k < 2 * kCarried; k += kLanes) l[k] = x[2 + k];
}

// After a chunk of n slots: the tick's last chunk stores the new delay
// line (the line's last 24 samples) into x; any other moves the line's
// last 22 samples to its head for the next chunk.
__device__ __forceinline__ void line_advance(int2* line, int n, bool last, int* x,
                                             bool live, int lane)
{
    if (last) {
        const int* l = reinterpret_cast<const int*>(line);
        if (live)
            for (int k = lane; k < 24; k += kLanes) x[k] = l[2 * n - 2 + k];
        return;
    }
    constexpr int kPer = (kCarried + kLanes - 1) / kLanes;
    int2 keep[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
        if (lane + k * kLanes < kCarried) keep[k] = line[n + lane + k * kLanes];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kPer; ++k)
        if (lane + k * kLanes < kCarried) line[lane + k * kLanes] = keep[k];
    __syncwarp();
}

// The QMF's two 12-tap sums over the 24 samples of line[j .. j + 11]:
// .x the even-indexed samples by kQMF, .y the odd-indexed by kQMF reversed
// (the reference's sumodd and sumeven; xout2 and xout1 when decoding).
__device__ __forceinline__ int2 qmf_sums(const int2* line, int j)
{
    int even = 0, odd = 0;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
        const int2 w = line[j + k];
        even += w.x * kQMF[k];
        odd += w.y * kQMF[11 - k];
    }
    return make_int2(even, odd);
}

// The 6-bit quantizer's index i = 1 + #{k in 1..29 : wd >= (kQ6[k] * det) >> 12}:
// this lane tests kQ6[1 + lane * kThresholdsPerLane + t] (q6[t], where ok[t])
// and a ballot counts the leg's lanes; seg is the leg's first lane in the warp.
__device__ __forceinline__ int quantize6(const int* q6, const bool* ok, int wd, int det,
                                         int seg)
{
    int i = 1;
#pragma unroll
    for (int t = 0; t < kThresholdsPerLane; ++t) {
        const unsigned votes = __ballot_sync(kFullMask, ok[t] && wd >= ((q6[t] * det) >> 12));
        if constexpr (kLanes == 32)
            i += __popc(votes);
        else
            i += __popc((votes >> seg) & ((1u << kLanes) - 1));
    }
    return i;
}

__global__ void __launch_bounds__(G722_THREADS)
g722_encode_kernel(const int* __restrict__ pcm, int* __restrict__ codes,
                   BandPtrs lo_p, BandPtrs hi_p, int* __restrict__ x_p, int B, int C)
{
    __shared__ SharedTables t;
    __shared__ EncodeLeg legs[kLegsPerBlock];
    load_tables(&t);
    LegMap m;
    if (!map_leg(m, B)) return;
    EncodeLeg& L = legs[m.local];
    const int seg = (threadIdx.x % 32) / kLanes * kLanes;
    int q6[kThresholdsPerLane];
    bool ok[kThresholdsPerLane];
#pragma unroll
    for (int u = 0; u < kThresholdsPerLane; ++u) {
        const int k = 1 + m.lane * kThresholdsPerLane + u;
        ok[u] = k < 30;
        q6[u] = kQ6[ok[u] ? k : 0];
    }
    Band lo, hi;
    band_load(lo, lo_p, m.src);
    band_load(hi, hi_p, m.src);
    int* x = x_p + 24 * (size_t)m.src;
    line_load(L.line, x, m.lane);
    const int2* in = reinterpret_cast<const int2*>(pcm + (size_t)m.src * 2 * C);
    int* out = codes + (size_t)m.src * C;
    for (int j0 = 0; j0 < C; j0 += kChunk) {
        const int n = min(kChunk, C - j0);
        stage(L.line + kCarried, in + j0, n, m.lane);
        __syncwarp();
        // QMF transmit of the chunk's slots, over the lanes
        for (int j = m.lane; j < n; j += kLanes) {
            const int2 s = qmf_sums(L.line, j);
            L.band[j] = make_int2((s.y + s.x) >> 13, (s.y - s.x) >> 13);   // xlow, xhigh
        }
        __syncwarp();
        int2 next = L.band[0];
        for (int j = 0; j < n; ++j) {
            const int2 xb = next;
            if (j + 1 < n) next = L.band[j + 1];           // one slot ahead

            // lower band (6-bit)
            const int el = sat16(xb.x - lo.s);
            int wd = el >= 0 ? el : -(el + 1);
            const int i = quantize6(q6, ok, wd, lo.det, seg);
            const int ilow = el < 0 ? t.iln[i] : t.ilp[i];
            const int ril = ilow >> 2;
            const int dlow = (lo.det * t.qm4[ril]) >> 15;
            scalel(lo, t.wl[t.rl42[ril]], 18432, 8, t.ilb);
            block4(lo, dlow);

            // higher band (2-bit)
            const int eh = sat16(xb.y - hi.s);
            wd = eh >= 0 ? eh : -(eh + 1);
            const int mih = wd >= ((564 * hi.det) >> 12) ? 2 : 1;
            const int ihigh = eh < 0 ? (mih == 1 ? 1 : 0) : (mih == 1 ? 3 : 2);   // IHN / IHP
            const int dhigh = (hi.det * t.qm2[ihigh]) >> 15;
            scalel(hi, t.wh[t.rh2[ihigh]], 22528, 10, t.ilb);
            block4(hi, dhigh);

            L.code[j] = (ihigh << 6) | ilow;               // every lane, the same value
        }
        __syncwarp();
        if (m.live)
            for (int j = m.lane; j < n; j += kLanes) out[j0 + j] = L.code[j];
        line_advance(L.line, n, j0 + n >= C, x, m.live, m.lane);
    }
    if (m.live && m.lane == 0) {
        band_store(lo, lo_p, m.src);
        band_store(hi, hi_p, m.src);
    }
}

__global__ void __launch_bounds__(G722_THREADS)
g722_decode_kernel(const int* __restrict__ codes, int* __restrict__ pcm,
                   BandPtrs lo_p, BandPtrs hi_p, int* __restrict__ x_p, int B, int C)
{
    __shared__ SharedTables t;
    __shared__ DecodeLeg legs[kLegsPerBlock];
    load_tables(&t);
    LegMap m;
    if (!map_leg(m, B)) return;
    DecodeLeg& L = legs[m.local];
    Band lo, hi;
    band_load(lo, lo_p, m.src);
    band_load(hi, hi_p, m.src);
    int* x = x_p + 24 * (size_t)m.src;
    line_load(L.line, x, m.lane);
    const int* in = codes + (size_t)m.src * C;
    int2* out = reinterpret_cast<int2*>(pcm + (size_t)m.src * 2 * C);
    for (int j0 = 0; j0 < C; j0 += kChunk) {
        const int n = min(kChunk, C - j0);
        stage(L.code, in + j0, n, m.lane);
        __syncwarp();
        int next = L.code[0];
        // unrolled twice: the predictor's delay lines shift by renaming, not
        // by register moves (335 -> 299 instructions a slot in SASS)
#pragma unroll 2
        for (int j = 0; j < n; ++j) {
            const int code = next;
            if (j + 1 < n) next = L.code[j + 1];           // one slot ahead
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
            L.line[kCarried + j] = make_int2(rlow + rhigh, rlow - rhigh);   // every lane
        }
        __syncwarp();
        // QMF receive of the chunk's slots, over the lanes: two 16 kHz
        // samples a slot, (int16_t)(xout >> 12): wrapped, not saturated
        for (int j = m.lane; j < n; j += kLanes) {
            const int2 s = qmf_sums(L.line, j);
            if (m.live)
                out[j0 + j] = make_int2((((s.y >> 12) + 32768) & 0xFFFF) - 32768,
                                        (((s.x >> 12) + 32768) & 0xFFFF) - 32768);
        }
        line_advance(L.line, n, j0 + n >= C, x, m.live, m.lane);
    }
    if (m.live && m.lane == 0) {
        band_store(lo, lo_p, m.src);
        band_store(hi, hi_p, m.src);
    }
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
    g722_encode_kernel<<<(B + kLegsPerBlock - 1) / kLegsPerBlock, G722_THREADS, 0,
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
    g722_decode_kernel<<<(B + kLegsPerBlock - 1) / kLegsPerBlock, G722_THREADS, 0,
                         (cudaStream_t)stream>>>((const int*)codes, (int*)pcm, lo, hi, x, B, C);
    return (int)cudaGetLastError();
}

}  // extern "C"
