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
// What bounds them is the serial chain: every sample's predictor needs the
// previous sample's, so a leg's samples run one after another at the latency
// of their dependent operations (the DVI4 decoder excepted: its carries are
// clamped sums, which compose, below); the bytes, 0.66 MB (DVI4) or 0.85 MB
// (G.726) a call at 1,024 legs, take 0.2-0.3 microseconds at 3.35 TB/s.
//
// DVI4: a leg's samples on the lanes of a warp.
// - Decode: a leg a warp, four warps a block. Both carries of _dec_step are
//   clamped sums: index' = clamp(index + adj(code), 0, 88) and pred' =
//   clamp(pred + v, -32768, 32767), v = +-vpdiff(step[index], code). Write
//   x -> min(max(x + a, lo), hi) as the triple (a, lo, hi): (a1, l1, h1)
//   followed by (a2, l2, h2) is (a1 + a2, clamp(l1 + a2, l2, h2),
//   clamp(h1 + a2, l2, h2)), exact in int32 (|a| <= 32 x 61,436). So a chunk
//   of a leg's samples, one a lane, decodes as two Kogge-Stone scans of five
//   shuffle levels: the index triples (adj(code), 0, 88) give each sample's
//   index; each lane reads its step from shared memory and makes its v; the
//   pred triples (v, -32768, 32767) give each sample's output, stored
//   coalesced. Lanes past S take the identity. The last lane's index and
//   pred carry into the next chunk by a shuffle. The next chunk's index scan
//   does not need this chunk's carry, so it runs beside this chunk's pred
//   scan; the codes arrive up to three chunks ahead, a chunk in one
//   coalesced load.
// - Encode: DVI4_LANES lanes a leg (16 by default: two legs a warp). The
//   code quantises x - pred, so the samples stay serial, and every lane of
//   the leg runs the recurrence as the same scalar code. What leaves the
//   chain: the loads (the leg's next DVI4_LANES samples in one coalesced
//   load, a chunk ahead; sample j reaches the chain by a shuffle from lane
//   j, and lane j keeps code j, stored DVI4_LANES at a time; a whole chunk's
//   loop is unrolled, so that j is known at compile time) and the step-table
//   load: the next index is one of five (index - 1, + 2, + 4, + 6, + 8,
//   clamped), whose steps are read from shared memory (a table padded at
//   both ends, so that no clamp comes before the loads) while the quantizer
//   runs, and delta selects one. The quantizer is the three
//   compare-and-subtract rounds.
// Measured on an H100 at 700 W at B = 1,024, 80 samples (tools/
// dvi4_variants.py, one call, in turns, twice; ms a launch): decode 0.0034
// -0.0035 (two legs a warp, 16 lanes each, 0.0036; one warp a block
// 0.0041), encode 0.0084 (8 lanes a leg 0.0087, 32 lanes 0.0094; the
// quantizer as the count of the seven thresholds T(d) = (d&4 ? s : 0) +
// (d&2 ? s>>1 : 0) + (d&1 ? s>>2 : 0) that |diff| reaches, with vpdiff =
// (s>>3) + T(delta), bit-exact too and a shorter chain, 0.0102: it issues
// more instructions); the earlier design, a leg a thread, 0.0095 and
// 0.0108-0.0109; an empty kernel's launch 0.0017 (one block) to 0.0023
// (1,024 blocks).
// The encoder's loop is ~44 SASS instructions a sample, issued by one warp
// a scheduler at ~3.4 cycles an instruction: its dependent steps, not its
// loads, bound it now. The earlier design walked each leg's row at a stride
// of S * 4 bytes, one sample ahead, at ~5 cycles an instruction; staging
// its rows through a shared-memory tile, filled row by row with one load
// in flight a thread, had measured three times slower still.
// The step and index tables sit in shared memory (the lanes read different
// entries, which the constant cache would serialise).
//
// G.726: the lanes of a warp per leg (G726_LANES lanes a leg, 16 by
// default: two legs a warp, a block one warp). Every lane of the leg runs
// the serial recurrence as the same scalar code on the same values (the 24
// floats of state in registers: se, d, log2f, y, the scale and speed
// factors, tone detection, the b[k] and a1/a2 updates), so no lane waits
// for another. What does not depend on this sample's d leaves that chain:
// - the quantizer's 1-15 thresholds: lane i holds threshold i in a
//   register, and the count is one compare, a ballot and the popc of the
//   leg's segment of it;
// - the reconstruction: lane i also holds candidate magnitude i's dqln, W
//   and F, and reconstructs its dq from y (both signs) before d is known;
//   once the count gives mag, one shuffle from lane mag brings dq, W[mag]
//   and F[mag] (the encoder's dqln load and exp2f leave its chain);
// - the loads: a leg's lanes read its next G726_LANES samples (or codes) in
//   one coalesced load, a whole chunk ahead, and each sample reaches the
//   chain by a shuffle; lane j stores sample j's output, G726_LANES at a
//   time. The decoder's lanes look up their own code's table entries from
//   shared memory, off the chain.
// Measured on an H100 at 700 W at B = 1,024, 80 samples
// (tools/g726_variants.py, one call, in turns, twice; ms a launch at 16 /
// 24 / 32 / 40 kbit/s): encode 0.0194 / 0.0191 / 0.0191 / 0.0194 with 16
// lanes, 0.0197 / 0.0194 / 0.0197 / 0.0281 with 8, 0.0206 / 0.0207 /
// 0.0308 / 0.0295 with 4 (two to four thresholds and candidates a lane,
// kept in local memory at 40 kbit/s), and 0.0278 / 0.0307 / 0.0318 / 0.0343
// with one thread a leg (the earlier design); decode 0.0176 with 16 lanes,
// 0.0181 with 8, 0.0195 with 4, 0.0213 with one thread. The b[k] updates
// and products on lanes 0-5, their sum gathered by shuffles, measured 0.0187
// -0.0192 (encode) and 0.0199-0.0206 (decode): not kept. The sample loop is
// ~250 (encode) and ~204 (decode) SASS instructions, mostly float, issued
// by one warp a scheduler at ~2 cycles an instruction: the latency of its
// dependent steps bounds it.
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
#define ADPCM_THREADS 32       // threads a block: one warp
#endif
#ifndef DVI4_LANES
#define DVI4_LANES 16          // lanes a DVI4 encoder leg: 8, 16 or 32
#endif
#ifndef G726_LANES
#define G726_LANES 16          // lanes a G.726 leg: 4, 8, 16 or 32
#endif

namespace {

static_assert(ADPCM_THREADS % 32 == 0, "ADPCM_THREADS must be a multiple of 32");
static_assert(DVI4_LANES == 8 || DVI4_LANES == 16 || DVI4_LANES == 32,
              "DVI4_LANES must be 8, 16 or 32");
static_assert(G726_LANES == 4 || G726_LANES == 8 || G726_LANES == 16 || G726_LANES == 32,
              "G726_LANES must be 4, 8, 16 or 32");
constexpr int kG726Lanes = G726_LANES;
constexpr int kDvi4DecThreads = 128;   // the DVI4 decoder's block: four legs of a warp
constexpr unsigned kFull = 0xFFFFFFFFu;

// The lanes of a leg: a warp holds 32 / L legs of L lanes, a block of T
// threads T / L. A warp whose legs all lie past B returns as a whole
// (leg_map's result); a leg past B in a live warp reads the last leg and
// stores nothing, so that every ballot and shuffle of the warp sees all 32
// lanes.
struct LegLanes {
    int lane;     // lane within the leg
    int seg;      // the leg's first lane in the warp
    int src;      // the leg read
    bool live;    // the leg is < B: its results are stored
};

template <int L, int T = ADPCM_THREADS>
__device__ __forceinline__ bool leg_map(LegLanes& m, int B)
{
    constexpr int legs_per_block = T / L, legs_per_warp = 32 / L;
    m.lane = threadIdx.x % L;
    m.seg = threadIdx.x % 32 - m.lane;
    const int leg = (int)blockIdx.x * legs_per_block + (int)threadIdx.x / L;
    m.live = leg < B;
    m.src = m.live ? leg : B - 1;
    return (int)blockIdx.x * legs_per_block + (int)(threadIdx.x / 32) * legs_per_warp < B;
}

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

// The step table padded for the encoder's five candidates: step[i] is at
// i + 1, with step[0] once before it and step[88] eight times after it, so
// that index - 1 .. index + 8 read the clamped indices' steps.
struct Dvi4Tables {
    int step[1 + 89 + 8], index[8];
};

__device__ __forceinline__ void dvi4_load_tables(Dvi4Tables* t)
{
    for (int i = threadIdx.x; i < 1 + 89 + 8; i += blockDim.x)
        t->step[i] = kStep[min(max(i - 1, 0), 88)];
    for (int i = threadIdx.x; i < 8; i += blockDim.x) t->index[i] = kIndex[i];
    __syncthreads();
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// One encoder's state: pred, index and step = step table[index].
struct Dvi4Enc {
    int pred, index, step;
};

// adpcm.py _enc_step: one sample x -> its code; z advanced. ``tab`` is the
// padded step table.
__device__ __forceinline__ int dvi4_enc_sample(Dvi4Enc& z, int x, const int* tab)
{
    // the steps of the five indices the next sample can have
    const int* cand = tab + 1 + z.index;
    const int s_dn = cand[-1], s_2 = cand[2], s_4 = cand[4], s_6 = cand[6], s_8 = cand[8];
    const int step = z.step, h = step >> 1, q = step >> 2;
    const int diff = x - z.pred;
    const int mag = abs(diff);
    int rest = mag, vpdiff = step >> 3;
    const int b2 = rest >= step;
    if (b2) { rest -= step; vpdiff += step; }
    const int b1 = rest >= h;
    if (b1) { rest -= h; vpdiff += h; }
    const int b0 = rest >= q;
    if (b0) vpdiff += q;
    const int delta = (b2 << 2) | (b1 << 1) | b0;
    z.pred = clampi(diff < 0 ? z.pred - vpdiff : z.pred + vpdiff, -32768, 32767);
    z.index = clampi(z.index + (delta < 4 ? -1 : 2 * delta - 6), 0, 88);
    const int s_up = (delta & 2) ? ((delta & 1) ? s_8 : s_6) : ((delta & 1) ? s_4 : s_2);
    z.step = (delta & 4) ? s_up : s_dn;
    return (diff < 0 ? 8 : 0) | delta;
}

// adpcm.py _enc_step over a tick: pcm int32 [B, S] -> codes 0..15. Every
// lane of a leg runs the recurrence; lane j of a chunk loads sample j0 + j
// a chunk ahead and keeps code j0 + j.
template <int L>
__global__ void __launch_bounds__(ADPCM_THREADS)
dvi4_encode_kernel(const int* __restrict__ pcm, int* __restrict__ codes,
                   int* __restrict__ pred_p, int* __restrict__ index_p, int B, int S)
{
    __shared__ Dvi4Tables t;
    LegLanes m;
    const bool warp_live = leg_map<L>(m, B);
    const int* in = pcm + (size_t)m.src * S;
    int* out = codes + (size_t)m.src * S;
    Dvi4Enc z{pred_p[m.src], index_p[m.src], 0};
    int next = m.lane < S ? __ldg(in + m.lane) : 0;    // in flight while the tables load
    dvi4_load_tables(&t);
    if (!warp_live) return;
    z.step = t.step[1 + z.index];
    for (int j0 = 0; j0 < S; j0 += L) {
        const int xs = next;                            // sample j0 + lane
        if (j0 + L + m.lane < S) next = __ldg(in + j0 + L + m.lane);
        const int n = min(L, S - j0);
        int mine = 0;
        if (n == L) {                                   // a whole chunk: j known at compile time
#pragma unroll
            for (int j = 0; j < L; ++j) {
                const int code = dvi4_enc_sample(z, __shfl_sync(kFull, xs, m.seg + j), t.step);
                mine = m.lane == j ? code : mine;
            }
        } else {
            for (int j = 0; j < n; ++j) {
                const int code = dvi4_enc_sample(z, __shfl_sync(kFull, xs, m.seg + j), t.step);
                mine = m.lane == j ? code : mine;
            }
        }
        if (m.live && m.lane < n) out[j0 + m.lane] = mine;
    }
    if (m.live && m.lane == 0) {
        pred_p[m.src] = z.pred;
        index_p[m.src] = z.index;
    }
}

// An inclusive scan of clamped-add maps x -> min(max(x + a, lo), hi) over
// the 32 lanes of a warp: lane i ends with lanes 0..i's maps composed in
// order, lane 0's first.
__device__ __forceinline__ void clamp_scan(int& a, int& lo, int& hi, int lane)
{
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int pa = __shfl_up_sync(kFull, a, d);
        const int pl = __shfl_up_sync(kFull, lo, d);
        const int ph = __shfl_up_sync(kFull, hi, d);
        if (lane >= d) {                                // (pa, pl, ph), then (a, lo, hi)
            const int nlo = clampi(pl + a, lo, hi);
            hi = clampi(ph + a, lo, hi);
            lo = nlo;
            a += pa;
        }
    }
}

// adpcm.py _dec_step over a tick: codes -> pcm int32, a leg a warp, a chunk
// of 32 samples a step, one a lane, by two clamp_scans.
__global__ void __launch_bounds__(kDvi4DecThreads)
dvi4_decode_kernel(const int* __restrict__ codes, int* __restrict__ pcm,
                   int* __restrict__ pred_p, int* __restrict__ index_p, int B, int S)
{
    constexpr int L = 32;                               // a leg a warp: clamp_scan's span
    __shared__ Dvi4Tables t;
    LegLanes m;
    const bool warp_live = leg_map<L, kDvi4DecThreads>(m, B);
    const int* in = codes + (size_t)m.src * S;
    int* out = pcm + (size_t)m.src * S;
    int pred = pred_p[m.src], index = index_p[m.src];
    // codes of chunks k, k + 1, k + 2 (lane's sample), in flight while the tables load
    int code = m.lane < S ? __ldg(in + m.lane) : 0;
    int c1 = L + m.lane < S ? __ldg(in + L + m.lane) : 0;
    int c2 = 2 * L + m.lane < S ? __ldg(in + 2 * L + m.lane) : 0;
    dvi4_load_tables(&t);
    if (!warp_live) return;
    // chunk 0's index maps
    int ia = m.lane < S ? t.index[code & 7] : 0, il = 0, ih = 88;
    clamp_scan(ia, il, ih, m.lane);
    for (int j0 = 0; j0 < S; j0 += L) {
        const bool valid = j0 + m.lane < S;
        // this lane's index after its sample and before it; the carry
        const int after = clampi(index + ia, il, ih);
        const int up = __shfl_up_sync(kFull, after, 1, L);
        const int before = m.lane == 0 ? index : up;
        index = __shfl_sync(kFull, after, L - 1, L);
        const int step = t.step[1 + before];
        const int delta = code & 7;
        const int vpdiff = (step >> 3) + ((delta & 4) ? step : 0) + ((delta & 2) ? step >> 1 : 0)
                           + ((delta & 1) ? step >> 2 : 0);
        int pa = valid ? ((code & 8) ? -vpdiff : vpdiff) : 0, pl = -32768, ph = 32767;
        // the next chunk's index maps need no carry: that scan runs beside this pred scan
        const int ncode = c1;
        c1 = c2;
        c2 = j0 + 3 * L + m.lane < S ? __ldg(in + j0 + 3 * L + m.lane) : 0;
        ia = j0 + L + m.lane < S ? t.index[ncode & 7] : 0;
        il = 0;
        ih = 88;
        clamp_scan(ia, il, ih, m.lane);
        clamp_scan(pa, pl, ph, m.lane);
        const int p = clampi(pred + pa, pl, ph);
        pred = __shfl_sync(kFull, p, L - 1, L);
        if (m.live && valid) out[j0 + m.lane] = p;
        code = ncode;
    }
    if (m.live && m.lane == 0) {
        pred_p[m.src] = pred;
        index_p[m.src] = index;
    }
}

// An empty kernel: its launch is the floor under every kernel of this file.
__global__ void __launch_bounds__(ADPCM_THREADS) empty_kernel() {}

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

// One leg's codec state (g726.py g726_state), in registers, the same on
// every lane of the leg.
struct G726 {
    float b[6], dq[6], a1, a2, sr1, sr2, p1, p2, yu, yl, dms, dml, ap, td;
};

// Pointers to the state leaves in device memory, in g726_state's order:
// b [B, 6], dq [B, 6], then twelve [B] leaves.
struct G726Ptrs {
    float *b, *dq, *a1, *a2, *sr1, *sr2, *p1, *p2, *yu, *yl, *dms, *dml, *ap, *td;
};

__device__ __forceinline__ void g726_load(G726& z, const G726Ptrs& q, const LegLanes& m)
{
    const int leg = m.src;
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

__device__ __forceinline__ void g726_store(const G726& z, const G726Ptrs& q, const LegLanes& m)
{
    if (!m.live || m.lane != 0) return;
    const int leg = m.src;
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

// The quantized difference of magnitude index mag and sign ``sign`` (+-1):
// sign * 2^((dqln[mag] + y/4) / 128), or 0 below the zero level ("-2048").
__device__ __forceinline__ float g726_dq(float dqln, float y4, float sign)
{
    const float dql = dqln + y4;                               // log domain
    const float dq = sign * exp2f(dql / 128.0f);
    return dql < -1024.0f ? 0.0f : dq;
}

// g726.py reconstruct + _adapt after the quantized difference dq: the back
// half the encoder and the decoder share, with w = W[mag] and f = F[mag].
// z is advanced one sample; returns the reconstructed sample sr. sez, se
// and y are the values of this sample's state before the update.
__device__ __forceinline__ float g726_adapt(G726& z, float dq, float w, float f, float sez,
                                            float se, float y)
{
    const float sr = se + dq;
    // scale factor (yu fast / yl locked)
    const float yu = clipf(y + (w * 32.0f - y) / 32.0f, 544.0f, 5120.0f);
    float yl = z.yl + (yu - z.yl / 64.0f);
    yl = clipf(yl, 544.0f * 64.0f, 5120.0f * 64.0f);
    // adaptation speed
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
#pragma unroll
    for (int k = 5; k >= 1; --k) z.dq[k] = z.dq[k - 1];
    z.dq[0] = dq;
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

// g726.py enc_step over a tick: pcm int32 (int16 range) -> codes. Lane l of
// a leg holds thresholds l * kThr .. l * kThr + kThr - 1 of the rate's
// half - 1, and the candidate magnitudes l, l + G726_LANES, ...: each
// sample, before d is known, it reconstructs its candidates from y (both
// signs); the ballot's count gives mag, and one shuffle from lane mag %
// G726_LANES brings dq, W[mag] and F[mag] to the leg.
template <int BITS>
__global__ void __launch_bounds__(ADPCM_THREADS)
g726_encode_kernel(const int* __restrict__ pcm, int* __restrict__ codes, G726Ptrs q, int B, int S)
{
    constexpr int half = 1 << (BITS - 1);
    constexpr int kThr = (half - 1 + kG726Lanes - 1) / kG726Lanes;    // thresholds a lane
    constexpr int kCand = (half + kG726Lanes - 1) / kG726Lanes;       // magnitudes a lane
    LegLanes m;
    if (!leg_map<kG726Lanes>(m, B)) return;
    const unsigned segmask = kG726Lanes == 32 ? kFull
                                              : ((1u << (kG726Lanes % 32)) - 1u) << m.seg;
    float qt[kThr];
    bool qok[kThr];
#pragma unroll
    for (int t = 0; t < kThr; ++t) {
        const int k = m.lane * kThr + t;
        qok[t] = k < half - 1;
        qt[t] = kQtab[BITS - 2][qok[t] ? k : 0];
    }
    float cdqln[kCand], cw[kCand], cf[kCand];
#pragma unroll
    for (int c = 0; c < kCand; ++c) {
        const int k = min(m.lane + c * kG726Lanes, half - 1);
        cdqln[c] = kDqln[BITS - 2][k];
        cw[c] = kW[BITS - 2][k];
        cf[c] = kF[BITS - 2][k];
    }
    G726 z;
    g726_load(z, q, m);
    const int* in = pcm + (size_t)m.src * S;
    int* out = codes + (size_t)m.src * S;
    int next = m.lane < S ? __ldg(in + m.lane) : 0;
    for (int j0 = 0; j0 < S; j0 += kG726Lanes) {
        const int xs = next;                           // sample j0 + lane
        if (j0 + kG726Lanes + m.lane < S) next = __ldg(in + j0 + kG726Lanes + m.lane);
        const int n = min(kG726Lanes, S - j0);
        int mine = 0;
        for (int j = 0; j < n; ++j) {
            const float x = (float)__shfl_sync(kFull, xs, m.seg + j) / 4.0f;  // 14-bit
            const float y = g726_scale(z);
            const float y4 = y / 4.0f;
            float up[kCand], down[kCand];              // this lane's candidates' dq
#pragma unroll
            for (int c = 0; c < kCand; ++c) {
                up[c] = g726_dq(cdqln[c], y4, 1.0f);
                down[c] = g726_dq(cdqln[c], y4, -1.0f);
            }
            const float sez = g726_sez(z);
            const float se = sez + z.a1 * z.sr1 + z.a2 * z.sr2;
            const float d = x - se;
            const float dln = log2f(fmaxf(fabsf(d), 1e-6f)) * 128.0f - y4;
            int mag = 0;
#pragma unroll
            for (int t = 0; t < kThr; ++t)
                mag += __popc(__ballot_sync(kFull, qok[t] && dln >= qt[t]) & segmask);
            mag = min(mag, half - 1);
            const bool pos = d >= 0.0f;
            float dqc = pos ? up[0] : down[0], wc = cw[0], fc = cf[0];
#pragma unroll
            for (int c = 1; c < kCand; ++c)
                if (mag / kG726Lanes == c) {
                    dqc = pos ? up[c] : down[c];
                    wc = cw[c];
                    fc = cf[c];
                }
            const int from = m.seg + mag % kG726Lanes;
            const float dq = __shfl_sync(kFull, dqc, from);
            const float w = __shfl_sync(kFull, wc, from);
            const float f = __shfl_sync(kFull, fc, from);
            g726_adapt(z, dq, w, f, sez, se, y);
            const int code = pos ? half + mag : half - 1 - mag;
            mine = m.lane == j ? code : mine;
        }
        if (m.live && m.lane < n) out[j0 + m.lane] = mine;
    }
    g726_store(z, q, m);
}

// g726.py dec_step over a tick: codes -> pcm float32, sr * 4 clipped to
// int16. Lane l of a leg reads code j0 + l and looks up its table entries
// off the serial chain; each sample's reach the leg by shuffles.
template <int BITS>
__global__ void __launch_bounds__(ADPCM_THREADS)
g726_decode_kernel(const int* __restrict__ codes, float* __restrict__ pcm, G726Ptrs q, int B,
                   int S)
{
    __shared__ G726Tables t;
    g726_load_tables<BITS>(&t);
    constexpr int half = 1 << (BITS - 1);
    LegLanes m;
    if (!leg_map<kG726Lanes>(m, B)) return;
    G726 z;
    g726_load(z, q, m);
    const int* in = codes + (size_t)m.src * S;
    float* out = pcm + (size_t)m.src * S;
    int next = m.lane < S ? __ldg(in + m.lane) : 0;
    for (int j0 = 0; j0 < S; j0 += kG726Lanes) {
        const int code = next;                         // code j0 + lane
        if (j0 + kG726Lanes + m.lane < S) next = __ldg(in + j0 + kG726Lanes + m.lane);
        const int n = min(kG726Lanes, S - j0);
        // a code outside [0, 2^BITS) reads the table's last entry, as the JAX
        // package's clamped gather does
        const int mag = min(code >= half ? code - half : half - 1 - code, half - 1);
        const float lsign = code >= half ? 1.0f : -1.0f;
        const float ldqln = t.dqln[mag], lw = t.W[mag], lf = t.F[mag];
        float mine = 0.0f;
        for (int j = 0; j < n; ++j) {
            const int from = m.seg + j;
            const float sign = __shfl_sync(kFull, lsign, from);
            const float dqln = __shfl_sync(kFull, ldqln, from);
            const float w = __shfl_sync(kFull, lw, from);
            const float f = __shfl_sync(kFull, lf, from);
            const float sez = g726_sez(z);
            const float se = sez + z.a1 * z.sr1 + z.a2 * z.sr2;
            const float y = g726_scale(z);
            const float dq = g726_dq(dqln, y / 4.0f, sign);
            const float sr = g726_adapt(z, dq, w, f, sez, se, y);
            const float o = clipf(sr * 4.0f, -32768.0f, 32767.0f);
            mine = m.lane == j ? o : mine;
        }
        if (m.live && m.lane < n) out[j0 + m.lane] = mine;
    }
    g726_store(z, q, m);
}

// state: 14 device pointers, the leaves of g726_state in its order.
__host__ G726Ptrs g726_ptrs(void* const* s)
{
    return G726Ptrs{(float*)s[0], (float*)s[1], (float*)s[2], (float*)s[3], (float*)s[4],
                    (float*)s[5], (float*)s[6], (float*)s[7], (float*)s[8], (float*)s[9],
                    (float*)s[10], (float*)s[11], (float*)s[12], (float*)s[13]};
}

// blocks of T threads for B legs of L lanes
template <int L, int T = ADPCM_THREADS>
inline int leg_blocks(int B)
{
    constexpr int legs_per_block = T / L;
    return (B + legs_per_block - 1) / legs_per_block;
}

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
    dvi4_encode_kernel<DVI4_LANES>
        <<<leg_blocks<DVI4_LANES>(B), ADPCM_THREADS, 0, (cudaStream_t)stream>>>(
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
    dvi4_decode_kernel<<<leg_blocks<32, kDvi4DecThreads>(B), kDvi4DecThreads, 0,
                         (cudaStream_t)stream>>>(
        (const int*)codes, (int*)pcm, (int*)pred, (int*)index, B, S);
    return (int)cudaGetLastError();
}

// The launch floor: an empty kernel of ``blocks`` blocks of ADPCM_THREADS
// threads on the given stream.
int ms2_adpcm_empty(int device, int blocks, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    empty_kernel<<<blocks, ADPCM_THREADS, 0, (cudaStream_t)stream>>>();
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
    const int nb = leg_blocks<kG726Lanes>(B);
    const cudaStream_t st = (cudaStream_t)stream;
    const int* in = (const int*)pcm;
    int* out = (int*)codes;
    switch (bits) {
    case 2: g726_encode_kernel<2><<<nb, ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    case 3: g726_encode_kernel<3><<<nb, ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    case 4: g726_encode_kernel<4><<<nb, ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    default: g726_encode_kernel<5><<<nb, ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
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
    const int nb = leg_blocks<kG726Lanes>(B);
    const cudaStream_t st = (cudaStream_t)stream;
    const int* in = (const int*)codes;
    float* out = (float*)pcm;
    switch (bits) {
    case 2: g726_decode_kernel<2><<<nb, ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    case 3: g726_decode_kernel<3><<<nb, ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    case 4: g726_decode_kernel<4><<<nb, ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    default: g726_decode_kernel<5><<<nb, ADPCM_THREADS, 0, st>>>(in, out, q, B, S); break;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
