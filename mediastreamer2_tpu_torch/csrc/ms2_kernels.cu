// Hand-written Hopper (sm_90a) kernels of the conference leg's echo
// canceller and volume stage.
//
// Built by ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
// Each entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() so that a refused launch is reported.
//
// -fmad=false: nvcc would otherwise contract a*b+c into one FMA, while
// eager PyTorch rounds the product and the sum separately. The plain
// versions in ops/kernels.py then agree with these kernels bit for bit,
// which the stochastic rounding of the echo canceller's shadow taps needs
// (one f32 ulp of difference before rounding can flip a bf16 ulp after).
//
// None of them has a matrix product in it: all are bound by device
// memory bandwidth. The [B, P, F] bf16 tap and history tensors of the echo
// canceller set the pace, so each kernel reads every such element once
// and writes only what changes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// fused_volume -- replaces fused_volume / _fused_volume_kernel
// (mediastreamer2_tpu/ops/pallas_kernels.py:38-84).
//
//   mean   = mean(x)
//   x'     = x - dc * dcen
//   y      = clip(x' * (g0 * (1 - i/S) + g1 * i/S), -1, 1)
//   energy = mean(x'^2)
//
// Bandwidth-bound: one read and one write of the [B, S] f32 block. At the
// session's shapes ([1024, 80], [1024, 160]: 0.7 and 1.3 MB) the launch and
// one memory round trip are nearly all of the time, so a leg takes a group
// of G lanes (8, 16 or 32, chosen from S so that a lane holds at most
// VOL_MAX_VEC 16-byte vectors) and a 128-thread block holds 128 / G legs. A
// lane issues all its float4 loads before it uses the first (rows of
// S % 4 == 0 floats are 16-byte aligned at every leg; a row that is not goes
// element by element). Both sums close with __shfl_xor_sync inside the
// group: no shared memory, no barrier. The lane that owns an element and the
// order of each sum depend only on S, never on B or on the leg's place in
// the batch.
// ---------------------------------------------------------------------------
#define VOL_BLOCK 128
#define VOL_MAX_VEC 4

static __device__ __forceinline__ float vol_elem(float v, int i, float off, float a,
                                                 float c, float fs, float& s, float& e)
{
    s += v;
    const float xv = v - off;
    const float ramp = (float)i / fs;
    const float g = a * (1.0f - ramp) + c * ramp;
    e += xv * xv;
    return fminf(fmaxf(xv * g, -1.0f), 1.0f);
}

template <int G>
__global__ void __launch_bounds__(VOL_BLOCK)
fused_volume_kernel(const float* __restrict__ x, const float* __restrict__ g0,
                    const float* __restrict__ g1, const float* __restrict__ dc,
                    const float* __restrict__ dcen, float* __restrict__ y,
                    float* __restrict__ energy, float* __restrict__ mean,
                    int B, int S, int vec)
{
    const int lane = threadIdx.x & (G - 1);
    const int b = blockIdx.x * (VOL_BLOCK / G) + threadIdx.x / G;
    const bool valid = b < B;          // a group past the batch joins the shuffles only
    const int bb = valid ? b : 0;
    const float* xr = x + (size_t)bb * S;
    float* yr = y + (size_t)bb * S;
    const float off = valid ? dc[bb] * dcen[bb] : 0.f;
    const float a = valid ? g0[bb] : 0.f;
    const float c = valid ? g1[bb] : 0.f;
    const float fs = (float)S;
    float s = 0.f, e = 0.f;
    if (valid && vec) {
        const float4* xv = reinterpret_cast<const float4*>(xr);
        float4* yv = reinterpret_cast<float4*>(yr);
        const int nv = S >> 2;
        // a lane's vectors all in flight before the first is used
        for (int j0 = lane; j0 < nv; j0 += VOL_MAX_VEC * G) {
            float4 v[VOL_MAX_VEC];
#pragma unroll
            for (int k = 0; k < VOL_MAX_VEC; ++k)
                if (j0 + k * G < nv) v[k] = xv[j0 + k * G];
#pragma unroll
            for (int k = 0; k < VOL_MAX_VEC; ++k) {
                const int j = j0 + k * G;
                if (j < nv) {
                    const int i = j << 2;
                    float4 o;
                    o.x = vol_elem(v[k].x, i, off, a, c, fs, s, e);
                    o.y = vol_elem(v[k].y, i + 1, off, a, c, fs, s, e);
                    o.z = vol_elem(v[k].z, i + 2, off, a, c, fs, s, e);
                    o.w = vol_elem(v[k].w, i + 3, off, a, c, fs, s, e);
                    yv[j] = o;
                }
            }
        }
    } else if (valid) {
        for (int i = lane; i < S; i += G)
            yr[i] = vol_elem(xr[i], i, off, a, c, fs, s, e);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        e += __shfl_xor_sync(0xffffffffu, e, o);
    }
    if (valid && lane == 0) {
        mean[b] = s / fs;
        energy[b] = e / fs;
    }
}

// ---------------------------------------------------------------------------
// mdf_apply -- replaces mdf_apply / _mdf_apply_kernel
// (mediastreamer2_tpu/ops/pallas_kernels.py:113-150), and the default
// path's history shift + variadic reduce (mediastreamer2_tpu/ops/aec.py:289-316).
//
// Shifts the far-end history in place (the new block, RNE-rounded to bf16,
// goes to p = 0; p = P-1 drops out) and applies both filters:
//   Ym = sum_p Wm_p * Xh_p,   Ys = sum_p Ws_p * Xh_p   (complex MACs)
// summed over p in order 0..P-1. The shadow taps Ws are bf16 (the default
// storage) or f32 (the f32-shadow modes, where the JAX package upcasts Wm
// and Xh exactly and runs the Pallas kernel on f32, ops/aec.py:258-267);
// TS is Ws's storage type. Wm and Xh are bf16 in both.
//
// Bandwidth-bound: reads Wm, Ws (Ws at 2 or 4 bytes) and Xh's partitions
// 0..P-2, writes all of Xh and the four [B, F] f32 sums. A block takes one
// leg, a thread a bin. The leg's contiguous [P, F] planes (P * F * 2 bytes,
// a multiple of 16 and 16-byte aligned at every leg when P * F % 8 == 0)
// come into shared memory by bulk asynchronous copies (cp.async.bulk, the
// TMA's copy engine) that one thread issues and an mbarrier counts: the
// block spends no instructions or registers on them, and every leg on an SM
// is in flight at once. Each history plane lands 2F bytes into its buffer,
// after the new block that the threads round into it meanwhile, so the
// buffer holds the shifted history: partition p of it is element p * F on.
// The threads store it back to Xh in 16-byte chunks (a shift by F elements
// is not 16-byte aligned, so a bulk copy could not move it), then each sums
// its bin over p in order 0..P-1 (the plain twin's order and, with
// -fmad=false, its roundings) from shared memory and writes the four sums.
// A leg's work does not depend on B or on its place in the batch. Planes
// that are not aligned are staged and stored element by element by the
// same kernel. Two legs a block, persistent blocks that load the next leg
// while they work on this one, and copies split in stages that the sums
// follow were all slower on the card (PERF.md, tools/volume_apply_variants.py).
// ---------------------------------------------------------------------------
#define MDF_MAX_P 16
#define MDF_MAX_THREADS 512
#define MDF_MAX_SMEM (227 * 1024)

static __device__ __forceinline__ float ld(const float* p) { return *p; }
static __device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }

static __host__ __device__ __forceinline__ size_t round16(size_t n) { return (n + 15) & ~(size_t)15; }

// the shifted history's buffer: `pad` bytes so that the old planes land
// 16-byte aligned after the F new elements, and 16 bytes for the copy's
// rounding
static __host__ __device__ __forceinline__ int hist_pad(int F) { return (16 - (2 * F) % 16) % 16; }
static __host__ __device__ __forceinline__ size_t hist_buf(int P, int F)
{
    return round16((size_t)hist_pad(F) + (size_t)P * F * 2 + 16);
}

static __device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                                 uint32_t bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

static __device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity)
{
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}

// a leg's shared memory: the mbarrier, Wm, Ws and the two shifted-history
// buffers
template <typename TS>
static __host__ __device__ __forceinline__ size_t mdf_smem_bytes(int P, int F)
{
    const size_t pf = (size_t)P * F;
    return 16 + 2 * round16(pf * 2) + 2 * round16(pf * sizeof(TS)) + 2 * hist_buf(P, F);
}

template <typename TS>
__global__ void __launch_bounds__(MDF_MAX_THREADS)
mdf_apply_kernel(const bf16* __restrict__ wm_r, const bf16* __restrict__ wm_i,
                 const TS* __restrict__ ws_r, const TS* __restrict__ ws_i,
                 bf16* __restrict__ xh_r, bf16* __restrict__ xh_i,
                 const float* __restrict__ x_r, const float* __restrict__ x_i,
                 float* __restrict__ ym_r, float* __restrict__ ym_i,
                 float* __restrict__ ys_r, float* __restrict__ ys_i,
                 int P, int F, int bulk)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    const int t = threadIdx.x, T = blockDim.x;
    const int pf = P * F;
    const size_t plane = (size_t)b * pf;
    const size_t wm_bytes = round16((size_t)pf * 2), ws_bytes = round16((size_t)pf * sizeof(TS));
    const uint32_t bar = smem_u32(smem);
    bf16* s_wm_r = reinterpret_cast<bf16*>(smem + 16);
    bf16* s_wm_i = reinterpret_cast<bf16*>(smem + 16 + wm_bytes);
    TS* s_ws_r = reinterpret_cast<TS*>(smem + 16 + 2 * wm_bytes);
    TS* s_ws_i = reinterpret_cast<TS*>(smem + 16 + 2 * wm_bytes + ws_bytes);
    unsigned char* h_base = smem + 16 + 2 * wm_bytes + 2 * ws_bytes;
    bf16* h_r = reinterpret_cast<bf16*>(h_base + hist_pad(F));   // partition p at p * F
    bf16* h_i = reinterpret_cast<bf16*>(h_base + hist_buf(P, F) + hist_pad(F));

    if (bulk && t == 0) {
        const uint32_t w = (uint32_t)pf * 2, v = (uint32_t)(pf * sizeof(TS));
        const uint32_t o = (uint32_t)round16((size_t)(P - 1) * F * 2);   // within the plane
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(bar), "r"(2 * w + 2 * v + 2 * o) : "memory");
        bulk_load(s_wm_r, wm_r + plane, w, bar);
        bulk_load(s_wm_i, wm_i + plane, w, bar);
        bulk_load(s_ws_r, ws_r + plane, v, bar);
        bulk_load(s_ws_i, ws_i + plane, v, bar);
        if (o) {
            bulk_load(h_r + F, xh_r + plane, o, bar);
            bulk_load(h_i + F, xh_i + plane, o, bar);
        }
    } else if (!bulk) {
        typedef unsigned short u16;
        const int ts = (int)(sizeof(TS) / 2);
        for (int i = t; i < pf; i += T) {
            ((u16*)s_wm_r)[i] = ((const u16*)(wm_r + plane))[i];
            ((u16*)s_wm_i)[i] = ((const u16*)(wm_i + plane))[i];
        }
        for (int i = t; i < pf * ts; i += T) {
            ((u16*)s_ws_r)[i] = ((const u16*)(ws_r + plane))[i];
            ((u16*)s_ws_i)[i] = ((const u16*)(ws_i + plane))[i];
        }
        for (int i = t; i < (P - 1) * F; i += T) {
            h_r[F + i] = xh_r[plane + i];
            h_i[F + i] = xh_i[plane + i];
        }
    }
    for (int f = t; f < F; f += T) {               // the new block: partition 0
        h_r[f] = __float2bfloat16_rn(x_r[(size_t)b * F + f]);
        h_i[f] = __float2bfloat16_rn(x_i[(size_t)b * F + f]);
    }
    __syncthreads();
    if (bulk)
        while (!mbar_try_wait(bar, 0)) {
        }

    // the shifted planes back to Xh, then the sums while the stores drain
    const unsigned short* h16_r = reinterpret_cast<const unsigned short*>(h_r);
    const unsigned short* h16_i = reinterpret_cast<const unsigned short*>(h_i);
    if (bulk) {
        uint4* d_r = reinterpret_cast<uint4*>(xh_r + plane);
        uint4* d_i = reinterpret_cast<uint4*>(xh_i + plane);
        for (int ch = t; ch < pf / 8; ch += T) {
            const unsigned short* sr = h16_r + 8 * ch;
            const unsigned short* si = h16_i + 8 * ch;
            uint4 vr, vi;
            vr.x = sr[0] | ((uint32_t)sr[1] << 16);
            vr.y = sr[2] | ((uint32_t)sr[3] << 16);
            vr.z = sr[4] | ((uint32_t)sr[5] << 16);
            vr.w = sr[6] | ((uint32_t)sr[7] << 16);
            vi.x = si[0] | ((uint32_t)si[1] << 16);
            vi.y = si[2] | ((uint32_t)si[3] << 16);
            vi.z = si[4] | ((uint32_t)si[5] << 16);
            vi.w = si[6] | ((uint32_t)si[7] << 16);
            d_r[ch] = vr;
            d_i[ch] = vi;
        }
    } else {
        unsigned short* d_r = reinterpret_cast<unsigned short*>(xh_r + plane);
        unsigned short* d_i = reinterpret_cast<unsigned short*>(xh_i + plane);
        for (int i = t; i < pf; i += T) {
            d_r[i] = h16_r[i];
            d_i[i] = h16_i[i];
        }
    }

    for (int f = t; f < F; f += T) {
        float amr = 0.f, ami = 0.f, asr = 0.f, asi = 0.f;
#pragma unroll 8
        for (int p = 0; p < P; ++p) {
            const int o = p * F + f;
            const float hr = __bfloat162float(h_r[o]);
            const float hi = __bfloat162float(h_i[o]);
            const float mr = __bfloat162float(s_wm_r[o]), mi = __bfloat162float(s_wm_i[o]);
            const float sr = ld(s_ws_r + o), si = ld(s_ws_i + o);
            amr = amr + (mr * hr - mi * hi);
            ami = ami + (mr * hi + mi * hr);
            asr = asr + (sr * hr - si * hi);
            asi = asi + (sr * hi + si * hr);
        }
        const size_t bf = (size_t)b * F + f;
        ym_r[bf] = amr;
        ym_i[bf] = ami;
        ys_r[bf] = asr;
        ys_i[bf] = asi;
    }
}

// ---------------------------------------------------------------------------
// mdf_update_fused -- replaces mdf_update_fused / _mdf_update_fused_kernel
// (mediastreamer2_tpu/ops/pallas_kernels.py:227-310).
//
// For each (b, p, f):
//   G   = conj(Xh) * E
//   up  = Ws + (p == cpos ? mu * gc : (mu * inv) * G)
// then, by the shadow's storage type:
//   f32 shadow (the Pallas kernel's semantics):
//     Wm' = promote ? rne_bf16(up) : Wm
//     Ws' = hard_reset ? 0 : (reseed ? Wm : up)
//   bf16 shadow (the JAX default branch, ops/aec.py:487-496, 520-528, 541-542):
//     Ws' = sround(hard_reset ? 0 : (reseed ? Wm : up), salt)
//       with salt 2*srk for re and 2*srk+1 for im and the hash of
//       ops/aec.py:142-152 over the linear (b, p, f) index plus lin0, the
//       index of element 0 in the whole batch (a shard's offset * P * F;
//       0 unsharded), mod 2^32: JAX hashes a sharded array's global iota
//     Wm' = promote ? Ws' : Wm       (the ROUNDED shadow value)
// Ws and Wm are updated in place; Wm is written only where promoted.
// cpos and srk arrive through device pointers (the Pallas kernel took cpos
// through SMEM), so the host never waits for the device to learn them.
//
// Bandwidth-bound, and what it must move depends on the leg. An ordinary
// leg reads Ws and Xh and its five [F] f32 operands and writes Ws: 14.5
// bytes an element at P = 8 with a bf16 shadow. In the bf16 mode a leg
// that hard-resets writes Ws' = +0 (sround(0) is +0 bit for bit) and one
// that reseeds Ws' = Wm (a bf16 value widened to f32 has 16 low zero bits,
// and the hash adds less than 2^16, so the rounding gives it back bit for
// bit): neither reads Ws, Xh or the operands. In the f32 mode a promoted
// leg needs `up` for Wm' whatever its other flags.
//
// A block takes one leg (every flag is uniform across it), its threads
// 16-byte chunks of UPD_N = 8 elements of the leg's contiguous P * F run of
// each plane (an f32 Ws chunk is two float4): a leg's planes start 16-byte
// aligned when P * F % 8 == 0 and the bases are. A thread issues the loads
// of its first K chunks (Ws, Xh, and Wm where the leg reads it) and of one
// bin's operands before it uses any, and works out the chunks'
// stochastic-rounding noise, which needs no tap, while they are in
// flight. It stages the leg's operands in shared memory -- stepw = mu *
// inv, con = mu * gc (the JAX association), E -- once a leg instead of
// once an element. The barrier waits for those loads alone, so in a block
// of more than four warps they go first and a warp then works as soon as
// its own taps are in; in a smaller block (the session's, 1,024 x 8 x 81)
// the taps go first, which measured faster there (PERF.md,
// tools/volume_apply_variants.py). A chunk's bins run from k0 % F without
// wrapping (the operands are staged for F + UPD_N bins), one 16-byte
// shared load an element; its stores are 16-byte chunks. A chunk that
// holds none of the constrained partition skips the per-element test.
// Planes that are not aligned go element by element through the same
// code. The hash's index is the element's place in the whole batch, so a
// leg's bits do not depend on the rows around it.
//
// K = 1, with 64 registers (two 512-thread blocks an SM), for the bf16
// shadow; the f32 shadow's chunks hold twice the registers, and its
// launcher takes K = 2 where a leg has over 256 chunks (fewer, fuller
// threads, faster at 4096 x 8 x 481) and K = 1 below. Four elements a
// chunk, several legs a block, two chunks a thread for the bf16 shadow,
// fewer resident blocks and operands read an element at a time from
// device memory were all slower on the card (PERF.md).
// ---------------------------------------------------------------------------
#define UPD_MAX_THREADS 512
#define UPD_N 8

// the stochastic rounding's hash (ops/aec.py:142-152): h = lin * C1 + salt * C2,
// mixed; the rounding adds its low 16 bits to the f32 bit pattern
#define SR_C1 2654435761u
#define SR_C2 0x9E3779B9u
static __device__ __forceinline__ uint32_t sr_noise(uint32_t h)
{
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    return h & 0xFFFFu;
}

// N consecutive elements of a plane as they sit in memory
template <int N> struct BfN { uint32_t w[N / 2]; };    // bf16 pairs, the lower element low
template <int N> struct FN { float v[N]; };
template <typename TS, int N> struct ChunkOf { typedef BfN<N> type; };
template <int N> struct ChunkOf<float, N> { typedef FN<N> type; };

template <int N> static __device__ __forceinline__ float el(const BfN<N>& c, int j)
{
    const uint32_t w = c.w[j >> 1];
    return __uint_as_float((j & 1) ? (w & 0xFFFF0000u) : (w << 16));
}
template <int N> static __device__ __forceinline__ float el(const FN<N>& c, int j) { return c.v[j]; }
template <int N> static __device__ __forceinline__ void put(FN<N>& c, int j, float x) { c.v[j] = x; }
template <int N> static __device__ __forceinline__ void zero(BfN<N>& c)
{
#pragma unroll
    for (int j = 0; j < N / 2; ++j) c.w[j] = 0u;
}
template <int N> static __device__ __forceinline__ void zero(FN<N>& c)
{
#pragma unroll
    for (int j = 0; j < N; ++j) c.v[j] = 0.f;
}

// n: the chunk's elements inside the plane (N but for the last chunk of an
// unaligned plane); vec: whole 16-byte accesses
template <int N>
static __device__ __forceinline__ void load(BfN<N>& c, const bf16* p, int n, bool vec)
{
    static_assert(N == 8, "a bf16 chunk is one 16-byte access");
    if (vec) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        c.w[0] = u.x; c.w[1] = u.y; c.w[2] = u.z; c.w[3] = u.w;
    } else {
        const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
        for (int j = 0; j < N / 2; ++j)
            c.w[j] = (2 * j < n ? (uint32_t)q[2 * j] : 0u)
                   | ((2 * j + 1 < n ? (uint32_t)q[2 * j + 1] : 0u) << 16);
    }
}
template <int N>
static __device__ __forceinline__ void load(FN<N>& c, const float* p, int n, bool vec)
{
    if (vec) {
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
            const float4 a = reinterpret_cast<const float4*>(p)[q];
            c.v[4 * q] = a.x; c.v[4 * q + 1] = a.y; c.v[4 * q + 2] = a.z; c.v[4 * q + 3] = a.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < N; ++j) c.v[j] = j < n ? p[j] : 0.f;
    }
}
template <int N>
static __device__ __forceinline__ void store(bf16* p, const BfN<N>& c, int n, bool vec)
{
    if (vec) {
        *reinterpret_cast<uint4*>(p) = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
    } else {
        unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
        for (int j = 0; j < N; ++j)
            if (j < n) q[j] = (unsigned short)(c.w[j >> 1] >> (16 * (j & 1)));
    }
}
template <int N>
static __device__ __forceinline__ void store(float* p, const FN<N>& c, int n, bool vec)
{
    if (vec) {
#pragma unroll
        for (int q = 0; q < N / 4; ++q)
            reinterpret_cast<float4*>(p)[q] =
                make_float4(c.v[4 * q], c.v[4 * q + 1], c.v[4 * q + 2], c.v[4 * q + 3]);
    } else {
#pragma unroll
        for (int j = 0; j < N; ++j)
            if (j < n) p[j] = c.v[j];
    }
}
// Ws' of a leg that needs no update: Wm as it is, or widened to f32
template <int N> static __device__ __forceinline__ void from_wm(BfN<N>& c, const BfN<N>& wm) { c = wm; }
template <int N> static __device__ __forceinline__ void from_wm(FN<N>& c, const BfN<N>& wm)
{
#pragma unroll
    for (int j = 0; j < N; ++j) c.v[j] = el(wm, j);
}

// A leg's bin operands in shared memory: a 16-byte record {stepw, E_r,
// E_i, con_r} and con_i a bin, for the F + UPD_N indices i of bin i % F,
// so that a chunk's bins f0 .. f0 + UPD_N - 1 never wrap. Index i sits at
// slot i + i / 8: the 8 lanes of a quarter warp read bins 8 apart, which
// then fall on 8 different 16-byte bank groups.
static __host__ __device__ __forceinline__ int upd_slot(int i) { return i + (i >> 3); }
static __host__ __device__ __forceinline__ int upd_slots(int F) { return upd_slot(F + UPD_N) + 1; }
static __host__ __device__ __forceinline__ size_t upd_smem(int F)
{
    return round16((size_t)upd_slots(F) * (sizeof(float4) + sizeof(float)));
}

// The stochastic rounding's noise of a chunk's N elements, from the hash of
// the first one, h0 = lin * C1 + salt * C2: the real part's in the low 16
// bits and the imaginary part's (salt + 1) in the high 16. It needs no tap,
// so it is worked out while the taps are in flight.
template <int N>
static __device__ __forceinline__ void chunk_noise(uint32_t h0, uint32_t (&nz)[N])
{
#pragma unroll
    for (int j = 0; j < N; ++j) {
        const uint32_t h = h0 + (uint32_t)j * SR_C1;
        nz[j] = sr_noise(h) | (sr_noise(h + SR_C2) << 16);
    }
}

// One chunk's update from its loaded taps, the leg's staged operands and
// (bf16 mode) its noise: Ws' (and, in the f32 mode, Wm' = rne(up)) of its
// N elements, bins f0 on, element j in the constrained partition iff
// 0 <= dc + j < F.
template <bool SROUND, typename CS, typename CB, int N>
static __device__ __forceinline__ void update_chunk(
    const CS& wr, const CS& wi, const CB& hr, const CB& hi, const CB& mr, const CB& mi,
    const uint32_t (&nz)[N], const float4* s_rec, const float* s_ci, int f0, int dc, int F,
    bool rs, bool hz, CS& nr, CS& ni, CB& qr, CB& qi)
{
    const bool any_c = (unsigned)(dc + N - 1) < (unsigned)(F + N - 1);
#pragma unroll
    for (int j = 0; j < N; j += 2) {
        float ur[2], ui[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int sl = upd_slot(f0 + j + e);
            const float4 r = s_rec[sl];
            const float xr = el(hr, j + e), xi = el(hi, j + e);
            const float gr = xr * r.y + xi * r.z;
            const float gi = xr * r.z - xi * r.y;
            float dr = r.x * gr, di = r.x * gi;
            if (any_c && (unsigned)(dc + j + e) < (unsigned)F) {
                dr = r.w;
                di = s_ci[sl];
            }
            ur[e] = el(wr, j + e) + dr;
            ui[e] = el(wi, j + e) + di;
        }
        if constexpr (SROUND) {
            const uint32_t r0 = __float_as_uint(ur[0]) + (nz[j] & 0xFFFFu);
            const uint32_t r1 = __float_as_uint(ur[1]) + (nz[j + 1] & 0xFFFFu);
            const uint32_t i0 = __float_as_uint(ui[0]) + (nz[j] >> 16);
            const uint32_t i1 = __float_as_uint(ui[1]) + (nz[j + 1] >> 16);
            nr.w[j >> 1] = __byte_perm(r0, r1, 0x7632);        // the two upper halves
            ni.w[j >> 1] = __byte_perm(i0, i1, 0x7632);
        } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                put(nr, j + e, hz ? 0.f : (rs ? el(mr, j + e) : ur[e]));
                put(ni, j + e, hz ? 0.f : (rs ? el(mi, j + e) : ui[e]));
            }
            qr.w[j >> 1] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(ur[0]))
                         | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(ur[1])) << 16);
            qi.w[j >> 1] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(ui[0]))
                         | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(ui[1])) << 16);
        }
    }
}

template <typename TS, bool SROUND, int K>
__global__ void __launch_bounds__(UPD_MAX_THREADS, SROUND ? 2 : 1)
mdf_update_fused_kernel(const int* __restrict__ cpos_p,
                        TS* __restrict__ ws_r, TS* __restrict__ ws_i,
                        bf16* __restrict__ wm_r, bf16* __restrict__ wm_i,
                        const bf16* __restrict__ xh_r, const bf16* __restrict__ xh_i,
                        const float* __restrict__ e_r, const float* __restrict__ e_i,
                        const float* __restrict__ inv_norm,
                        const float* __restrict__ gc_r, const float* __restrict__ gc_i,
                        const float* __restrict__ mu,
                        const uint8_t* __restrict__ promote,
                        const uint8_t* __restrict__ reseed,
                        const uint8_t* __restrict__ hard_reset,
                        const long long* __restrict__ srk_p, uint32_t lin0,
                        int P, int F, int vec)
{
    constexpr int N = UPD_N;
    typedef typename ChunkOf<TS, N>::type CS;
    typedef BfN<N> CB;
    extern __shared__ float s_op[];
    const int b = blockIdx.x;
    const int t = threadIdx.x, T = blockDim.x;
    const int pf = P * F;
    const int nch = (pf + N - 1) / N;
    const size_t plane = (size_t)b * pf;
    const bool pr = promote[b] != 0, rs = reseed[b] != 0, hz = hard_reset[b] != 0;
    const bool need_up = SROUND ? !(rs || hz) : (!(rs || hz) || pr);
    const bool read_wm = rs && !hz;

    if (!need_up) {                     // Ws' = +0 or Wm; Wm' = Ws' where promoted (bf16)
        for (int c = t; c < nch; c += T) {
            const int k = N * c, n = min(N, pf - k);
            CS nr, ni;
            CB mr, mi;
            if (hz) {
                zero(nr);
                zero(ni);
            } else {
                load(mr, wm_r + plane + k, n, vec);
                load(mi, wm_i + plane + k, n, vec);
                from_wm(nr, mr);
                from_wm(ni, mi);
            }
            store(ws_r + plane + k, nr, n, vec);
            store(ws_i + plane + k, ni, n, vec);
            if constexpr (SROUND) {
                if (pr) {
                    store(wm_r + plane + k, nr, n, vec);
                    store(wm_i + plane + k, ni, n, vec);
                }
            }
        }
        return;
    }

    // the thread's first K chunks and one bin's operands: all their loads
    // in flight before any is used, the operands first in a block of more
    // than four warps (the barrier waits for them alone)
    const size_t row = (size_t)b * F;
    const float m = mu[b];
    float inv = 0.f, er = 0.f, ei = 0.f, gr = 0.f, gi = 0.f;   // bin t % F's, as loaded
    auto load_bin = [&](int i) {
        const size_t f = row + (i < F ? i : i % F);
        inv = inv_norm[f];
        er = e_r[f];
        ei = e_i[f];
        gr = gc_r[f];
        gi = gc_i[f];
    };
    if (T > 128 && t < F + N)
        load_bin(t);
    CS wr[K], wi[K];
    CB hr[K], hi[K], mr[K], mi[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
        const int c = t + q * T;
        if (c < nch) {
            const int k = N * c, n = min(N, pf - k);
            load(wr[q], ws_r + plane + k, n, vec);
            load(wi[q], ws_i + plane + k, n, vec);
            load(hr[q], xh_r + plane + k, n, vec);
            load(hi[q], xh_i + plane + k, n, vec);
            if (!SROUND && read_wm) {
                load(mr[q], wm_r + plane + k, n, vec);
                load(mi[q], wm_i + plane + k, n, vec);
            }
        }
    }
    if (T <= 128 && t < F + N)
        load_bin(t);
    const int cbase = *cpos_p * F;      // the constrained partition's elements
    uint32_t salt = 0u;
    if constexpr (SROUND)
        salt = (uint32_t)(unsigned long long)(*srk_p) * 2u;
    const uint32_t lin_b = lin0 + (uint32_t)plane;      // wraps as JAX's uint32 iota
    uint32_t nz[K][N];
    if constexpr (SROUND) {
#pragma unroll
        for (int q = 0; q < K; ++q)
            chunk_noise((lin_b + (uint32_t)(N * (t + q * T))) * SR_C1 + salt * SR_C2, nz[q]);
    }
    float4* s_rec = reinterpret_cast<float4*>(s_op);
    float* s_ci = s_op + 4 * upd_slots(F);
    for (int i = t; i < F + N; i += T) {       // stepw = mu * inv, con = mu * gc
        if (i != t)
            load_bin(i);
        s_rec[upd_slot(i)] = make_float4(m * inv, er, ei, m * gr);
        s_ci[upd_slot(i)] = m * gi;
    }
    __syncthreads();

    // a chunk's update and stores
    auto finish = [&](int c, const CS& cwr, const CS& cwi, const CB& chr, const CB& chi,
                      const CB& cmr, const CB& cmi, const uint32_t (&cnz)[N]) {
        const int k0 = N * c, n = min(N, pf - k0);
        CS nr, ni;
        CB qr, qi;                      // Wm' (f32 mode: rne(up))
        update_chunk<SROUND>(cwr, cwi, chr, chi, cmr, cmi, cnz, s_rec, s_ci, k0 % F,
                             k0 - cbase, F, rs, hz, nr, ni, qr, qi);
        store(ws_r + plane + k0, nr, n, vec);
        store(ws_i + plane + k0, ni, n, vec);
        if (pr) {
            if constexpr (SROUND) {
                store(wm_r + plane + k0, nr, n, vec);
                store(wm_i + plane + k0, ni, n, vec);
            } else {
                store(wm_r + plane + k0, qr, n, vec);
                store(wm_i + plane + k0, qi, n, vec);
            }
        }
    };
#pragma unroll
    for (int q = 0; q < K; ++q)
        if (t + q * T < nch)
            finish(t + q * T, wr[q], wi[q], hr[q], hi[q], mr[q], mi[q], nz[q]);
    for (int c = t + K * T; c < nch; c += T) {
        const int k = N * c, n = min(N, pf - k);
        CS cwr, cwi;
        CB chr, chi, cmr, cmi;
        load(cwr, ws_r + plane + k, n, vec);
        load(cwi, ws_i + plane + k, n, vec);
        load(chr, xh_r + plane + k, n, vec);
        load(chi, xh_i + plane + k, n, vec);
        if (!SROUND && read_wm) {
            load(cmr, wm_r + plane + k, n, vec);
            load(cmi, wm_i + plane + k, n, vec);
        }
        uint32_t cnz[N];
        if constexpr (SROUND)
            chunk_noise((lin_b + (uint32_t)k) * SR_C1 + salt * SR_C2, cnz);
        finish(c, cwr, cwi, chr, chi, cmr, cmi, cnz);
    }
}

// ---------------------------------------------------------------------------
// mdf_update -- replaces mdf_update / _mdf_update_kernel
// (mediastreamer2_tpu/ops/pallas_kernels.py:153-201), the megakernel
// configuration's update (PALLAS_MDF=1, ops/aec.py:440-446).
//
// For each (b, p, f), in the Pallas kernel's arithmetic:
//   g   = (p == cpos) ? gc : (Re/Im of conj(Xh) * E) * inv
//   up  = Ws + mu * g
//   Wm' = rne_bf16(pr * up + (1 - pr) * Wm)
//   Ws' = rs * Wm + (1 - rs) * up          (the OLD Wm)
// with promote pr and reseed rs as 0/1 floats. The transfers are
// arithmetic blends, not selects, as on the TPU: a non-finite `up` reaches
// Wm on a leg that is not promoted (0 * inf = NaN) exactly as it does there.
// The gradient is scaled by inv before the multiply by mu, unlike
// mdf_update_fused's (mu * inv) * G; with -fmad=false each product and sum
// rounds on its own, as in the plain version. Wm is bf16 in storage and
// read exactly; the JAX package carries it as f32 through the kernel and
// rounds the result to bf16 with RNE (ops/aec.py:445-446), which the store
// here does. No hard reset: the caller zeroes Ws after, as aec.py:543-546.
//
// Ws (f32) and Wm (bf16) are updated in place; each thread reads its
// element of both before it writes either. cpos arrives through a device
// pointer (SMEM scalar on the TPU). One thread per element, neighbouring
// threads on neighbouring f. Bandwidth-bound: reads Ws (f32), Wm, Xh, writes
// Ws and Wm -- every [B, P, F] byte of the update once.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
mdf_update_kernel(const int* __restrict__ cpos_p,
                  float* __restrict__ ws_r, float* __restrict__ ws_i,
                  bf16* __restrict__ wm_r, bf16* __restrict__ wm_i,
                  const bf16* __restrict__ xh_r, const bf16* __restrict__ xh_i,
                  const float* __restrict__ e_r, const float* __restrict__ e_i,
                  const float* __restrict__ inv_norm,
                  const float* __restrict__ gc_r, const float* __restrict__ gc_i,
                  const float* __restrict__ mu,
                  const float* __restrict__ promote,
                  const float* __restrict__ reseed,
                  int B, int P, int F)
{
    const size_t n = (size_t)B * P * F;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    const int pf = P * F;
    const int b = (int)(idx / pf);
    const int rem = (int)(idx - (size_t)b * pf);
    const int p = rem / F;
    const int bf = b * F + (rem - p * F);

    float gr, gi;
    if (p == *cpos_p) {
        gr = gc_r[bf];
        gi = gc_i[bf];
    } else {
        const float hr = __bfloat162float(xh_r[idx]);
        const float hi = __bfloat162float(xh_i[idx]);
        const float er = e_r[bf], ei = e_i[bf];
        const float inv = inv_norm[bf];
        gr = (hr * er + hi * ei) * inv;
        gi = (hr * ei - hi * er) * inv;
    }
    const float m = mu[b];
    const float up_r = ws_r[idx] + m * gr;
    const float up_i = ws_i[idx] + m * gi;
    const float wmr = __bfloat162float(wm_r[idx]);
    const float wmi = __bfloat162float(wm_i[idx]);
    const float pr = promote[b], rs = reseed[b];
    const float npr = 1.0f - pr, nrs = 1.0f - rs;
    wm_r[idx] = __float2bfloat16_rn(pr * up_r + npr * wmr);
    wm_i[idx] = __float2bfloat16_rn(pr * up_i + npr * wmi);
    ws_r[idx] = rs * wmr + nrs * up_r;
    ws_i[idx] = rs * wmi + nrs * up_i;
}

// mdf_apply's launch: a block a leg, a thread a bin (in warps), the shared
// memory the leg's planes need.
template <typename TS>
static int launch_mdf_apply(int device, const void* const* p, int B, int P, int F,
                            cudaStream_t st)
{
    const size_t smem = mdf_smem_bytes<TS>(P, F);
    if (P < 1 || P > MDF_MAX_P || smem > MDF_MAX_SMEM) return (int)cudaErrorInvalidValue;
    static bool raised[64];             // the shared-memory ceiling, once a device
    if (smem > 48 * 1024 && (device >= 64 || !raised[device])) {
        cudaError_t err = cudaFuncSetAttribute(mdf_apply_kernel<TS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               MDF_MAX_SMEM);
        if (err != cudaSuccess) return (int)err;
        if (device < 64) raised[device] = true;
    }
    int bulk = (size_t)P * F % 8 == 0;  // every leg's planes 16-byte aligned
    for (int i = 0; i < 6; ++i)
        bulk = bulk && ((uintptr_t)p[i] % 16) == 0;
    const int threads = F >= MDF_MAX_THREADS ? MDF_MAX_THREADS : (F + 31) / 32 * 32;
    mdf_apply_kernel<TS><<<B, threads, smem, st>>>(
        (const bf16*)p[0], (const bf16*)p[1], (const TS*)p[2], (const TS*)p[3],
        (bf16*)p[4], (bf16*)p[5], (const float*)p[6], (const float*)p[7],
        (float*)p[8], (float*)p[9], (float*)p[10], (float*)p[11], P, F, bulk);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// suppress_gain -- the echo canceller's residual-echo suppressor gain
// (ops/aec.py's suppress stage), applied to the error spectrum: per bin
//
//   |E| = sqrt(er^2 + ei^2 + 1e-18), |Y| likewise
//   g   = clamp((|E| - beta sqrt(leak) |Y|) / (|E| + 1e-9), floor, 1)
//   out = (er g, ei g)
//
// Some twenty PyTorch passes over [B, F] in one, a thread a bin; each
// operation rounds as PyTorch's does (-fmad=false).
//   in:  er, ei, yr, yi [B, F], leak [B];  out: [2, B, F] (re, im), B * F < 2^31
// ---------------------------------------------------------------------------
#define SUPPRESS_THREADS 256

__global__ void suppress_gain_kernel(const float* __restrict__ er, const float* __restrict__ ei,
                                     const float* __restrict__ yr, const float* __restrict__ yi,
                                     const float* __restrict__ leak, float* __restrict__ out,
                                     unsigned total, unsigned F, float beta, float floor_gain)
{
    const unsigned i = blockIdx.x * SUPPRESS_THREADS + threadIdx.x;
    if (i >= total) return;
    const float a = er[i], b = ei[i], c = yr[i], d = yi[i];
    const float mag_e = sqrtf(a * a + b * b + 1e-18f);
    const float mag_y = sqrtf(c * c + d * d + 1e-18f);
    const float resid = sqrtf(leak[i / F]) * mag_y;
    float g = (mag_e - beta * resid) / (mag_e + 1e-9f);
    g = g != g ? g : fminf(fmaxf(g, floor_gain), 1.0f);        // torch.clamp keeps a NaN
    out[i] = a * g;
    out[total + i] = b * g;
}

// ---------------------------------------------------------------------------
// aec_decide -- the echo canceller's time-domain passes and per-leg
// two-path decisions (ops/aec.py's adapt and suppress stages; the plain
// twin, kernels.aec_decide_reference, is the PyTorch code it replaces:
// some ninety [B, S] and [B] operations a tick). For each leg, with
// m(x) = sum_i x_i / S over the leg's S samples and c the thresholds that
// ops/aec.py names (DecConsts, passed in at every launch):
//
//   e_m = near - y_m,  e_s = near - y_s
//   Em, Es, Dn  = err_ewma old + err_new m(e_m^2), m(e_s^2), m(near^2)
//   Nf, the promote / reseed / divergence counters, promote, reseed,
//   hard_reset; then Em = promote ? Es : Em, Es = reseed ? Em : Es,
//   Es = hard_reset ? Dn : Es (the selects after the update)
//   e, y  = the promoted path's (e_s, y_s) or main's (e_m, y_m), blended
//           toward the mic by w = clamp(m(e^2) / (limit m(near^2) + eps)
//           - 1, 0, 1): e = (1 - w) e + w near, y = (1 - w) y; e = near
//           where the leg is disabled
//   leak  = clamp(min(leak * rise, m(e^2) / (m(y^2) + eps)), leak_floor, 1),
//           rise = leak_rise where Dn < leak_gate m(y^2), else 1
//           (suppressor on)
//
// Bandwidth-bound: near, y_m and y_s read once (y_m and y_s are the last
// halves of the overlap-save rows, read at their row stride), e_s, e and
// y written once: 24 bytes a sample with the suppressor, 20 without (no
// y). As fused_volume, a leg takes a group of G lanes (8, 16 or 32, from
// S) and a 128-thread block 128 / G legs. A chunk of a row is DEC_LANE
// samples a lane (four float4 on rows whose samples are 16-byte aligned,
// else sample by sample), all loads issued before the first use. A row
// of one chunk (S <= 512) stays in registers through both passes; a
// longer row (LONG, 32 lanes) is read chunk by chunk in each pass, near
// and the selected path's y again in the second. The first pass writes
// e_s and sums near^2, e_m^2, e_s^2; the second, once the decisions are
// known, writes e and y and sums e^2 and y^2. A lane adds its samples in
// chunk order; a sum closes with __shfl_xor_sync inside the group, so
// every lane of it holds the same bits (each step adds a + b on one lane
// and b + a on the other) and works out the leg's decisions itself; lane
// 0 writes the [B] rows. The selected error's m(e^2) is the sum of the
// first pass (the same samples in the same order). The lane that owns a
// sample and the order of each sum depend only on S, never on B or on the
// leg's place in the batch. Every operation rounds as PyTorch's does
// (-fmad=false); torch.minimum and torch.clamp keep a NaN, and so do tmin
// and clamp_nan here.
// ---------------------------------------------------------------------------
#define DEC_BLOCK 128
#define DEC_LANE 16                   // samples of each row a lane holds in a chunk

// ops/aec.py's thresholds in kernels.DecideConsts' order; the wrapper
// hands them in as DEC_NCONST floats (hold and diverge_hold whole ticks)
struct DecConsts {
    float err_ewma, err_new, copy_ratio, erle_gate, reset_ratio, nf_creep, nf_active,
        floor_ratio, main_gate, active_pow, diverge_ratio, blowup_ratio, limit_ratio,
        leak_rise, leak_gate, leak_floor, eps;
    int hold, diverge_hold;
};
#define DEC_NCONST 19

static __device__ __forceinline__ float tmin(float a, float b)
{
    return a != a ? a : (b != b ? b : fminf(a, b));
}
static __device__ __forceinline__ float clamp_nan(float x, float lo, float hi)
{
    return x != x ? x : fminf(fmaxf(x, lo), hi);
}

struct DecArgs {
    const float *near, *y_m, *y_s;          // [B, S] rows at their strides
    const float *em, *es, *dn, *nf;         // [B] state rows
    const int *pc, *rc, *dc;
    const float* leak;
    const uint8_t* enabled;
    float *e_s, *e, *y;                     // [B, S]; y null without the suppressor
    float* rows;                            // [8, B]: Em Es Dn Nf pc rc dc (int32) leak
    uint8_t* flags;                         // [3, B]: promote, reseed, hard_reset
};

// a lane's samples k = 0 .. DEC_LANE - 1 of a chunk: VEC, element k % 4 of
// the lane's float4 k / 4 (vector lane + (k / 4) G of the chunk); else
// sample lane + k G
template <int G, bool VEC>
static __device__ __forceinline__ void dec_load(const float* row, int lane, int nk,
                                                float (&v)[DEC_LANE])
{
#pragma unroll
    for (int u = 0; u < DEC_LANE / 4; ++u) {
        if (VEC) {
            if (4 * u < nk) {
                const float4 a = reinterpret_cast<const float4*>(row)[lane + u * G];
                v[4 * u] = a.x; v[4 * u + 1] = a.y; v[4 * u + 2] = a.z; v[4 * u + 3] = a.w;
            }
        } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
                if (4 * u + c < nk) v[4 * u + c] = row[lane + (4 * u + c) * G];
        }
    }
}

template <int G, bool VEC>
static __device__ __forceinline__ void dec_store(float* row, int lane, int nk,
                                                 const float (&v)[DEC_LANE])
{
#pragma unroll
    for (int u = 0; u < DEC_LANE / 4; ++u) {
        if (VEC) {
            if (4 * u < nk)
                reinterpret_cast<float4*>(row)[lane + u * G] =
                    make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
        } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
                if (4 * u + c < nk) row[lane + (4 * u + c) * G] = v[4 * u + c];
        }
    }
}

template <int G>
static __device__ __forceinline__ float group_sum(float s)
{
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

template <int G, bool VEC, bool LONG>
__global__ void __launch_bounds__(DEC_BLOCK)
aec_decide_kernel(DecArgs a, DecConsts c, long long ld_n, long long ld_m, long long ld_s,
                  int B, int S)
{
    const int lane = threadIdx.x & (G - 1);
    const int b = blockIdx.x * (DEC_BLOCK / G) + threadIdx.x / G;
    const bool valid = b < B;          // a group past the batch joins the shuffles only
    const int bb = valid ? b : 0;
    const float* nrow = a.near + bb * ld_n;
    const float* mrow = a.y_m + bb * ld_m;
    const float* srow = a.y_s + bb * ld_s;
    const size_t out = (size_t)bb * S;
    // a chunk's units (float4 or samples) and the chunks of the row
    const int units = VEC ? S >> 2 : S;
    const int cu = G * (VEC ? DEC_LANE / 4 : DEC_LANE);
    const int nch = LONG ? (units + cu - 1) / cu : 1;
    // the lane's samples of chunk ch: a prefix of k = 0 .. DEC_LANE - 1
    auto lane_nk = [&](int ch) {
        const int u = min(units - ch * cu, cu);
        const int k = valid && lane < u ? (u - lane + G - 1) / G : 0;
        return VEC ? 4 * k : k;
    };
    float n[DEC_LANE], ym[DEC_LANE], ys[DEC_LANE], o[DEC_LANE];
    float em0 = 0.f, es0 = 0.f, dn0 = 0.f, nf0 = 0.f, leak0 = 0.f;
    int pc0 = 0, rc0 = 0, dc0 = 0;
    bool en = false;

    // first pass: e_s out, the three mean squares' sums
    float snn = 0.f, smm = 0.f, sss = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
        const int nk = lane_nk(ch);
        const size_t off = (size_t)ch * G * DEC_LANE;
        dec_load<G, VEC>(nrow + off, lane, nk, n);
        dec_load<G, VEC>(mrow + off, lane, nk, ym);
        dec_load<G, VEC>(srow + off, lane, nk, ys);
        if (ch == 0 && valid) {
            em0 = a.em[bb]; es0 = a.es[bb]; dn0 = a.dn[bb]; nf0 = a.nf[bb];
            leak0 = a.leak[bb];
            pc0 = a.pc[bb]; rc0 = a.rc[bb]; dc0 = a.dc[bb];
            en = a.enabled[bb] != 0;
        }
#pragma unroll
        for (int k = 0; k < DEC_LANE; ++k) {
            if (k < nk) {
                const float em = n[k] - ym[k], es = n[k] - ys[k];
                snn += n[k] * n[k];
                smm += em * em;
                sss += es * es;
                o[k] = es;
            }
        }
        dec_store<G, VEC>(a.e_s + out + off, lane, nk, o);
    }
    snn = group_sum<G>(snn);
    smm = group_sum<G>(smm);
    sss = group_sum<G>(sss);

    // the leg's decisions, on every lane of its group
    const float fs = (float)S;
    const float near_pow = snn / fs;
    const float Em = c.err_ewma * em0 + c.err_new * (smm / fs);
    const float Es = c.err_ewma * es0 + c.err_new * (sss / fs);
    const float Dn = c.err_ewma * dn0 + c.err_new * near_pow;
    const float Nf = Dn > c.nf_active ? tmin(nf0 * c.nf_creep, Es) : nf0;
    const bool at_floor = Es < c.floor_ratio * Nf;
    const bool better = (Es < c.copy_ratio * Em) && ((Es < c.erle_gate * Dn) || at_floor);
    const bool worse = (Es > c.reset_ratio * Em) && (Em < c.main_gate * Dn);
    int pc = better ? pc0 + 1 : 0, rc = worse ? rc0 + 1 : 0;
    bool promote = pc >= c.hold;
    const bool reseed = rc >= c.hold;
    if (promote) pc = 0;
    if (reseed) rc = 0;
    const bool active = Dn > c.active_pow;
    const bool diverged =
        ((tmin(Em, Es) > c.diverge_ratio * Dn) || (Es > c.blowup_ratio * Dn)) && active;
    int dc = diverged ? dc0 + 1 : (active ? max(dc0 - 1, 0) : dc0);
    const bool hard = dc >= c.diverge_hold;
    if (hard) dc = 0;
    promote = promote && !hard;
    const float em_out = promote ? Es : Em;
    const float es_out = hard ? Dn : (reseed ? em_out : Es);

    // second pass: the output limiter, the enable select, e and y out
    const float blk_err = (promote ? sss : smm) / fs;
    const float w = clamp_nan(blk_err / (c.limit_ratio * near_pow + c.eps) - 1.0f, 0.0f, 1.0f);
    const float omw = 1.0f - w;
    float see = 0.f, syy = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
        const int nk = lane_nk(ch);
        const size_t off = (size_t)ch * G * DEC_LANE;
        if (LONG) {
            dec_load<G, VEC>(nrow + off, lane, nk, n);
            dec_load<G, VEC>((promote ? srow : mrow) + off, lane, nk, ym);
        } else {
#pragma unroll
            for (int k = 0; k < DEC_LANE; ++k)
                ym[k] = promote ? ys[k] : ym[k];
        }
#pragma unroll
        for (int k = 0; k < DEC_LANE; ++k) {
            if (k < nk) {
                const float es = n[k] - ym[k];
                const float yv = omw * ym[k];
                const float ev = en ? omw * es + w * n[k] : n[k];
                see += ev * ev;
                syy += yv * yv;
                o[k] = ev;
                ym[k] = yv;
            }
        }
        dec_store<G, VEC>(a.e + out + off, lane, nk, o);
        if (a.y) dec_store<G, VEC>(a.y + out + off, lane, nk, ym);
    }
    float leak = leak0;
    if (a.y) {
        see = group_sum<G>(see);
        syy = group_sum<G>(syy);
        const float Ey = syy / fs;
        const float inst_leak = (see / fs) / (Ey + c.eps);
        const float rise = Dn < c.leak_gate * Ey ? c.leak_rise : 1.0f;
        leak = clamp_nan(tmin(leak0 * rise, inst_leak), c.leak_floor, 1.0f);
    }
    if (valid && lane == 0) {
        float* r = a.rows;
        int* ri = reinterpret_cast<int*>(a.rows);
        r[b] = em_out;
        r[B + b] = es_out;
        r[2 * B + b] = Dn;
        r[3 * B + b] = Nf;
        ri[4 * B + b] = pc;
        ri[5 * B + b] = rc;
        ri[6 * B + b] = dc;
        if (a.y) r[7 * B + b] = leak;
        a.flags[b] = promote;
        a.flags[B + b] = reseed;
        a.flags[2 * B + b] = hard;
    }
}

// ---------------------------------------------------------------------------
// The FFT path's layout passes (ops/rfft.py). cuFFT reads and writes
// interleaved complex spectra; the echo canceller's kernels and its
// pointwise code take (re, im) planes. One pass each way reads and writes
// each element once, and the per-bin factors ride along:
//
//   spectrum_planes: z [rows, F] complex -> re, im [rows, F]
//       (re, im) = z, times (-1)^k with `alternate` (the spectrum of a
//       block shifted by n/2 samples)
//   planes_spectrum: re, im [rows, F] -> z [rows, F] complex
//       z = (scale re, scale im), the imaginary part 0 at k = 0 and, with
//       `zero_last`, at k = F - 1 (DC and Nyquist, which a complex-to-real
//       transform of a real signal's spectrum must not see); scale = 1/n
//       for a transform that runs unnormalised
//
// A thread an element, rows * F < 2^31 (the wrapper checks).
// ---------------------------------------------------------------------------
#define LAYOUT_THREADS 256

__global__ void spectrum_planes_kernel(const float2* __restrict__ z, float* __restrict__ re,
                                       float* __restrict__ im, unsigned total, unsigned F,
                                       int alternate)
{
    const unsigned i = blockIdx.x * LAYOUT_THREADS + threadIdx.x;
    if (i >= total) return;
    const float2 v = z[i];
    const bool flip = alternate && ((i % F) & 1u);
    re[i] = flip ? -v.x : v.x;
    im[i] = flip ? -v.y : v.y;
}

__global__ void planes_spectrum_kernel(const float* __restrict__ re,
                                       const float* __restrict__ im, float2* __restrict__ z,
                                       unsigned total, unsigned F, float scale, int zero_last)
{
    const unsigned i = blockIdx.x * LAYOUT_THREADS + threadIdx.x;
    if (i >= total) return;
    const unsigned k = i % F;
    const bool real_bin = k == 0 || (zero_last && k == F - 1);
    z[i] = make_float2(re[i] * scale, real_bin ? 0.0f : im[i] * scale);
}

// ---------------------------------------------------------------------------
// C entry points. Every pointer is a device pointer; `stream` is a
// cudaStream_t of `device`.
// ---------------------------------------------------------------------------
extern "C" {

int ms2_fused_volume(int device, const void* x, const void* g0, const void* g1,
                     const void* dc, const void* dcen, void* y, void* energy,
                     void* mean, int B, int S, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B <= 0) return (int)cudaGetLastError();
    // float4 rows when every row is 16-byte aligned; the lanes a leg from
    // the row's vectors (at most four a lane)
    const int vec = S % 4 == 0 && ((uintptr_t)x % 16) == 0 && ((uintptr_t)y % 16) == 0;
    const int units = vec ? S / 4 : S;
    const int G = units <= 8 * VOL_MAX_VEC ? 8 : (units <= 16 * VOL_MAX_VEC ? 16 : 32);
    const unsigned blocks = (unsigned)((B + VOL_BLOCK / G - 1) / (VOL_BLOCK / G));
    cudaStream_t st = (cudaStream_t)stream;
#define VOL_LAUNCH(g) fused_volume_kernel<g><<<blocks, VOL_BLOCK, 0, st>>>( \
        (const float*)x, (const float*)g0, (const float*)g1, (const float*)dc, \
        (const float*)dcen, (float*)y, (float*)energy, (float*)mean, B, S, vec)
    if (G == 8) VOL_LAUNCH(8);
    else if (G == 16) VOL_LAUNCH(16);
    else VOL_LAUNCH(32);
#undef VOL_LAUNCH
    return (int)cudaGetLastError();
}

int ms2_mdf_apply(int device, int shadow_f32, const void* wm_r, const void* wm_i,
                  const void* ws_r, const void* ws_i, void* xh_r, void* xh_i,
                  const void* x_r, const void* x_i, void* ym_r, void* ym_i,
                  void* ys_r, void* ys_i, int B, int P, int F, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B == 0 || F == 0) return (int)cudaGetLastError();
    const void* p[12] = {wm_r, wm_i, ws_r, ws_i, xh_r, xh_i, x_r, x_i, ym_r, ym_i, ys_r, ys_i};
    cudaStream_t st = (cudaStream_t)stream;
    return shadow_f32 ? launch_mdf_apply<float>(device, p, B, P, F, st)
                      : launch_mdf_apply<bf16>(device, p, B, P, F, st);
}

int ms2_mdf_update(int device, const void* cpos, void* ws_r, void* ws_i,
                   void* wm_r, void* wm_i, const void* xh_r, const void* xh_i,
                   const void* e_r, const void* e_i, const void* inv_norm,
                   const void* gc_r, const void* gc_i, const void* mu,
                   const void* promote, const void* reseed,
                   int B, int P, int F, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const size_t n = (size_t)B * P * F;
    if (n > 0)
        mdf_update_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
            (const int*)cpos, (float*)ws_r, (float*)ws_i, (bf16*)wm_r,
            (bf16*)wm_i, (const bf16*)xh_r, (const bf16*)xh_i,
            (const float*)e_r, (const float*)e_i, (const float*)inv_norm,
            (const float*)gc_r, (const float*)gc_i, (const float*)mu,
            (const float*)promote, (const float*)reseed, B, P, F);
    return (int)cudaGetLastError();
}

int ms2_mdf_update_fused(int device, int shadow_bf16, const void* cpos,
                         void* ws_r, void* ws_i, void* wm_r, void* wm_i,
                         const void* xh_r, const void* xh_i, const void* e_r,
                         const void* e_i, const void* inv_norm,
                         const void* gc_r, const void* gc_i, const void* mu,
                         const void* promote, const void* reseed,
                         const void* hard_reset, const void* srk,
                         unsigned int lin0, int B, int P, int F, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B == 0 || P == 0 || F == 0) return (int)cudaGetLastError();
    const void* p[6] = {ws_r, ws_i, wm_r, wm_i, xh_r, xh_i};
    int vec = (size_t)P * F % UPD_N == 0;       // every leg's chunks 16-byte aligned
    for (int i = 0; i < 6; ++i)
        vec = vec && ((uintptr_t)p[i] % 16) == 0;
    const int nch = (int)(((size_t)P * F + UPD_N - 1) / UPD_N);
    const int K = !shadow_bf16 && nch > 256 ? 2 : 1;
    const int per = (nch + K - 1) / K;          // a thread's K chunks loaded at once
    const int threads = per >= UPD_MAX_THREADS ? UPD_MAX_THREADS : (per + 31) / 32 * 32;
    const size_t smem = upd_smem(F);
    if (smem > MDF_MAX_SMEM) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define UPD_LAUNCH(TS, SR, K)                                                               \
    do {                                                                                    \
        if (smem > 48 * 1024) {                                                             \
            err = cudaFuncSetAttribute(mdf_update_fused_kernel<TS, SR, K>,                  \
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
            if (err != cudaSuccess) return (int)err;                                        \
        }                                                                                   \
        mdf_update_fused_kernel<TS, SR, K><<<B, threads, smem, s>>>(                         \
            (const int*)cpos, (TS*)ws_r, (TS*)ws_i, (bf16*)wm_r, (bf16*)wm_i,               \
            (const bf16*)xh_r, (const bf16*)xh_i, (const float*)e_r, (const float*)e_i,     \
            (const float*)inv_norm, (const float*)gc_r, (const float*)gc_i,                 \
            (const float*)mu, (const uint8_t*)promote, (const uint8_t*)reseed,              \
            (const uint8_t*)hard_reset, (const long long*)srk, lin0, P, F, vec);            \
    } while (0)
    if (shadow_bf16)
        UPD_LAUNCH(bf16, true, 1);
    else if (K == 2)
        UPD_LAUNCH(float, false, 2);
    else
        UPD_LAUNCH(float, false, 1);
#undef UPD_LAUNCH
    return (int)cudaGetLastError();
}

int ms2_suppress_gain(int device, const void* er, const void* ei, const void* yr,
                      const void* yi, const void* leak, void* out, int B, int F, float beta,
                      float floor_gain, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const unsigned total = (unsigned)B * (unsigned)F;
    if (total == 0) return (int)cudaGetLastError();
    suppress_gain_kernel<<<(total + SUPPRESS_THREADS - 1) / SUPPRESS_THREADS, SUPPRESS_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const float*)er, (const float*)ei, (const float*)yr, (const float*)yi,
        (const float*)leak, (float*)out, total, (unsigned)F, beta, floor_gain);
    return (int)cudaGetLastError();
}

// p: near, y_m, y_s, Em, Es, Dn, Nf, promote_cnt, reseed_cnt, diverge_cnt,
// leak, enabled, e_s, e, y (or null), rows, flags; consts: DEC_NCONST
// floats in host memory, DecConsts' fields in order; ld_*: the input rows'
// strides in samples (each row's samples contiguous)
int ms2_aec_decide(int device, void* const* p, const float* consts, long long ld_n,
                   long long ld_m, long long ld_s, int B, int S, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B <= 0) return (int)cudaGetLastError();
    if (S < 1) return (int)cudaErrorInvalidValue;
    const DecArgs a = {(const float*)p[0], (const float*)p[1], (const float*)p[2],
                       (const float*)p[3], (const float*)p[4], (const float*)p[5],
                       (const float*)p[6], (const int*)p[7], (const int*)p[8], (const int*)p[9],
                       (const float*)p[10], (const uint8_t*)p[11], (float*)p[12],
                       (float*)p[13], (float*)p[14], (float*)p[15], (uint8_t*)p[16]};
    const float* k = consts;
    const DecConsts c = {k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7], k[8], k[9], k[10],
                         k[11], k[12], k[13], k[14], k[15], k[16], (int)k[17], (int)k[18]};
    // float4 rows when every row's samples are 16-byte aligned; the lanes a
    // leg from the units (float4 or samples) a row holds; a row longer than
    // one chunk of 32 lanes goes chunk by chunk
    bool vec = S % 4 == 0 && ld_n % 4 == 0 && ld_m % 4 == 0 && ld_s % 4 == 0;
    const void* sig[6] = {p[0], p[1], p[2], p[12], p[13], p[14]};
    for (int i = 0; i < 6; ++i)
        vec = vec && ((uintptr_t)sig[i] % 16) == 0;
    const int units = vec ? S / 4 : S, per = vec ? DEC_LANE / 4 : DEC_LANE;
    const bool lng = units > 32 * per;
    const int G = units <= 8 * per ? 8 : (units <= 16 * per ? 16 : 32);
    const unsigned blocks = (unsigned)((B + DEC_BLOCK / G - 1) / (DEC_BLOCK / G));
    cudaStream_t st = (cudaStream_t)stream;
#define DEC_LAUNCH(g, v, l) aec_decide_kernel<g, v, l><<<blocks, DEC_BLOCK, 0, st>>>( \
        a, c, ld_n, ld_m, ld_s, B, S)
    if (vec) {
        if (lng) DEC_LAUNCH(32, true, true);
        else if (G == 8) DEC_LAUNCH(8, true, false);
        else if (G == 16) DEC_LAUNCH(16, true, false);
        else DEC_LAUNCH(32, true, false);
    } else {
        if (lng) DEC_LAUNCH(32, false, true);
        else if (G == 8) DEC_LAUNCH(8, false, false);
        else if (G == 16) DEC_LAUNCH(16, false, false);
        else DEC_LAUNCH(32, false, false);
    }
#undef DEC_LAUNCH
    return (int)cudaGetLastError();
}

int ms2_spectrum_planes(int device, const void* z, void* re, void* im, int rows, int F,
                        int alternate, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const unsigned total = (unsigned)rows * (unsigned)F;
    if (total == 0) return (int)cudaGetLastError();
    spectrum_planes_kernel<<<(total + LAYOUT_THREADS - 1) / LAYOUT_THREADS, LAYOUT_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const float2*)z, (float*)re, (float*)im, total, (unsigned)F, alternate);
    return (int)cudaGetLastError();
}

int ms2_planes_spectrum(int device, const void* re, const void* im, void* z, int rows, int F,
                        float scale, int zero_last, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const unsigned total = (unsigned)rows * (unsigned)F;
    if (total == 0) return (int)cudaGetLastError();
    planes_spectrum_kernel<<<(total + LAYOUT_THREADS - 1) / LAYOUT_THREADS, LAYOUT_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const float*)re, (const float*)im, (float2*)z, total, (unsigned)F, scale, zero_last);
    return (int)cudaGetLastError();
}

}  // extern "C"
