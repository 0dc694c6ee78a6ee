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
// None of the four has a matrix product in it: all are bound by device
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
//
// cpos and srk arrive through device pointers (the Pallas kernel took cpos
// through SMEM), so the host never waits for the device to learn them.
// One thread per element; neighbouring threads take neighbouring f.
// Bandwidth-bound: reads Ws, Wm, Xh once, writes Ws once (and Wm rarely).
// ---------------------------------------------------------------------------
static __device__ __forceinline__ bf16 sround_bf16(float x, uint32_t lin, uint32_t salt)
{
    uint32_t bits = __float_as_uint(x);
    uint32_t h = lin * 2654435761u + salt * 0x9E3779B9u;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    bits += h & 0xFFFFu;
    return __ushort_as_bfloat16((unsigned short)(bits >> 16));
}

template <typename TS, bool SROUND>
__global__ void __launch_bounds__(256)
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
    const float m = mu[b];

    const float hr = __bfloat162float(xh_r[idx]);
    const float hi = __bfloat162float(xh_i[idx]);
    const float er = e_r[bf], ei = e_i[bf];
    const float gr = hr * er + hi * ei;
    const float gi = hr * ei - hi * er;
    const float wsr = ld(ws_r + idx), wsi = ld(ws_i + idx);
    float up_r, up_i;
    if (p == *cpos_p) {
        up_r = wsr + m * gc_r[bf];
        up_i = wsi + m * gc_i[bf];
    } else {
        const float stepw = m * inv_norm[bf];
        up_r = wsr + stepw * gr;
        up_i = wsi + stepw * gi;
    }
    const bool pr = promote[b] != 0;
    const bool rs = reseed[b] != 0;
    const bool hz = hard_reset[b] != 0;
    float nr = up_r, ni = up_i;
    if (rs) {
        nr = __bfloat162float(wm_r[idx]);
        ni = __bfloat162float(wm_i[idx]);
    }
    if (hz) {
        nr = 0.f;
        ni = 0.f;
    }
    if constexpr (SROUND) {
        const uint32_t salt = (uint32_t)(unsigned long long)(*srk_p) * 2u;
        const uint32_t lin = lin0 + (uint32_t)idx;     // wraps as JAX's uint32 iota
        const bf16 qr = sround_bf16(nr, lin, salt);
        const bf16 qi = sround_bf16(ni, lin, salt + 1u);
        ws_r[idx] = qr;
        ws_i[idx] = qi;
        if (pr) {
            wm_r[idx] = qr;
            wm_i[idx] = qi;
        }
    } else {
        ws_r[idx] = nr;
        ws_i[idx] = ni;
        if (pr) {
            wm_r[idx] = __float2bfloat16_rn(up_r);
            wm_i[idx] = __float2bfloat16_rn(up_i);
        }
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
    const size_t n = (size_t)B * P * F;
    if (n == 0) return (int)cudaGetLastError();
    const unsigned blocks = (unsigned)((n + 255) / 256);
    cudaStream_t s = (cudaStream_t)stream;
    if (shadow_bf16)
        mdf_update_fused_kernel<bf16, true><<<blocks, 256, 0, s>>>(
            (const int*)cpos, (bf16*)ws_r, (bf16*)ws_i, (bf16*)wm_r,
            (bf16*)wm_i, (const bf16*)xh_r, (const bf16*)xh_i,
            (const float*)e_r, (const float*)e_i, (const float*)inv_norm,
            (const float*)gc_r, (const float*)gc_i, (const float*)mu,
            (const uint8_t*)promote, (const uint8_t*)reseed,
            (const uint8_t*)hard_reset, (const long long*)srk, lin0, B, P, F);
    else
        mdf_update_fused_kernel<float, false><<<blocks, 256, 0, s>>>(
            (const int*)cpos, (float*)ws_r, (float*)ws_i, (bf16*)wm_r,
            (bf16*)wm_i, (const bf16*)xh_r, (const bf16*)xh_i,
            (const float*)e_r, (const float*)e_i, (const float*)inv_norm,
            (const float*)gc_r, (const float*)gc_i, (const float*)mu,
            (const uint8_t*)promote, (const uint8_t*)reseed,
            (const uint8_t*)hard_reset, (const long long*)srk, lin0, B, P, F);
    return (int)cudaGetLastError();
}

}  // extern "C"
