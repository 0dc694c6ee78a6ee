// Hand-written Hopper (sm_90a) kernels of the flagship conference leg.
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
// None of the three has a matrix product in it: all are bound by device
// memory bandwidth. The [B, P, F] bf16 tap and history tensors of the echo
// canceller set the pace, so each kernel reads every such element once
// and writes only what changes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

static __device__ __forceinline__ float ld(const float* p) { return *p; }
static __device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }

// ---------------------------------------------------------------------------
// fused_volume -- replaces fused_volume / _fused_volume_kernel
// (mediastreamer2_tpu/ops/pallas_kernels.py:38-84).
//
//   mean   = mean(x)
//   x'     = x - dc * dcen
//   y      = clip(x' * (g0 * (1 - i/S) + g1 * i/S), -1, 1)
//   energy = mean(x'^2)
//
// One block of VOL_THREADS threads per leg row; each thread walks the row
// with stride VOL_THREADS (coalesced), then a warp-shuffle + shared-memory
// reduction gives the row's two sums. Bandwidth-bound: one read and one
// write of the [B, S] f32 block.
// ---------------------------------------------------------------------------
#define VOL_THREADS 128

__global__ void __launch_bounds__(VOL_THREADS)
fused_volume_kernel(const float* __restrict__ x, const float* __restrict__ g0,
                    const float* __restrict__ g1, const float* __restrict__ dc,
                    const float* __restrict__ dcen, float* __restrict__ y,
                    float* __restrict__ energy, float* __restrict__ mean, int S)
{
    const int b = blockIdx.x;
    const float* xr = x + (size_t)b * S;
    float* yr = y + (size_t)b * S;
    const float off = dc[b] * dcen[b];
    const float a = g0[b];
    const float c = g1[b];
    const float fs = (float)S;
    float s = 0.f, e = 0.f;
    for (int i = threadIdx.x; i < S; i += VOL_THREADS) {
        const float v = xr[i];
        s += v;
        const float xv = v - off;
        const float ramp = (float)i / fs;
        const float g = a * (1.0f - ramp) + c * ramp;
        yr[i] = fminf(fmaxf(xv * g, -1.0f), 1.0f);
        e += xv * xv;
    }
    for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, o);
        e += __shfl_down_sync(0xffffffffu, e, o);
    }
    __shared__ float ss[VOL_THREADS / 32], se[VOL_THREADS / 32];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        ss[warp] = s;
        se[warp] = e;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float ts = 0.f, te = 0.f;
        for (int w = 0; w < VOL_THREADS / 32; ++w) {
            ts += ss[w];
            te += se[w];
        }
        mean[b] = ts / fs;
        energy[b] = te / fs;
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
// summed over p in order 0..P-1.
//
// Each thread owns one (b, f) column across all P partitions. It loads
// the column's whole history into registers before it stores the shifted
// one, and no other thread touches that column, so the in-place shift is
// race-free. Loading first also keeps every load of the column in flight
// at once: a store to Xh[p] ahead of the load of Xh[p+1] would make each
// partition wait for the previous one (the compiler cannot prove the two
// addresses differ). Neighbouring threads own neighbouring f, so every
// [B, P, F] access is coalesced. Bandwidth-bound: reads Wm, Ws, Xh (6 bf16
// tensors), writes Xh (2) and the four [B, F] f32 sums.
// ---------------------------------------------------------------------------
#define MDF_MAX_P 16

__global__ void __launch_bounds__(256)
mdf_apply_kernel(const bf16* __restrict__ wm_r, const bf16* __restrict__ wm_i,
                 const bf16* __restrict__ ws_r, const bf16* __restrict__ ws_i,
                 bf16* __restrict__ xh_r, bf16* __restrict__ xh_i,
                 const float* __restrict__ x_r, const float* __restrict__ x_i,
                 float* __restrict__ ym_r, float* __restrict__ ym_i,
                 float* __restrict__ ys_r, float* __restrict__ ys_i,
                 int B, int P, int F)
{
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= B * F) return;
    const int b = idx / F;
    const int f = idx - b * F;
    const size_t base = (size_t)b * P * F + f;
    bf16 hr[MDF_MAX_P], hi[MDF_MAX_P];     // the shifted history column
    hr[0] = __float2bfloat16_rn(x_r[idx]);
    hi[0] = __float2bfloat16_rn(x_i[idx]);
#pragma unroll
    for (int p = 1; p < MDF_MAX_P; ++p) {
        if (p < P) {
            hr[p] = xh_r[base + (size_t)(p - 1) * F];
            hi[p] = xh_i[base + (size_t)(p - 1) * F];
        }
    }
    float amr = 0.f, ami = 0.f, asr = 0.f, asi = 0.f;
#pragma unroll
    for (int p = 0; p < MDF_MAX_P; ++p) {
        if (p < P) {
            const size_t o = base + (size_t)p * F;
            xh_r[o] = hr[p];
            xh_i[o] = hi[p];
            const float h_r = __bfloat162float(hr[p]);
            const float h_i = __bfloat162float(hi[p]);
            const float mr = ld(wm_r + o), mi = ld(wm_i + o);
            const float sr = ld(ws_r + o), si = ld(ws_i + o);
            amr = amr + (mr * h_r - mi * h_i);
            ami = ami + (mr * h_i + mi * h_r);
            asr = asr + (sr * h_r - si * h_i);
            asi = asi + (sr * h_i + si * h_r);
        }
    }
    ym_r[idx] = amr;
    ym_i[idx] = ami;
    ys_r[idx] = asr;
    ys_i[idx] = asi;
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
//       ops/aec.py:142-152 over the linear (b, p, f) index
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
                        const long long* __restrict__ srk_p,
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
        const uint32_t lin = (uint32_t)idx;
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
    if (B > 0)
        fused_volume_kernel<<<B, VOL_THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)x, (const float*)g0, (const float*)g1,
            (const float*)dc, (const float*)dcen, (float*)y,
            (float*)energy, (float*)mean, S);
    return (int)cudaGetLastError();
}

int ms2_mdf_apply(int device, const void* wm_r, const void* wm_i,
                  const void* ws_r, const void* ws_i, void* xh_r, void* xh_i,
                  const void* x_r, const void* x_i, void* ym_r, void* ym_i,
                  void* ys_r, void* ys_i, int B, int P, int F, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int n = B * F;
    if (n > 0)
        mdf_apply_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
            (const bf16*)wm_r, (const bf16*)wm_i, (const bf16*)ws_r,
            (const bf16*)ws_i, (bf16*)xh_r, (bf16*)xh_i, (const float*)x_r,
            (const float*)x_i, (float*)ym_r, (float*)ym_i, (float*)ys_r,
            (float*)ys_i, B, P, F);
    return (int)cudaGetLastError();
}

int ms2_mdf_update_fused(int device, int shadow_bf16, const void* cpos,
                         void* ws_r, void* ws_i, void* wm_r, void* wm_i,
                         const void* xh_r, const void* xh_i, const void* e_r,
                         const void* e_i, const void* inv_norm,
                         const void* gc_r, const void* gc_i, const void* mu,
                         const void* promote, const void* reseed,
                         const void* hard_reset, const void* srk,
                         int B, int P, int F, void* stream)
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
            (const uint8_t*)hard_reset, (const long long*)srk, B, P, F);
    else
        mdf_update_fused_kernel<float, false><<<blocks, 256, 0, s>>>(
            (const int*)cpos, (float*)ws_r, (float*)ws_i, (bf16*)wm_r,
            (bf16*)wm_i, (const bf16*)xh_r, (const bf16*)xh_i,
            (const float*)e_r, (const float*)e_i, (const float*)inv_norm,
            (const float*)gc_r, (const float*)gc_i, (const float*)mu,
            (const uint8_t*)promote, (const uint8_t*)reseed,
            (const uint8_t*)hard_reset, (const long long*)srk, B, P, F);
    return (int)cudaGetLastError();
}

}  // extern "C"
