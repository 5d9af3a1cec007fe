// One family of EAM passes over the 27-cell stencil of the cells-last
// layout, for Hopper (sm_90a), with compile-time flags:
//   eam_rho_kernel<false>   K1 eam_rho:     rho_i, nn_i
//   eam_rho_kernel<true>    K4 eam_rho_e:   + e_i = 1/2 sum_j phi(r^2)
//   eam_force_kernel<false> K2 eam_force:   F_i
//   eam_force_kernel<true>  K5 eam_force_s: + s_i^ab = -1/2 sum_j grad d_a d_b
//
// Replaces the Pallas kernels
//   kern_r (eam_kernels_win_split, imd_tpu/ops/forces_win.py:306)  -> K1
//   kern_f (eam_kernels_win_split, imd_tpu/ops/forces_win.py:411)  -> K2
//   kern_a (eam_kernels_cl, imd_tpu/ops/forces_pallas.py:275)      -> K4
//   kern_b (eam_kernels_cl, imd_tpu/ops/forces_pallas.py:345)      -> K5
// computing the same functions, not the same block structure.  The TPU's
// observables pair (kern_a, kern_b) splits pair and embedding terms and
// sweeps 13 pre-rolled half-stencil views; here K4 and K5 are K1 and K2
// with the energy and stress sums switched on, so the hot loop's forces
// and the .eng observables come from one stencil loop.
//
// Layout: xi [cap, 3, NC] f32 positions, alive [cap, NC] u8, NC = gx*gy*gz
// with the flat cell index c = (x*gy + y)*gz + z (cells last).
//
// Design.  One thread per (slot s, cell c), c fastest (threadIdx.x), so the
// cells-last loads of a warp are contiguous.  Each thread gathers over the
// FULL 27-cell stencil -- the own cell without slot s plus all 26
// neighbours -- and writes its outputs exactly once: no atomics, no j-side
// partner buffers, no roll-back pass, and the same result on every run.
// The neighbour cell and its periodic box shift come from the integer
// (ix, iy, iz) with wrap; across a non-periodic face the neighbour is
// skipped (the Pallas kernels push it to +3e6 instead).  Dead i and dead j
// slots are skipped explicitly; dead outputs are 0.
//
// Cost.  The full stencil evaluates every pair twice, once from each side,
// where the TPU kernels' 13-offset half stencil evaluates it once and books
// the reaction through j-side buffers.  That doubles the pair work in
// exchange for no reduction across threads.  The stress follows from it:
// the TPU books the whole pair term -grad d_a d_b once, on the i side
// (forces_pallas.py:142-208); here each side books half, so the sum of
// s_i over atoms is the same pressure tensor.  Its global sum runs in
// float64 in torch after the kernel.
//
// What bounds it on the H100.  Per live atom the thread visits 27*cap
// candidate slots (432 at cap 16) and only ~8% of them fall inside the
// cutoff, so the loop is dominated by candidate loads (3 floats + 1 byte,
// + dF in K2/K5) and the distance test, served from L1/L2: the slots of one
// cell column re-read the same neighbour data, and a warp's 32 cells read
// 32 consecutive floats.  The Horner polynomials (16 multiply-adds each)
// run only for pairs inside the cutoff; K4 adds one (pair value), K5 six
// products and six accumulators.  Later work: stage a block's neighbour
// cells in shared memory and use the half stencil with a j-side reduction.
//
// Rounding.  This file is compiled with -fmad=false (kernels.py): every
// multiply and add rounds on its own, as torch's eager mul + add do, so
// the kernels round like their plain versions.  With FMA contraction the
// degree-12 fits (monomial coefficients up to ~300, sum of |c_k| ~1500 for
// phi and ~2400 for its derivative) move each pair's value or gradient by
// up to ~1e-4 in float32: more than the 1e-5 of max|epot| the energy is
// held to, and, on the near-equilibrium film of the 1M-atom driver run
// (max|F| 16 eV/A), more than the 1e-4 of max|F| the forces are held to.
// It costs about twice the Horner instructions: K1 0.912 ms with FMA,
// 0.970 ms without, at the flagship's shapes (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py).
//
// Polynomial convention (imd_tpu/ops/forces_pallas.py:55-109, 554-575):
// t = clip(x*a - b0, -1, 1) with a = 2/(e-b), b0 = b*a + 1, so the value is
// CONSTANT below the fit window (PolyPotential.interp continues linearly
// there; the force kernels clip).  The derivative polynomials carry the
// chain factor 4/(e-b) and the power weights in their coefficients and give
// 2*dV/dr^2, so the force is F_i = -sum_j grad_ij (x_i - x_j) with
// grad = phi'(r^2) + (dF_i + dF_j) rho'(r^2).

#include <cuda_runtime.h>
#include <stdint.h>

#define NPOLY 16

struct Poly {
    float c[NPOLY];   // coefficient of t^k, zero-padded above the degree
    float a;
    float b0;
};

struct EamParams {
    Poly rho_v;       // rho(r^2)
    Poly pair_g;      // 2 dphi/dr^2
    Poly rho_g;       // 2 drho/dr^2
    Poly pair_v;      // phi(r^2) (K4 only)
    float rcut2;
    float h[9];       // box rows h[3*row + col]
    int pbc[3];
    int gx, gy, gz, cap;
};

__device__ __forceinline__ float poly_eval(const Poly& p, float x) {
    const float t = fminf(fmaxf(x * p.a - p.b0, -1.0f), 1.0f);
    float v = p.c[NPOLY - 1];
#pragma unroll
    for (int k = NPOLY - 2; k >= 0; --k) v = v * t + p.c[k];
    return v;
}

// Neighbour cell of (ix, iy, iz) at offset o (0..26, o = 13 is the own
// cell) with its periodic box shift; false across a non-periodic face.
__device__ __forceinline__ bool neighbor(const EamParams& P, int ix, int iy,
                                         int iz, int o, int& cj, float& sx,
                                         float& sy, float& sz) {
    int jx = ix + o / 9 - 1, jy = iy + (o / 3) % 3 - 1, jz = iz + o % 3 - 1;
    const int wx = jx < 0 ? -1 : (jx >= P.gx ? 1 : 0);
    const int wy = jy < 0 ? -1 : (jy >= P.gy ? 1 : 0);
    const int wz = jz < 0 ? -1 : (jz >= P.gz ? 1 : 0);
    if ((wx && !P.pbc[0]) || (wy && !P.pbc[1]) || (wz && !P.pbc[2]))
        return false;
    jx -= wx * P.gx;
    jy -= wy * P.gy;
    jz -= wz * P.gz;
    cj = (jx * P.gy + jy) * P.gz + jz;
    const float fx = (float)wx, fy = (float)wy, fz = (float)wz;
    sx = fx * P.h[0] + fy * P.h[3] + fz * P.h[6];
    sy = fx * P.h[1] + fy * P.h[4] + fz * P.h[7];
    sz = fx * P.h[2] + fy * P.h[5] + fz * P.h[8];
    return true;
}

template <bool ENERGY>
__global__ void __launch_bounds__(128)
eam_rho_kernel(const float* __restrict__ xi,
               const uint8_t* __restrict__ alive,
               float* __restrict__ rho, float* __restrict__ nn,
               float* __restrict__ e, int nc,
               const __grid_constant__ EamParams P) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int s = blockIdx.y;
    if (c >= nc) return;
    const size_t n = (size_t)nc;
    const size_t io = (size_t)s * n + c;
    if (!alive[io]) {
        rho[io] = 0.0f;
        nn[io] = 0.0f;
        if constexpr (ENERGY) e[io] = 0.0f;
        return;
    }
    const float x = xi[(3 * (size_t)s) * n + c];
    const float y = xi[(3 * (size_t)s + 1) * n + c];
    const float z = xi[(3 * (size_t)s + 2) * n + c];
    const int gyz = P.gy * P.gz;
    const int ix = c / gyz, iy = (c / P.gz) % P.gy, iz = c % P.gz;
    float acc = 0.0f, cnt = 0.0f, eacc = 0.0f;
    for (int o = 0; o < 27; ++o) {
        int cj;
        float sx, sy, sz;
        if (!neighbor(P, ix, iy, iz, o, cj, sx, sy, sz)) continue;
        for (int t = 0; t < P.cap; ++t) {
            const size_t jo = (size_t)t * n + cj;
            if ((o == 13 && t == s) || !alive[jo]) continue;
            const float dx = x - (xi[(3 * (size_t)t) * n + cj] + sx);
            const float dy = y - (xi[(3 * (size_t)t + 1) * n + cj] + sy);
            const float dz = z - (xi[(3 * (size_t)t + 2) * n + cj] + sz);
            const float r2 = dx * dx + dy * dy + dz * dz;
            if (r2 < P.rcut2) {
                acc += poly_eval(P.rho_v, r2);
                if constexpr (ENERGY) eacc += poly_eval(P.pair_v, r2);
                cnt += 1.0f;
            }
        }
    }
    rho[io] = acc;
    nn[io] = cnt;
    if constexpr (ENERGY) e[io] = 0.5f * eacc;
}

template <bool STRESS>
__global__ void __launch_bounds__(128)
eam_force_kernel(const float* __restrict__ xi,
                 const uint8_t* __restrict__ alive,
                 const float* __restrict__ dF, float* __restrict__ F,
                 float* __restrict__ S, int nc,
                 const __grid_constant__ EamParams P) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int s = blockIdx.y;
    if (c >= nc) return;
    const size_t n = (size_t)nc;
    const size_t io = (size_t)s * n + c;
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;
    // -sum_j grad d_a d_b in Voigt order xx yy zz yz zx xy
    float vxx = 0.0f, vyy = 0.0f, vzz = 0.0f;
    float vyz = 0.0f, vzx = 0.0f, vxy = 0.0f;
    if (alive[io]) {
        const float x = xi[(3 * (size_t)s) * n + c];
        const float y = xi[(3 * (size_t)s + 1) * n + c];
        const float z = xi[(3 * (size_t)s + 2) * n + c];
        const float dfi = dF[io];
        const int gyz = P.gy * P.gz;
        const int ix = c / gyz, iy = (c / P.gz) % P.gy, iz = c % P.gz;
        for (int o = 0; o < 27; ++o) {
            int cj;
            float sx, sy, sz;
            if (!neighbor(P, ix, iy, iz, o, cj, sx, sy, sz)) continue;
            for (int t = 0; t < P.cap; ++t) {
                const size_t jo = (size_t)t * n + cj;
                if ((o == 13 && t == s) || !alive[jo]) continue;
                const float dx = x - (xi[(3 * (size_t)t) * n + cj] + sx);
                const float dy = y - (xi[(3 * (size_t)t + 1) * n + cj] + sy);
                const float dz = z - (xi[(3 * (size_t)t + 2) * n + cj] + sz);
                const float r2 = dx * dx + dy * dy + dz * dz;
                if (r2 < P.rcut2) {
                    const float grad = poly_eval(P.pair_g, r2)
                        + (dfi + dF[jo]) * poly_eval(P.rho_g, r2);
                    const float gx = grad * dx, gy = grad * dy,
                                gz = grad * dz;
                    fx -= gx;
                    fy -= gy;
                    fz -= gz;
                    if constexpr (STRESS) {
                        vxx -= gx * dx;
                        vyy -= gy * dy;
                        vzz -= gz * dz;
                        vyz -= gy * dz;
                        vzx -= gz * dx;
                        vxy -= gx * dy;
                    }
                }
            }
        }
    }
    F[(3 * (size_t)s) * n + c] = fx;
    F[(3 * (size_t)s + 1) * n + c] = fy;
    F[(3 * (size_t)s + 2) * n + c] = fz;
    if constexpr (STRESS) {
        // each pair is visited from both sides: each books half
        const size_t cs = (size_t)P.cap * n;
        S[io] = 0.5f * vxx;
        S[cs + io] = 0.5f * vyy;
        S[2 * cs + io] = 0.5f * vzz;
        S[3 * cs + io] = 0.5f * vyz;
        S[4 * cs + io] = 0.5f * vzx;
        S[5 * cs + io] = 0.5f * vxy;
    }
}

static dim3 slot_cell_grid(int nc, int cap) {
    return dim3((unsigned)((nc + 127) / 128), (unsigned)cap);
}

extern "C" int imd_eam_rho(const void* xi, const void* alive, void* rho,
                           void* nn, const EamParams* p, int nc,
                           void* stream) {
    eam_rho_kernel<false><<<slot_cell_grid(nc, p->cap), 128, 0,
                            (cudaStream_t)stream>>>(
        (const float*)xi, (const uint8_t*)alive, (float*)rho, (float*)nn,
        nullptr, nc, *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_eam_rho_e(const void* xi, const void* alive, void* rho,
                             void* nn, void* e, const EamParams* p, int nc,
                             void* stream) {
    eam_rho_kernel<true><<<slot_cell_grid(nc, p->cap), 128, 0,
                           (cudaStream_t)stream>>>(
        (const float*)xi, (const uint8_t*)alive, (float*)rho, (float*)nn,
        (float*)e, nc, *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_eam_force(const void* xi, const void* alive,
                             const void* dF, void* F, const EamParams* p,
                             int nc, void* stream) {
    eam_force_kernel<false><<<slot_cell_grid(nc, p->cap), 128, 0,
                              (cudaStream_t)stream>>>(
        (const float*)xi, (const uint8_t*)alive, (const float*)dF,
        (float*)F, nullptr, nc, *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_eam_force_s(const void* xi, const void* alive,
                               const void* dF, void* F, void* S,
                               const EamParams* p, int nc, void* stream) {
    eam_force_kernel<true><<<slot_cell_grid(nc, p->cap), 128, 0,
                             (cudaStream_t)stream>>>(
        (const float*)xi, (const uint8_t*)alive, (const float*)dF,
        (float*)F, (float*)S, nc, *p);
    return (int)cudaGetLastError();
}
