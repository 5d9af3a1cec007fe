// One family of EAM passes over the 27-cell stencil of the cells-last
// layout, for Hopper (sm_90a), with compile-time flags <ENERGY|STRESS, MT>:
//   eam_rho_kernel<false, false>   K1 eam_rho:     rho_i, nn_i
//   eam_rho_kernel<true, false>    K4 eam_rho_e:   + e_i = 1/2 sum_j phi(r^2)
//   eam_force_kernel<false, false> K2 eam_force:   F_i
//   eam_force_kernel<true, false>  K5 eam_force_s: + s_i^ab = -1/2 sum_j
//                                                    grad d_a d_b
// and, with MT (2 <= ntypes <= 4 species, one table column per type pair),
//   eam_rho_kernel<false, true>    K6 eam_rho_mt
//   eam_force_kernel<false, true>  K7 eam_force_mt
//   eam_rho_kernel<true, true>     K8 eam_rho_e_mt
//   eam_force_kernel<true, true>   K9 eam_force_s_mt
//
// Replaces the Pallas kernels
//   kern_r (eam_kernels_win_split, imd_tpu/ops/forces_win.py:306)  -> K1
//   kern_f (eam_kernels_win_split, imd_tpu/ops/forces_win.py:411)  -> K2
//   kern_a (eam_kernels_cl, imd_tpu/ops/forces_pallas.py:275)      -> K4
//   kern_b (eam_kernels_cl, imd_tpu/ops/forces_pallas.py:345)      -> K5
//   kern_r (eam_kernels_win_split_mt, forces_win.py:565)           -> K6
//   kern_f (eam_kernels_win_split_mt, forces_win.py:676)           -> K7
//   kern_a (eam_kernels_cl_mt, forces_pallas.py:1055)              -> K8
//   kern_b (eam_kernels_cl_mt, forces_pallas.py:1158)              -> K9
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
// Types (MT).  The Pallas alloy kernels evaluate every column's polynomial
// for every candidate and combine them with one-hot weights, because the
// TPU has no per-lane gather.  Here a thread knows its own type t_i, loads
// t_j with the candidate, and evaluates ONE column per table:
//   phi, phi'  col = t_i*nt + t_j          (symmetric: the wrapper refuses
//                                           asymmetric pair tables)
//   rho_i +=   col = t_j*nt + t_i          (source first: density at i
//                                           from j)
//   grad = phi'(t_i,t_j) + dF_i rho'(t_j,t_i) + dF_j rho'(t_i,t_j).
// The 0/1-weighted sum is exact, so the selected column gives the same
// value.  typ [cap, NC] int32 takes the place of the alive bytes: a slot
// is dead where typ < 0 (no sentinel positions are relied on), and types
// above nt - 1 are clipped to it, as the TPU kernels clip.  That is 16
// bytes per candidate (12 position + 4 type) against 13 with alive; a
// uint8 copy of the types would keep 13 but would have to be rebuilt by a
// torch op after every rebin.
//
// Where the MT coefficients live.  At nt = 4 the four tables hold 64
// polynomials of NPOLY + 2 floats, 4.6 kB: more than the 4 kB of kernel
// parameters, and a __constant__ table indexed by a column that differs
// across a warp would serialise its reads.  They sit in a small device
// buffer [4 tables][nt*nt columns][NPOLY + 2] made once per potential
// (ops/forces_win.py), and every block copies the two tables its kernel
// reads into shared memory before its loop (at most 2.3 kB).  The row
// stride of 18 floats puts the 16 columns of a table at 16 different
// banks, so threads of a warp that evaluate different columns do not
// conflict, and threads on one column broadcast.  The single-species
// kernels keep their polynomials in the kernel parameters.
//
// Polynomial convention (imd_tpu/ops/forces_pallas.py:55-109, 554-575):
// t = clip(x*a - b0, -1, 1) with a = 2/(e-b), b0 = b*a + 1, so the value is
// CONSTANT below the fit window (PolyPotential.interp continues linearly
// there; the force kernels clip).  The derivative polynomials carry the
// chain factor 4/(e-b) and the power weights in their coefficients and give
// 2*dV/dr^2, so the force is F_i = -sum_j grad_ij (x_i - x_j) with
// grad = phi'(r^2) + (dF_i + dF_j) rho'(r^2).

#include "eam_common.cuh"

// MT coefficient tables: rows of NPOLY coefficients, then a and b0.
#define PROW (NPOLY + 2)
#define MAX_NT 4
#define TAB_ROWS (MAX_NT * MAX_NT)
// order of the tables in the device buffer: the R pass reads the first
// two, the F pass the last two
enum { T_RHO_V = 0, T_PAIR_V = 1, T_PAIR_G = 2, T_RHO_G = 3 };

__device__ __forceinline__ float poly_eval_row(const float* __restrict__ p,
                                               float x) {
    const float t = fminf(fmaxf(x * p[NPOLY] - p[NPOLY + 1], -1.0f), 1.0f);
    float v = p[NPOLY - 1];
#pragma unroll
    for (int k = NPOLY - 2; k >= 0; --k) v = v * t + p[k];
    return v;
}

// Copy ``ntab`` tables of nt*nt rows, starting at table ``first``, from the
// device buffer into the block's shared memory; ends with a barrier.
__device__ __forceinline__ void stage_tables(float* dst,
                                             const float* __restrict__ tab,
                                             int first, int ntab, int nt) {
    const int rows = nt * nt;
    const float* src = tab + (size_t)first * rows * PROW;
    for (int k = threadIdx.x; k < ntab * rows * PROW; k += blockDim.x)
        dst[k] = src[k];
    __syncthreads();
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

template <bool ENERGY, bool MT>
__global__ void __launch_bounds__(128)
eam_rho_kernel(const float* __restrict__ xi,
               const uint8_t* __restrict__ alive,
               const int32_t* __restrict__ typ,
               const float* __restrict__ tab, int nt,
               float* __restrict__ rho, float* __restrict__ nn,
               float* __restrict__ e, int nc,
               const __grid_constant__ EamParams P) {
    __shared__ float tabs[MT ? 2 * TAB_ROWS * PROW : 1];
    if constexpr (MT) stage_tables(tabs, tab, T_RHO_V, ENERGY ? 2 : 1, nt);
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int s = blockIdx.y;
    if (c >= nc) return;
    const size_t n = (size_t)nc;
    const size_t io = (size_t)s * n + c;
    int ti = 0;
    bool live;
    if constexpr (MT) {
        const int ti_raw = typ[io];
        live = ti_raw >= 0;
        ti = min(ti_raw, nt - 1);
    } else {
        live = alive[io];
    }
    if (!live) {
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
            int tj = 0;
            if constexpr (MT) {
                tj = typ[jo];
                if ((o == 13 && t == s) || tj < 0) continue;
                tj = min(tj, nt - 1);
            } else {
                if ((o == 13 && t == s) || !alive[jo]) continue;
            }
            const float dx = x - (xi[(3 * (size_t)t) * n + cj] + sx);
            const float dy = y - (xi[(3 * (size_t)t + 1) * n + cj] + sy);
            const float dz = z - (xi[(3 * (size_t)t + 2) * n + cj] + sz);
            const float r2 = dx * dx + dy * dy + dz * dz;
            if (r2 < P.rcut2) {
                if constexpr (MT) {
                    const float* rho_v = tabs;
                    const float* pair_v = tabs + nt * nt * PROW;
                    // the density j (source) contributes at i (host)
                    acc += poly_eval_row(rho_v + (tj * nt + ti) * PROW, r2);
                    if constexpr (ENERGY)
                        eacc += poly_eval_row(
                            pair_v + (ti * nt + tj) * PROW, r2);
                } else {
                    acc += poly_eval(P.rho_v, r2);
                    if constexpr (ENERGY) eacc += poly_eval(P.pair_v, r2);
                }
                cnt += 1.0f;
            }
        }
    }
    rho[io] = acc;
    nn[io] = cnt;
    if constexpr (ENERGY) e[io] = 0.5f * eacc;
}

template <bool STRESS, bool MT>
__global__ void __launch_bounds__(128)
eam_force_kernel(const float* __restrict__ xi,
                 const uint8_t* __restrict__ alive,
                 const int32_t* __restrict__ typ,
                 const float* __restrict__ tab, int nt,
                 const float* __restrict__ dF, float* __restrict__ F,
                 float* __restrict__ S, int nc,
                 const __grid_constant__ EamParams P) {
    __shared__ float tabs[MT ? 2 * TAB_ROWS * PROW : 1];
    if constexpr (MT) stage_tables(tabs, tab, T_PAIR_G, 2, nt);
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int s = blockIdx.y;
    if (c >= nc) return;
    const size_t n = (size_t)nc;
    const size_t io = (size_t)s * n + c;
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;
    // -sum_j grad d_a d_b in Voigt order xx yy zz yz zx xy
    float vxx = 0.0f, vyy = 0.0f, vzz = 0.0f;
    float vyz = 0.0f, vzx = 0.0f, vxy = 0.0f;
    int ti = 0;
    bool live;
    if constexpr (MT) {
        const int ti_raw = typ[io];
        live = ti_raw >= 0;
        ti = min(ti_raw, nt - 1);
    } else {
        live = alive[io];
    }
    if (live) {
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
                int tj = 0;
                if constexpr (MT) {
                    tj = typ[jo];
                    if ((o == 13 && t == s) || tj < 0) continue;
                    tj = min(tj, nt - 1);
                } else {
                    if ((o == 13 && t == s) || !alive[jo]) continue;
                }
                const float dx = x - (xi[(3 * (size_t)t) * n + cj] + sx);
                const float dy = y - (xi[(3 * (size_t)t + 1) * n + cj] + sy);
                const float dz = z - (xi[(3 * (size_t)t + 2) * n + cj] + sz);
                const float r2 = dx * dx + dy * dy + dz * dz;
                if (r2 < P.rcut2) {
                    float grad;
                    if constexpr (MT) {
                        const float* pair_g = tabs;
                        const float* rho_g = tabs + nt * nt * PROW;
                        // rho' of the density at i from j, and at j from i
                        grad = poly_eval_row(
                                   pair_g + (ti * nt + tj) * PROW, r2)
                            + dfi * poly_eval_row(
                                  rho_g + (tj * nt + ti) * PROW, r2)
                            + dF[jo] * poly_eval_row(
                                  rho_g + (ti * nt + tj) * PROW, r2);
                    } else {
                        grad = poly_eval(P.pair_g, r2)
                            + (dfi + dF[jo]) * poly_eval(P.rho_g, r2);
                    }
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
    eam_rho_kernel<false, false><<<slot_cell_grid(nc, p->cap), 128, 0,
                                   STREAM(stream)>>>(
        (const float*)xi, (const uint8_t*)alive, nullptr, nullptr, 1,
        (float*)rho, (float*)nn, nullptr, nc, *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_eam_rho_e(const void* xi, const void* alive, void* rho,
                             void* nn, void* e, const EamParams* p, int nc,
                             void* stream) {
    eam_rho_kernel<true, false><<<slot_cell_grid(nc, p->cap), 128, 0,
                                  STREAM(stream)>>>(
        (const float*)xi, (const uint8_t*)alive, nullptr, nullptr, 1,
        (float*)rho, (float*)nn, (float*)e, nc, *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_eam_force(const void* xi, const void* alive,
                             const void* dF, void* F, const EamParams* p,
                             int nc, void* stream) {
    eam_force_kernel<false, false><<<slot_cell_grid(nc, p->cap), 128, 0,
                                     STREAM(stream)>>>(
        (const float*)xi, (const uint8_t*)alive, nullptr, nullptr, 1,
        (const float*)dF, (float*)F, nullptr, nc, *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_eam_force_s(const void* xi, const void* alive,
                               const void* dF, void* F, void* S,
                               const EamParams* p, int nc, void* stream) {
    eam_force_kernel<true, false><<<slot_cell_grid(nc, p->cap), 128, 0,
                                    STREAM(stream)>>>(
        (const float*)xi, (const uint8_t*)alive, nullptr, nullptr, 1,
        (const float*)dF, (float*)F, (float*)S, nc, *p);
    return (int)cudaGetLastError();
}

// The multi-type entries: ``typ`` [cap, NC] int32 (-1 = dead) in place of
// the alive bytes, ``tab`` the [4][nt*nt][NPOLY + 2] coefficient buffer;
// the polynomials of ``p`` are not read.
static bool nt_ok(int nt) { return nt >= 2 && nt <= MAX_NT; }

extern "C" int imd_eam_rho_mt(const void* xi, const void* typ,
                              const void* tab, int nt, void* rho, void* nn,
                              const EamParams* p, int nc, void* stream) {
    if (!nt_ok(nt)) return (int)cudaErrorInvalidValue;
    eam_rho_kernel<false, true><<<slot_cell_grid(nc, p->cap), 128, 0,
                                  STREAM(stream)>>>(
        (const float*)xi, nullptr, (const int32_t*)typ, (const float*)tab,
        nt, (float*)rho, (float*)nn, nullptr, nc, *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_eam_rho_e_mt(const void* xi, const void* typ,
                                const void* tab, int nt, void* rho, void* nn,
                                void* e, const EamParams* p, int nc,
                                void* stream) {
    if (!nt_ok(nt)) return (int)cudaErrorInvalidValue;
    eam_rho_kernel<true, true><<<slot_cell_grid(nc, p->cap), 128, 0,
                                 STREAM(stream)>>>(
        (const float*)xi, nullptr, (const int32_t*)typ, (const float*)tab,
        nt, (float*)rho, (float*)nn, (float*)e, nc, *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_eam_force_mt(const void* xi, const void* typ,
                                const void* tab, int nt, const void* dF,
                                void* F, const EamParams* p, int nc,
                                void* stream) {
    if (!nt_ok(nt)) return (int)cudaErrorInvalidValue;
    eam_force_kernel<false, true><<<slot_cell_grid(nc, p->cap), 128, 0,
                                    STREAM(stream)>>>(
        (const float*)xi, nullptr, (const int32_t*)typ, (const float*)tab,
        nt, (const float*)dF, (float*)F, nullptr, nc, *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_eam_force_s_mt(const void* xi, const void* typ,
                                  const void* tab, int nt, const void* dF,
                                  void* F, void* S, const EamParams* p,
                                  int nc, void* stream) {
    if (!nt_ok(nt)) return (int)cudaErrorInvalidValue;
    eam_force_kernel<true, true><<<slot_cell_grid(nc, p->cap), 128, 0,
                                   STREAM(stream)>>>(
        (const float*)xi, nullptr, (const int32_t*)typ, (const float*)tab,
        nt, (const float*)dF, (float*)F, (float*)S, nc, *p);
    return (int)cudaGetLastError();
}
