// The half-stencil kernels over pre-rolled views, for Hopper (sm_90a):
//   eam_rho_half_kernel    K10 eam_rho_half:   host density rho, neighbour
//                                              count nn
//   eam_force_half_kernel  K11 eam_force_half: F from the combined gradient
//                                              phi' + (dF_i + dF_j) rho'
//   pair_half_kernel       K12 pair_half:      the pair force, energy
//                                              (phi/2 to each side), count
//                                              and the six stress sums
// Replaces the Pallas kernels
//   kern_r (eam_r_pass, imd_tpu/ops/forces_pallas.py:641, call :670) -> K10
//   kern_f (eam_f_pass, imd_tpu/ops/forces_pallas.py:747, call :772) -> K11
//   kern (compute_pair_forces_pallas, imd_tpu/ops/forces_pallas.py:487,
//         call :522)                                                 -> K12
// with the same contract: the kernels read the views they are given and
// know nothing of the periodicity, and write i-sums and per-offset j-side
// partials that torch rolls back and adds (_assemble, forces_pallas.py).
//
// Inputs (f32, cells last, NC = gx*gy*gz, NOF = 13 half-stencil offsets):
//   xi  [cap, 3, NC]       the cells' own slots (dead slots at 1e6)
//   nbr [NOF, cap, 3, NC]  view m: the slots of the neighbour cell at
//                          HALF_OFFSETS[m], box shift added, cells across an
//                          open face at 3e6 (prep_neighbors)
//   dF  [cap, NC], dFn [NOF, cap, NC]   K11: the half embedding derivative
//                          and its 13 views
// Outputs:
//   K10  out_i [nk, cap, NC], out_j [nk, NOF, cap, NC] (rho, then nn when
//        counting: nk = 2)
//   K11  out_i [3, cap, NC],  out_j [3, NOF, cap, NC]   (fx, fy, fz)
//   K12  out_i [nk, cap, NC], out_j [nk, NOF, cap, NC]  (fx, fy, fz, then e
//        when asked, then nn when counting), out_s [6, cap, NC] (stress
//        xx yy zz yz zx xy, i side only: each pair is booked once; null
//        when not asked)
//
// Half stencil: the own cell with i < j, then the 13 views, so each pair of
// the lattice is evaluated exactly once.  A pair's value goes to the i-sum of
// slot i and to the j-partial of slot j of its view.  In the own cell both
// land in the i-sums (i-sum over j > s plus j-sum over i < s).  Nothing is
// masked: the contract is unmasked, as on the TPU.  Two dead slots of one
// cell sit at r^2 = 0, inside the cutoff, and are counted; their outputs are
// garbage that the callers mask (live slots are ~1e6 away from any dead slot
// and ~3e6 from an invalid cell, so the outputs of live slots are exact).
//
// Design.  One block takes CPB cells (8 when shared memory allows) and one
// thread per (slot s, cell): threadIdx.x = s * CPB + cell, so a warp reads 8
// consecutive cells of 4 slots (full 32-byte sectors of the cells-last
// arrays).  Per offset, every thread stages slot s of the view (and its dF)
// in shared memory; then as slot i it runs over the cap staged slots j,
// sums its i-side contributions in registers and writes each pair's value
// (rho(r^2) in K10, the gradient in K11) into a [cap][cap] scratch per cell;
// after a barrier, as slot j it sums its column of the scratch in the fixed
// order i = 0..cap-1.  K11 books g * (x_i - x_j) on the j side; it
// recomputes x_i - x_j from the staged positions, with the same operands, so
// with the same bits, and the count of K10's j side recomputes r^2 the same
// way.  No atomics: every run gives the same bits.
//
// What bounds it on the H100.  Each thread runs cap candidates per offset,
// 14 * cap in all (224 at cap 16; K1/K2 walk 27 * cap = 432), for ~8% in-
// cutoff pairs, and a warp evaluates a Horner whenever one of its lanes is
// inside (almost always): the polynomial work bounds it, as for K1/K2, at
// half their candidates.  The bytes (nbr and the j-partials, ~13x the state)
// are ~1/3 GB at the flagship's 1M atoms, ~0.1 ms at the memory rate.
// Later work: fuse the 13 roll-backs of _assemble into the kernel, skip
// empty cells, and build the views in the kernel.
//
// K12 is K11's design for one pair table: the scratch holds the gradient
// g = 2 dphi/dr^2 and, when the energy is asked, phi; the j side
// recomputes x_i - x_j (and r^2 for the count) from the staged positions.
// Per offset it adds -sum_j g d_a d_b to six stress sums of slot i.  Its
// bytes are K11's less dF: the views in, five outputs and their 13
// j-partials out (~0.5 GB at the flagship's 1M atoms, ~0.15 ms).
//
// Rounding: compiled with -fmad=false (kernels.py), like eam_win.cu.

#include "eam_common.cuh"

#define NOF 13
#define MAX_CPB 8
#define MAX_THREADS 256
#define MAX_SMEM 232448   // shared memory a block can use (227 KB)

// Staged arrays are [field][cap][cpb]; element (k, slot, cell).
#define ST(arr, k, slot) arr[((k) * cap + (slot)) * cpb + cl]

__global__ void __launch_bounds__(MAX_THREADS)
eam_rho_half_kernel(const float* __restrict__ xi,
                    const float* __restrict__ nbr,
                    float* __restrict__ out_i, float* __restrict__ out_j,
                    int count, float nr2, int nc, int cpb,
                    const __grid_constant__ EamParams P) {
    extern __shared__ float sm[];
    const int cap = P.cap;
    const int cl = threadIdx.x % cpb, s = threadIdx.x / cpb;
    const int c = blockIdx.x * cpb + cl;
    const bool ok = c < nc;
    const size_t n = (size_t)nc;
    float* xs = sm;                     // [3][cap][cpb] own cell
    float* xv = xs + 3 * cap * cpb;     // [3][cap][cpb] view m
    float* sc = xv + 3 * cap * cpb;     // [cap i][cap j][cpb] rho(r^2)
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (ok) {
        x = xi[(3 * (size_t)s) * n + c];
        y = xi[(3 * (size_t)s + 1) * n + c];
        z = xi[(3 * (size_t)s + 2) * n + c];
    }
    ST(xs, 0, s) = x;
    ST(xs, 1, s) = y;
    ST(xs, 2, s) = z;
    float rho = 0.0f, cnt = 0.0f;
    for (int m = 0; m <= NOF; ++m) {
        const float* v = xs;
        if (m > 0) {
            if (ok) {
                const float* src = nbr + (((size_t)(m - 1) * cap + s) * 3) * n
                    + c;
                ST(xv, 0, s) = src[0];
                ST(xv, 1, s) = src[n];
                ST(xv, 2, s) = src[2 * n];
            }
            v = xv;
        }
        __syncthreads();
        // as slot i of the own cell, against the cap slots of view m
        float ri = 0.0f, ni = 0.0f;
        for (int j = 0; j < cap; ++j) {
            const float dx = x - ST(v, 0, j);
            const float dy = y - ST(v, 1, j);
            const float dz = z - ST(v, 2, j);
            const float r2 = dx * dx + dy * dy + dz * dz;
            float rv = 0.0f;
            if (r2 < P.rcut2 && (m > 0 || s < j)) {
                rv = poly_eval(P.rho_v, r2);
                if (r2 < nr2) ni += 1.0f;
            }
            ri += rv;
            sc[(s * cap + j) * cpb + cl] = rv;
        }
        __syncthreads();
        // as slot j of view m, against the cap slots of the own cell
        float rj = 0.0f, nj = 0.0f;
        const float xj = ST(v, 0, s), yj = ST(v, 1, s), zj = ST(v, 2, s);
        for (int i = 0; i < cap; ++i) {
            rj += sc[(i * cap + s) * cpb + cl];
            if (count) {
                const float dx = ST(xs, 0, i) - xj;
                const float dy = ST(xs, 1, i) - yj;
                const float dz = ST(xs, 2, i) - zj;
                const float r2 = dx * dx + dy * dy + dz * dz;
                if (r2 < P.rcut2 && (m > 0 || i < s) && r2 < nr2)
                    nj += 1.0f;
            }
        }
        if (m == 0) {
            rho = ri + rj;
            cnt = ni + nj;
        } else {
            rho += ri;
            cnt += ni;
            if (ok) {
                const size_t jo = ((size_t)(m - 1) * cap + s) * n + c;
                out_j[jo] = rj;
                if (count) out_j[(size_t)NOF * cap * n + jo] = nj;
            }
        }
        __syncthreads();   // the next offset rewrites xv and sc
    }
    if (ok) {
        out_i[(size_t)s * n + c] = rho;
        if (count) out_i[((size_t)cap + s) * n + c] = cnt;
    }
}

__global__ void __launch_bounds__(MAX_THREADS)
eam_force_half_kernel(const float* __restrict__ xi,
                      const float* __restrict__ nbr,
                      const float* __restrict__ dF,
                      const float* __restrict__ dFn,
                      float* __restrict__ out_i, float* __restrict__ out_j,
                      int nc, int cpb, const __grid_constant__ EamParams P) {
    extern __shared__ float sm[];
    const int cap = P.cap;
    const int cl = threadIdx.x % cpb, s = threadIdx.x / cpb;
    const int c = blockIdx.x * cpb + cl;
    const bool ok = c < nc;
    const size_t n = (size_t)nc;
    float* xs = sm;                     // [3][cap][cpb] own cell
    float* ds = xs + 3 * cap * cpb;     // [cap][cpb] own dF
    float* xv = ds + cap * cpb;         // [3][cap][cpb] view m
    float* dv = xv + 3 * cap * cpb;     // [cap][cpb] dF of view m
    float* sc = dv + cap * cpb;         // [cap i][cap j][cpb] gradient
    float x = 0.0f, y = 0.0f, z = 0.0f, dfi = 0.0f;
    if (ok) {
        x = xi[(3 * (size_t)s) * n + c];
        y = xi[(3 * (size_t)s + 1) * n + c];
        z = xi[(3 * (size_t)s + 2) * n + c];
        dfi = dF[(size_t)s * n + c];
    }
    ST(xs, 0, s) = x;
    ST(xs, 1, s) = y;
    ST(xs, 2, s) = z;
    ST(ds, 0, s) = dfi;
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;
    const size_t plane = (size_t)NOF * cap * n;   // one component of out_j
    for (int m = 0; m <= NOF; ++m) {
        const float* v = xs;
        const float* dvv = ds;
        if (m > 0) {
            if (ok) {
                const float* src = nbr + (((size_t)(m - 1) * cap + s) * 3) * n
                    + c;
                ST(xv, 0, s) = src[0];
                ST(xv, 1, s) = src[n];
                ST(xv, 2, s) = src[2 * n];
                ST(dv, 0, s) = dFn[((size_t)(m - 1) * cap + s) * n + c];
            }
            v = xv;
            dvv = dv;
        }
        __syncthreads();
        // as slot i: sum_j g (x_i - x_j), booked with a minus sign
        float gx = 0.0f, gy = 0.0f, gz = 0.0f;
        for (int j = 0; j < cap; ++j) {
            const float dx = x - ST(v, 0, j);
            const float dy = y - ST(v, 1, j);
            const float dz = z - ST(v, 2, j);
            const float r2 = dx * dx + dy * dy + dz * dz;
            float g = 0.0f;
            if (r2 < P.rcut2 && (m > 0 || s < j))
                g = poly_eval(P.pair_g, r2)
                    + (dfi + ST(dvv, 0, j)) * poly_eval(P.rho_g, r2);
            gx += g * dx;
            gy += g * dy;
            gz += g * dz;
            sc[(s * cap + j) * cpb + cl] = g;
        }
        __syncthreads();
        // as slot j of view m: +sum_i g (x_i - x_j)
        float hx = 0.0f, hy = 0.0f, hz = 0.0f;
        const float xj = ST(v, 0, s), yj = ST(v, 1, s), zj = ST(v, 2, s);
        for (int i = 0; i < cap; ++i) {
            const float g = sc[(i * cap + s) * cpb + cl];
            hx += g * (ST(xs, 0, i) - xj);
            hy += g * (ST(xs, 1, i) - yj);
            hz += g * (ST(xs, 2, i) - zj);
        }
        if (m == 0) {
            fx = -gx + hx;
            fy = -gy + hy;
            fz = -gz + hz;
        } else {
            fx += -gx;
            fy += -gy;
            fz += -gz;
            if (ok) {
                const size_t jo = ((size_t)(m - 1) * cap + s) * n + c;
                out_j[jo] = hx;
                out_j[plane + jo] = hy;
                out_j[2 * plane + jo] = hz;
            }
        }
        __syncthreads();   // the next offset rewrites xv, dv and sc
    }
    if (ok) {
        const size_t io = (size_t)s * n + c;
        const size_t cs = (size_t)cap * n;
        out_i[io] = fx;
        out_i[cs + io] = fy;
        out_i[2 * cs + io] = fz;
    }
}

__global__ void __launch_bounds__(MAX_THREADS)
pair_half_kernel(const float* __restrict__ xi, const float* __restrict__ nbr,
                 float* __restrict__ out_i, float* __restrict__ out_s,
                 float* __restrict__ out_j, int energy, int count, float nr2,
                 int nc, int cpb, const __grid_constant__ EamParams P) {
    extern __shared__ float sm[];
    const int cap = P.cap;
    const int cl = threadIdx.x % cpb, s = threadIdx.x / cpb;
    const int c = blockIdx.x * cpb + cl;
    const bool ok = c < nc;
    const size_t n = (size_t)nc;
    const int ke = 3, kn = 3 + energy;  // output rows of e and nn
    float* xs = sm;                     // [3][cap][cpb] own cell
    float* xv = xs + 3 * cap * cpb;     // [3][cap][cpb] view m
    float* sg = xv + 3 * cap * cpb;     // [cap i][cap j][cpb] gradient
    float* se = sg + cap * cap * cpb;   // [cap i][cap j][cpb] phi
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (ok) {
        x = xi[(3 * (size_t)s) * n + c];
        y = xi[(3 * (size_t)s + 1) * n + c];
        z = xi[(3 * (size_t)s + 2) * n + c];
    }
    ST(xs, 0, s) = x;
    ST(xs, 1, s) = y;
    ST(xs, 2, s) = z;
    float fx = 0.0f, fy = 0.0f, fz = 0.0f, e = 0.0f, cnt = 0.0f;
    float st[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const size_t plane = (size_t)NOF * cap * n;   // one row of out_j
    for (int m = 0; m <= NOF; ++m) {
        const float* v = xs;
        if (m > 0) {
            if (ok) {
                const float* src = nbr + (((size_t)(m - 1) * cap + s) * 3) * n
                    + c;
                ST(xv, 0, s) = src[0];
                ST(xv, 1, s) = src[n];
                ST(xv, 2, s) = src[2 * n];
            }
            v = xv;
        }
        __syncthreads();
        // as slot i of the own cell, against the cap slots of view m
        float gx = 0.0f, gy = 0.0f, gz = 0.0f, ei = 0.0f, ni = 0.0f;
        float sxx = 0.0f, syy = 0.0f, szz = 0.0f;
        float syz = 0.0f, szx = 0.0f, sxy = 0.0f;
        for (int j = 0; j < cap; ++j) {
            const float dx = x - ST(v, 0, j);
            const float dy = y - ST(v, 1, j);
            const float dz = z - ST(v, 2, j);
            const float r2 = dx * dx + dy * dy + dz * dz;
            float g = 0.0f, phi = 0.0f;
            if (r2 < P.rcut2 && (m > 0 || s < j)) {
                g = poly_eval(P.pair_g, r2);
                if (energy) phi = poly_eval(P.pair_v, r2);
                if (r2 < nr2) ni += 1.0f;
            }
            const float gdx = g * dx, gdy = g * dy, gdz = g * dz;
            gx += gdx;
            gy += gdy;
            gz += gdz;
            sxx += gdx * dx;
            syy += gdy * dy;
            szz += gdz * dz;
            syz += gdy * dz;
            szx += gdz * dx;
            sxy += gdx * dy;
            ei += phi;
            sg[(s * cap + j) * cpb + cl] = g;
            if (energy) se[(s * cap + j) * cpb + cl] = phi;
        }
        __syncthreads();
        // as slot j of view m, against the cap slots of the own cell
        float hx = 0.0f, hy = 0.0f, hz = 0.0f, ej = 0.0f, nj = 0.0f;
        const float xj = ST(v, 0, s), yj = ST(v, 1, s), zj = ST(v, 2, s);
        for (int i = 0; i < cap; ++i) {
            const float g = sg[(i * cap + s) * cpb + cl];
            const float dx = ST(xs, 0, i) - xj;
            const float dy = ST(xs, 1, i) - yj;
            const float dz = ST(xs, 2, i) - zj;
            hx += g * dx;
            hy += g * dy;
            hz += g * dz;
            if (energy) ej += se[(i * cap + s) * cpb + cl];
            if (count) {
                const float r2 = dx * dx + dy * dy + dz * dz;
                if (r2 < P.rcut2 && (m > 0 || i < s) && r2 < nr2)
                    nj += 1.0f;
            }
        }
        st[0] += -sxx;
        st[1] += -syy;
        st[2] += -szz;
        st[3] += -syz;
        st[4] += -szx;
        st[5] += -sxy;
        if (m == 0) {
            fx = -gx + hx;
            fy = -gy + hy;
            fz = -gz + hz;
            e = 0.5f * ei + 0.5f * ej;
            cnt = ni + nj;
        } else {
            fx += -gx;
            fy += -gy;
            fz += -gz;
            e += 0.5f * ei;
            cnt += ni;
            if (ok) {
                const size_t jo = ((size_t)(m - 1) * cap + s) * n + c;
                out_j[jo] = hx;
                out_j[plane + jo] = hy;
                out_j[2 * plane + jo] = hz;
                if (energy) out_j[ke * plane + jo] = 0.5f * ej;
                if (count) out_j[kn * plane + jo] = nj;
            }
        }
        __syncthreads();   // the next offset rewrites xv and the scratch
    }
    if (ok) {
        const size_t io = (size_t)s * n + c;
        const size_t cs = (size_t)cap * n;
        out_i[io] = fx;
        out_i[cs + io] = fy;
        out_i[2 * cs + io] = fz;
        if (energy) out_i[ke * cs + io] = e;
        if (count) out_i[kn * cs + io] = cnt;
        if (out_s != nullptr)
            for (int k = 0; k < 6; ++k) out_s[k * cs + io] = st[k];
    }
}

// Cells per block: the most (up to MAX_CPB, halving) whose threads and
// shared memory (``per_cell`` floats a cell) fit; 0 if one cell does not.
static int cells_per_block(int cap, int per_cell, size_t* smem) {
    for (int cpb = MAX_CPB; cpb >= 1; cpb /= 2) {
        const size_t bytes = (size_t)cpb * per_cell * sizeof(float);
        if (cpb * cap <= MAX_THREADS && bytes <= MAX_SMEM) {
            *smem = bytes;
            return cpb;
        }
    }
    return 0;
}

template <typename K>
static cudaError_t prepare(K kernel, int cap, int per_cell, int* cpb,
                           size_t* smem) {
    *cpb = cells_per_block(cap, per_cell, smem);
    if (*cpb == 0 || cap < 1) return cudaErrorInvalidConfiguration;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
}

extern "C" int imd_eam_rho_half(const void* xi, const void* nbr, void* out_i,
                                void* out_j, int count, float nr2,
                                const EamParams* p, int nc, void* stream) {
    const int cap = p->cap;
    int cpb;
    size_t smem;
    cudaError_t err = prepare(eam_rho_half_kernel, cap, cap * (cap + 6),
                              &cpb, &smem);
    if (err != cudaSuccess) return (int)err;
    eam_rho_half_kernel<<<(nc + cpb - 1) / cpb, cpb * cap, smem,
                          STREAM(stream)>>>(
        (const float*)xi, (const float*)nbr, (float*)out_i, (float*)out_j,
        count, nr2, nc, cpb, *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_eam_force_half(const void* xi, const void* nbr,
                                  const void* dF, const void* dFn,
                                  void* out_i, void* out_j,
                                  const EamParams* p, int nc, void* stream) {
    const int cap = p->cap;
    int cpb;
    size_t smem;
    cudaError_t err = prepare(eam_force_half_kernel, cap, cap * (cap + 8),
                              &cpb, &smem);
    if (err != cudaSuccess) return (int)err;
    eam_force_half_kernel<<<(nc + cpb - 1) / cpb, cpb * cap, smem,
                            STREAM(stream)>>>(
        (const float*)xi, (const float*)nbr, (const float*)dF,
        (const float*)dFn, (float*)out_i, (float*)out_j, nc, cpb, *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_pair_half(const void* xi, const void* nbr, void* out_i,
                             void* out_s, void* out_j, int energy, int count,
                             float nr2, const EamParams* p, int nc,
                             void* stream) {
    const int cap = p->cap;
    int cpb;
    size_t smem;
    cudaError_t err = prepare(pair_half_kernel, cap, cap * (2 * cap + 6),
                              &cpb, &smem);
    if (err != cudaSuccess) return (int)err;
    pair_half_kernel<<<(nc + cpb - 1) / cpb, cpb * cap, smem,
                       STREAM(stream)>>>(
        (const float*)xi, (const float*)nbr, (float*)out_i, (float*)out_s,
        (float*)out_j, energy, count, nr2, nc, cpb, *p);
    return (int)cudaGetLastError();
}
