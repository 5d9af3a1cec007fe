// Shared by the stencil kernels of eam_win.cu and eam_half.cu: the
// polynomial form of the fitted EAM tables and the kernels' parameter block
// (mirrored by kernels.Poly and kernels.EamParams).  Polynomial convention
// (imd_tpu/ops/forces_pallas.py:55-109): t = clip(x*a - b0, -1, 1) with
// a = 2/(e-b), b0 = b*a + 1; the derivative polynomials carry the chain
// factor 4/(e-b) and give 2 dV/dr^2.

#pragma once

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

#define STREAM(s) ((cudaStream_t)(s))
