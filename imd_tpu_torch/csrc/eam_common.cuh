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

// Launch tile of the full-stencil kernels (eam_win.cu), chosen on the host
// (ops/forces_win.py:win_tile) and checked by the C entries (tile_ok); the
// half-stencil kernels leave it at zero.  Byte offsets are into the block's
// dynamic shared memory.
struct WinTile {
    int tx, ty, tz;   // cells per block along x, y, z
    int ntx, nty, ntz;  // blocks along x, y, z
    int threads;      // block size, a multiple of 32
    int list_len;     // entries of each thread's pair list
    int pos_off;      // [rows][cap][tz + 2] float4 slots of the halo tile,
                      // rows = (tx + 2) * (ty + 2)
    int tab_off;      // multi-type coefficient rows
    int typ_off;      // [rows][cap][tz + 2] int8 types (multi-type)
    int list_off;     // [list_len][threads] uint16 pair lists
    int smem;         // bytes in all
};

// Launch shape of the half-stencil kernels K10-K12 (eam_half.cu), chosen on
// the host (ops/forces_win.py:half_tile) and checked by their C entries
// (half_ok); the full-stencil kernels leave it at zero.
struct HalfTile {
    int cpb;          // cells per block
    int threads;      // block size: cap * cpb rounded up to whole warps
    int smem;         // bytes of dynamic shared memory
    float dead;       // a slot whose x is at or above this is dead
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
    WinTile tile;
    HalfTile half;
};

__device__ __forceinline__ float poly_eval(const Poly& p, float x) {
    const float t = fminf(fmaxf(x * p.a - p.b0, -1.0f), 1.0f);
    float v = p.c[NPOLY - 1];
#pragma unroll
    for (int k = NPOLY - 2; k >= 0; --k) v = v * t + p.c[k];
    return v;
}

#define STREAM(s) ((cudaStream_t)(s))
