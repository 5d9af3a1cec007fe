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
// Design.  Every slot i sums over the FULL 27-cell stencil -- its own cell
// without itself and all 26 neighbours -- and writes its outputs exactly
// once: no atomics, no j-side partner buffers, no roll-back pass, and the
// same bits on every run.  A block owns a tile of tx x ty x tz cells (tx,
// ty <= 2, tz <= 8), one thread per (cell, slot) with the slots of a cell
// in consecutive lanes (threadIdx.x = ((lx*ty + ly)*tz + lz)*cap + s).
// The host chooses the tile and its shared-memory layout
// (ops/forces_win.py:win_tile) and passes it in EamParams.tile; tile_ok
// checks it before the launch.
//   1. Staging.  The block copies its tile with the one-cell halo, (tx + 2)
//      x (ty + 2) x (tz + 2) cells, into shared memory once: per slot a
//      float4 of the position with the periodic box shift of its image
//      added (the plain version's rounding, x_i - (x_j + s), since x_j + s
//      is rounded once either way) and, in the force pass, dF_j in w; MT
//      stages the type beside it in an int8 array.  Then each cell's live
//      slots move to its front, in their order, and the cell keeps its
//      count (compact): dead slots and cells across a non-periodic face are
//      never scanned, and no wrap logic, alive test or 64-bit index
//      arithmetic is left for the scan.  The copy goes through registers,
//      indexed (cell row, slot, z) with z fastest, so global loads run
//      along the contiguous z rows and shared stores are consecutive, and
//      every load of the unrolled loop is issued before its use.  Other
//      resident blocks compute while one stages: a variant that copies the
//      raw rows with 4-byte cp.async and adds the shift while it compacts
//      gave the same bits and K1/K2 within 0.5% (0.428 / 0.484 against
//      0.430 / 0.485 ms; NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6).
//   2. The scan.  Thread (cell, slot i) walks the 27 cells in the order
//      o = ((ox*3 + oy)*3 + oz), and their live slots t ascending: one
//      broadcast shared load (the lanes of one cell read the same
//      candidate), r^2 in six FP operations, one compare.  A candidate
//      inside the cutoff appends its 16-bit tile index to the thread's
//      list in shared memory ([list_len][threads]: lanes of one entry are
//      consecutive) with one st.shared.  The test is a filter (fused
//      multiply-adds, a cutoff widened by 2^-20); the flush decides.
//   3. The flush.  The polynomials run over the list, so a warp evaluates
//      them as often as its longest list, not at every candidate that one
//      of its 32 lanes finds inside the cutoff (~93% of them).  Before
//      each cell the warp flushes when any lane's list could overflow in
//      that cell (list_len = cap + 64 entries: fewer flushes, whose cost
//      is the longest list of the warp, against shared memory per block),
//      so the list is bounded at any density.  A flush step takes FLUSH_W
//      entries without branches; it re-reads each candidate and
//      recomputes the rounded r^2 with the plain version's operands, so
//      with its bits, and the pair counts when that r^2 is below rcut2
//      and it is not the own slot.  Entries are summed in the order they
//      were found, so every sum is formed in the order o, then t, as the
//      plain loop forms it.
//   4. The Horner stops at the fits' degree: 12 for a value, 11 for a
//      derivative (the port's fits are degree 12, eam_to_fastpoly; the
//      wrapper refuses a higher one).  The dropped steps of the padded
//      NPOLY - 1 = 15 were 0*t + 0: the same bits.
// A block whose cells hold no live slot writes zeros and returns before
// staging (the run1m film leaves 58% of its cells empty); a warp with no
// live lane skips the scan.  The kernels carry no __launch_bounds__: with
// (512) ptxas holds K1, K2, K4 and K5 at 40 registers and K5 spills;
// without, they take 40-56 registers, none spills, and K1/K2 run 1-2%
// faster (PERF.md section 6).
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
// What bounds it on the H100.  Instruction issue and latency, not bytes
// or FLOPs: per live slot the scan walks 27 cells of ~13.5 live slots at
// the flagship (~365 candidates) at ~12 warp instructions each, and the
// flushes run each lane's listed pairs (a slot has ~34 inside the
// cutoff, 8% of its candidates) as long as the warp's longest list, each
// pair a ~40-deep chain of unfused operations; the staging restages each
// slot ~5 times.  At the flagship's shapes (1,000,188 atoms, grid 42^3,
// cap 16, tile 2 x 2 x 7) K1 takes 0.43 ms: staging 0.08, scan 0.27,
// flush 0.09; K2 0.49 ms: 0.10, 0.26, 0.13 (NVIDIA H100 80GB HBM3, 700 W;
// variants of this file built without the scan and without the flush,
// PERF.md section 6).  The bytes (each slot read once, each output written
// once: 25-66 MB) and the FLOPs of the in-cutoff pairs alone bound it
// 20-50x lower (PERF.md section 6).
//
// Rounding.  This file is compiled with -fmad=false (kernels.py): every
// multiply and add rounds on its own, as torch's eager mul + add do, so
// the kernels round like their plain versions.  With FMA contraction the
// degree-12 fits (monomial coefficients up to ~300, sum of |c_k| ~1500 for
// phi and ~2400 for its derivative) move each pair's value or gradient by
// up to ~1e-4 in float32: more than the 1e-5 of max|epot| the energy is
// held to, and, on the near-equilibrium film of the 1M-atom driver run
// (max|F| 16 eV/A), more than the 1e-4 of max|F| the forces are held to.
//
// Types (MT).  The Pallas alloy kernels evaluate every column's polynomial
// for every candidate and combine them with one-hot weights, because the
// TPU has no per-lane gather.  Here a thread knows its own type t_i, reads
// t_j with the listed pair, and evaluates ONE column per table:
//   phi, phi'  col = t_i*nt + t_j          (symmetric: the wrapper refuses
//                                           asymmetric pair tables)
//   rho_i +=   col = t_j*nt + t_i          (source first: density at i
//                                           from j)
//   grad = phi'(t_i,t_j) + dF_i rho'(t_j,t_i) + dF_j rho'(t_i,t_j).
// The 0/1-weighted sum is exact, so the selected column gives the same
// value.  typ [cap, NC] int32 takes the place of the alive bytes: a slot
// is dead where typ < 0, and types above nt - 1 are clipped to it, as the
// TPU kernels clip.
//
// Where the MT coefficients live.  At nt = 4 the four tables hold 64
// polynomials of NPOLY + 2 floats, 4.6 kB: more than the 4 kB of kernel
// parameters, and a __constant__ table indexed by a column that differs
// across a warp would serialise its reads.  They sit in a small device
// buffer [4 tables][nt*nt columns][NPOLY + 2] made once per potential
// (ops/forces_win.py), and every block copies the two tables its kernel
// reads into shared memory while it stages (at most 2.3 kB).  The row
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
// order of the tables in the device buffer: the R pass reads the first
// two, the F pass the last two
enum { T_RHO_V = 0, T_PAIR_V = 1, T_PAIR_G = 2, T_RHO_G = 3 };

#define DEG_V 12               // degree of the value fits
#define DEG_G 11               // of their derivatives
#define WIN_MAX_TXY 2          // cells along x and along y per block
#define WIN_MAX_TZ 8           // cells along z per block
#define WIN_MAX_THREADS 512
#define WIN_MAX_SMEM 232448    // a block's shared memory on the H100
#define FAR 1.0e18f            // staged position of dead and cut-off slots
#define FLUSH_W 2              // list entries a flush step evaluates
#define FULL 0xffffffffu

template <int DEG>
__device__ __forceinline__ float horner(const float* __restrict__ c,
                                        float a, float b0, float x) {
    const float t = fminf(fmaxf(x * a - b0, -1.0f), 1.0f);
    float v = c[DEG];
#pragma unroll
    for (int k = DEG - 1; k >= 0; --k) v = v * t + c[k];
    return v;
}

template <int DEG>
__device__ __forceinline__ float poly(const Poly& p, float x) {
    return horner<DEG>(p.c, p.a, p.b0, x);
}

template <int DEG>
__device__ __forceinline__ float poly_row(const float* __restrict__ p,
                                          float x) {
    return horner<DEG>(p, p[NPOLY], p[NPOLY + 1], x);
}

// The block's view of its dynamic shared memory (layout: EamParams.tile).
// The halo tile holds rows = (tx + 2) * (ty + 2) columns of tz + 2 cells;
// row = hx * (ty + 2) + hy.
struct Tile {
    float4* cells;    // [rows][tz2]: box shift, source cell (int bits) or -1
    float4* pos;      // [rows][cap][tz2]: x, y, z + shift; dF_j (force pass)
    float* tab;       // two MT tables of nt*nt rows
    int8_t* typ;      // [rows][cap][tz2] (MT)
    uint16_t* list;   // [list_len][threads]
    int tz2, ty2;     // tz + 2, ty + 2
    int x0, y0, z0;   // the block's first cell
};

// Where thread (lx, ly, lz, s) of this block sits (threadIdx.x =
// ((lx*ty + ly)*tz + lz)*cap + s); ``mine`` false for a padding thread or
// a cell past the end of the grid.  A padding thread (the whole warps'
// last lanes past tx*ty*tz*cap) sits at (0, 0, 0, 0), so its stencil stays
// in the tile; as it is not live, it scans from a far position and lists
// nothing.
struct Slot {
    int lx, ly, lz, s, c;
    bool mine;
};

__device__ __forceinline__ Tile carve(const EamParams& P, Slot& me) {
    extern __shared__ __align__(16) unsigned char smem[];
    const WinTile& w = P.tile;
    Tile T;
    T.cells = reinterpret_cast<float4*>(smem);
    T.pos = reinterpret_cast<float4*>(smem + w.pos_off);
    T.tab = reinterpret_cast<float*>(smem + w.tab_off);
    T.typ = reinterpret_cast<int8_t*>(smem + w.typ_off);
    T.list = reinterpret_cast<uint16_t*>(smem + w.list_off);
    T.tz2 = w.tz + 2;
    T.ty2 = w.ty + 2;
    const int bz = blockIdx.x % w.ntz, bxy = blockIdx.x / w.ntz;
    const int by = bxy % w.nty, bx = bxy / w.nty;
    T.x0 = bx * w.tx;
    T.y0 = by * w.ty;
    T.z0 = bz * w.tz;
    const int l0 = threadIdx.x / P.cap;
    const bool pad = l0 >= w.tx * w.ty * w.tz;
    const int l = pad ? 0 : l0;
    me.s = pad ? 0 : threadIdx.x - l0 * P.cap;
    me.lz = l % w.tz;
    me.ly = (l / w.tz) % w.ty;
    me.lx = l / (w.tz * w.ty);
    me.mine = !pad && T.x0 + me.lx < P.gx && T.y0 + me.ly < P.gy
        && T.z0 + me.lz < P.gz;
    me.c = ((T.x0 + me.lx) * P.gy + T.y0 + me.ly) * P.gz + T.z0 + me.lz;
    return T;
}

// Stage the halo tile (and, with MT, ``ntab`` coefficient tables from
// ``first`` on), dead and cut-off slots at FAR; ends with a barrier.
// FORCE puts dF_j in the w lanes.
template <bool FORCE, bool MT>
__device__ __forceinline__ void stage(const EamParams& P, const Tile& T,
                                      const float* __restrict__ xi,
                                      const uint8_t* __restrict__ alive,
                                      const int32_t* __restrict__ typ,
                                      const float* __restrict__ dF,
                                      const float* __restrict__ tab,
                                      int first, int ntab, int nt, int nc) {
    const int tz2 = T.tz2, cap = P.cap, nthr = blockDim.x;
    const int rows = (P.tile.tx + 2) * T.ty2;
    // the rows * tz2 source cells and their periodic shifts
    for (int k = threadIdx.x; k < rows * tz2; k += nthr) {
        const int r = k / tz2, hz = k - r * tz2;
        const int hx = r / T.ty2, hy = r - hx * T.ty2;
        int jx = T.x0 + hx - 1, jy = T.y0 + hy - 1, jz = T.z0 + hz - 1;
        const int wx = jx < 0 ? -1 : (jx >= P.gx ? 1 : 0);
        const int wy = jy < 0 ? -1 : (jy >= P.gy ? 1 : 0);
        const int wz = jz < 0 ? -1 : (jz >= P.gz ? 1 : 0);
        const bool cut = (wx && !P.pbc[0]) || (wy && !P.pbc[1])
            || (wz && !P.pbc[2]);
        jx -= wx * P.gx;
        jy -= wy * P.gy;
        jz -= wz * P.gz;
        const float fx = (float)wx, fy = (float)wy, fz = (float)wz;
        T.cells[k] = make_float4(
            fx * P.h[0] + fy * P.h[3] + fz * P.h[6],
            fx * P.h[1] + fy * P.h[4] + fz * P.h[7],
            fx * P.h[2] + fy * P.h[5] + fz * P.h[8],
            __int_as_float(cut ? -1 : (jx * P.gy + jy) * P.gz + jz));
    }
    if constexpr (MT) {
        const int nrow = nt * nt;
        const float* src = tab + (size_t)first * nrow * PROW;
        for (int k = threadIdx.x; k < ntab * nrow * PROW; k += nthr)
            T.tab[k] = src[k];
    }
    __syncthreads();
    // the slots, k = (r*cap + t)*tz2 + hz, with (hz, t, r) advanced by
    // nthr each step instead of divided out
    const size_t n = (size_t)nc;
    int hz = threadIdx.x % tz2, row = threadIdx.x / tz2;
    int t = row % cap, r = row / cap;
    const int dhz = nthr % tz2, drow = nthr / tz2;
    const int dt = drow % cap, dr = drow / cap;
    const int nslots = rows * cap * tz2;
#pragma unroll 4
    for (int k = threadIdx.x; k < nslots; k += nthr) {
        // every load is issued whether the slot is live or not (a cut-off
        // cell reads cell 0), so the unrolled loop keeps them in flight
        const float4 ci = T.cells[r * tz2 + hz];
        const int cj = max(__float_as_int(ci.w), 0);
        const size_t jo = (size_t)t * n + cj;
        const float px = xi[(3 * (size_t)t) * n + cj];
        const float py = xi[(3 * (size_t)t + 1) * n + cj];
        const float pz = xi[(3 * (size_t)t + 2) * n + cj];
        const float pw = FORCE ? dF[jo] : 0.0f;
        int ty = 0;
        bool live;
        if constexpr (MT) {
            ty = typ[jo];
            live = ty >= 0;
            ty = live ? min(ty, nt - 1) : 0;
        } else {
            live = alive[jo] != 0;
        }
        live = live && __float_as_int(ci.w) >= 0;
        T.pos[k] = live ? make_float4(px + ci.x, py + ci.y, pz + ci.z, pw)
                        : make_float4(FAR, FAR, FAR, 0.0f);
        if constexpr (MT) T.typ[k] = (int8_t)ty;
        hz += dhz;
        t += dt;
        r += dr;
        if (hz >= tz2) {
            hz -= tz2;
            ++t;
        }
        if (t >= cap) {
            t -= cap;
            ++r;
        }
    }
    __syncthreads();
}

// Scan the stencil cells from ``cell`` (o = 0..26) on, appending the tile
// index of every candidate inside the cutoff to this thread's list (entry
// k at list[k*threads + threadIdx.x]); stops before a cell in which some
// lane of the warp could overflow its list.  Returns the next cell (27
// when done) and the list length in n.  The test here is a filter: r^2
// with fused multiply-adds, against rcut2 widened by 2^-20 (the fused and
// the rounded r^2 of the plain version differ by a few ulp: all three
// terms are positive).  The flush recomputes the rounded r^2 and decides,
// and drops the own slot, which lists itself at r^2 = 0.  An append is one
// st.shared through a 32-bit address kept in a register, so that the
// compiler neither reloads the list's base nor holds the next candidates'
// loads behind it; the empty asm with a memory clobber at the end keeps
// the flush's reads of the list after the stores.
__device__ __forceinline__ int scan(const EamParams& P, const Tile& T,
                                    const Slot& me, float x, float y,
                                    float z, int cell, int& n) {
    const int cap = P.cap, tz2 = T.tz2, step = 2 * blockDim.x;
    const float lim = P.rcut2 * (1.0f + 0x1p-20f);
    const unsigned first =
        (unsigned)__cvta_generic_to_shared(T.list + threadIdx.x);
    const unsigned full = first + (P.tile.list_len - cap) * step;
    unsigned w = first;
    for (; cell < 27; ++cell) {
        if (__any_sync(FULL, w > full)) break;
        const int ox = cell / 9, oy = (cell / 3) % 3, oz = cell % 3;
        const int row = (me.lx + ox) * T.ty2 + me.ly + oy;
        const int live = __float_as_int(T.cells[row * tz2 + me.lz + oz].x);
        int q = row * cap * tz2 + me.lz + oz;
        const float4* __restrict__ pos = T.pos;
#pragma unroll 4
        for (int t = 0; t < live; ++t, q += tz2) {
            const float4 p = pos[q];
            const float dx = x - p.x, dy = y - p.y, dz = z - p.z;
            const float r2 = __fmaf_rn(dx, dx, __fmaf_rn(dy, dy, dz * dz));
            if (r2 < lim) {
                asm volatile("st.shared.u16 [%0], %1;"
                             :: "r"(w), "h"((unsigned short)q));
                w += step;
            }
        }
    }
    asm volatile("" ::: "memory");
    n = (int)(w - first) / step;
    return cell;
}

// The state of thread (lz, s) after staging: its position (far for a dead
// or padding slot, which then lists nothing), dF_i, its own tile index
// (-1 when dead) and the index its list is padded with.
struct Own {
    float x, y, z, dF;
    int self, pad;
};

__device__ __forceinline__ Own own_slot(const EamParams& P, const Tile& T,
                                        const Slot& me, bool live) {
    Own o{-FAR, -FAR, -FAR, 0.0f, -1, 0};
    if (live) {
        // the own cell: hx = lx + 1, hy = ly + 1, hz = lz + 1, no shift
        const int row = (me.lx + 1) * T.ty2 + me.ly + 1;
        const int b = row * P.cap * T.tz2 + me.lz + 1;
        const float4 p = T.pos[b + me.s * T.tz2];
        o.x = p.x;
        o.y = p.y;
        o.z = p.z;
        o.dF = p.w;
        // where compact() moves this slot: after the live slots below it
        int before = 0;
        for (int t = 0; t < me.s; ++t)
            before += T.pos[b + t * T.tz2].x != FAR;
        o.self = o.pad = b + before * T.tz2;
    }
    return o;
}

// Move the live slots of every staged cell to its front, in their order,
// and keep the count in the cell's x lane (its shift is applied): the scan
// then skips dead slots, and cells across an open face hold none.  Every
// sum is still formed over the same pairs in the order t ascending.  Runs
// after each thread has read its own slot (own_slot).
template <bool MT>
__device__ __forceinline__ void compact(const EamParams& P, const Tile& T) {
    __syncthreads();
    const int cap = P.cap, tz2 = T.tz2;
    const int ncell = (P.tile.tx + 2) * T.ty2 * tz2;
    for (int k = threadIdx.x; k < ncell; k += blockDim.x) {
        const int r = k / tz2, hz = k - r * tz2;
        const int b = r * cap * tz2 + hz;
        int live = 0;
        for (int t = 0; t < cap; ++t) {
            const float4 v = T.pos[b + t * tz2];
            if (v.x == FAR) continue;
            if (live != t) {
                T.pos[b + live * tz2] = v;
                if constexpr (MT) T.typ[b + live * tz2] = T.typ[b + t * tz2];
            }
            ++live;
        }
        T.cells[k].x = __int_as_float(live);
    }
    __syncthreads();
}

template <bool MT>
__device__ __forceinline__ bool slot_live(const Slot& me,
                                          const uint8_t* __restrict__ alive,
                                          const int32_t* __restrict__ typ,
                                          int nt, size_t io, int& ti) {
    ti = 0;
    if (!me.mine) return false;
    if constexpr (MT) {
        const int raw = typ[io];
        ti = raw >= 0 ? min(raw, nt - 1) : 0;
        return raw >= 0;
    } else {
        return alive[io] != 0;
    }
}

// One listed pair of a flush: the candidate's tile index and staged slot,
// the rounded differences and r^2, and whether it counts.
struct Pair {
    int q;
    float4 p;
    float dx, dy, dz, r2;
    bool in;
};

// Entries k .. k + FLUSH_W - 1 of this thread's list, taken FLUSH_W per
// step of a flush (k = 0 .. the warp's longest list), without branches:
// past the
// end of its list a thread reads its pad entry (its own slot, or tile slot
// 0 when dead: never inside the cutoff), and a pair outside the cutoff, or
// the own slot, does not count; the kernels add an exact 0 for it.  The
// entries' polynomials are independent; their sums are taken in list
// order.  So each sum is formed over the listed pairs in the order they
// were found: o, then t, as the plain loop forms it.
__device__ __forceinline__ void fetch(const EamParams& P, const Tile& T,
                                      const Own& o, int n, int k,
                                      Pair (&e)[FLUSH_W]) {
    const uint16_t* mine = T.list + threadIdx.x;
#pragma unroll
    for (int u = 0; u < FLUSH_W; ++u) {
        Pair& a = e[u];
        a.q = k + u < n ? (int)mine[(k + u) * blockDim.x] : o.pad;
        a.p = T.pos[a.q];
        a.dx = o.x - a.p.x;
        a.dy = o.y - a.p.y;
        a.dz = o.z - a.p.z;
        a.r2 = a.dx * a.dx + a.dy * a.dy + a.dz * a.dz;
        a.in = a.r2 < P.rcut2 && a.q != o.self;
    }
}

template <bool ENERGY, bool MT>
__global__ void
eam_rho_kernel(const float* __restrict__ xi,
               const uint8_t* __restrict__ alive,
               const int32_t* __restrict__ typ,
               const float* __restrict__ tab, int nt,
               float* __restrict__ rho, float* __restrict__ nn,
               float* __restrict__ e, int nc,
               const __grid_constant__ EamParams P) {
    Slot me;
    const Tile T = carve(P, me);
    const size_t io = (size_t)me.s * nc + me.c;
    int ti;
    const bool live = slot_live<MT>(me, alive, typ, nt, io, ti);
    float acc = 0.0f, eacc = 0.0f;
    int count = 0;
    if (__syncthreads_or(live)) {
        stage<false, MT>(P, T, xi, alive, typ, nullptr, tab, T_RHO_V,
                         ENERGY ? 2 : 1, nt, nc);
        const Own o = own_slot(P, T, me, live);
        compact<MT>(P, T);
        if (__any_sync(FULL, live)) {
            const float* rho_v = T.tab;
            const float* pair_v = T.tab + nt * nt * PROW;
            for (int cell = 0; cell < 27;) {
                int n;
                cell = scan(P, T, me, o.x, o.y, o.z, cell, n);
                const int m = __reduce_max_sync(FULL, n);
                for (int k = 0; k < m; k += FLUSH_W) {
                    Pair pr[FLUSH_W];
                    fetch(P, T, o, n, k, pr);
                    float v[FLUSH_W], ev[FLUSH_W] = {};
#pragma unroll
                    for (int u = 0; u < FLUSH_W; ++u) {
                        if constexpr (MT) {
                            const int tj = T.typ[pr[u].q];
                            // the density j (source) contributes at i (host)
                            v[u] = poly_row<DEG_V>(
                                rho_v + (tj * nt + ti) * PROW, pr[u].r2);
                            if constexpr (ENERGY)
                                ev[u] = poly_row<DEG_V>(
                                    pair_v + (ti * nt + tj) * PROW, pr[u].r2);
                        } else {
                            v[u] = poly<DEG_V>(P.rho_v, pr[u].r2);
                            if constexpr (ENERGY)
                                ev[u] = poly<DEG_V>(P.pair_v, pr[u].r2);
                        }
                    }
#pragma unroll
                    for (int u = 0; u < FLUSH_W; ++u) {
                        acc += pr[u].in ? v[u] : 0.0f;
                        if constexpr (ENERGY) eacc += pr[u].in ? ev[u] : 0.0f;
                        count += pr[u].in;
                    }
                }
            }
        }
    }
    if (me.mine) {
        rho[io] = acc;
        nn[io] = (float)count;
        if constexpr (ENERGY) e[io] = 0.5f * eacc;
    }
}

template <bool STRESS, bool MT>
__global__ void
eam_force_kernel(const float* __restrict__ xi,
                 const uint8_t* __restrict__ alive,
                 const int32_t* __restrict__ typ,
                 const float* __restrict__ tab, int nt,
                 const float* __restrict__ dF, float* __restrict__ F,
                 float* __restrict__ S, int nc,
                 const __grid_constant__ EamParams P) {
    Slot me;
    const Tile T = carve(P, me);
    const size_t n_ = (size_t)nc;
    const size_t io = (size_t)me.s * n_ + me.c;
    int ti;
    const bool live = slot_live<MT>(me, alive, typ, nt, io, ti);
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;
    // -sum_j grad d_a d_b in Voigt order xx yy zz yz zx xy
    float vxx = 0.0f, vyy = 0.0f, vzz = 0.0f;
    float vyz = 0.0f, vzx = 0.0f, vxy = 0.0f;
    if (__syncthreads_or(live)) {
        stage<true, MT>(P, T, xi, alive, typ, dF, tab, T_PAIR_G, 2, nt, nc);
        const Own o = own_slot(P, T, me, live);
        compact<MT>(P, T);
        if (__any_sync(FULL, live)) {
            const float* pair_g = T.tab;
            const float* rho_g = T.tab + nt * nt * PROW;
            for (int cell = 0; cell < 27;) {
                int n;
                cell = scan(P, T, me, o.x, o.y, o.z, cell, n);
                const int m = __reduce_max_sync(FULL, n);
                for (int k = 0; k < m; k += FLUSH_W) {
                    Pair pr[FLUSH_W];
                    fetch(P, T, o, n, k, pr);
                    float grad[FLUSH_W];
#pragma unroll
                    for (int u = 0; u < FLUSH_W; ++u) {
                        const float r2 = pr[u].r2;
                        if constexpr (MT) {
                            const int tj = T.typ[pr[u].q];
                            // rho' of the density at i from j, and at j
                            // from i
                            grad[u] = poly_row<DEG_G>(
                                          pair_g + (ti * nt + tj) * PROW, r2)
                                + o.dF * poly_row<DEG_G>(
                                      rho_g + (tj * nt + ti) * PROW, r2)
                                + pr[u].p.w * poly_row<DEG_G>(
                                      rho_g + (ti * nt + tj) * PROW, r2);
                        } else {
                            grad[u] = poly<DEG_G>(P.pair_g, r2)
                                + (o.dF + pr[u].p.w)
                                    * poly<DEG_G>(P.rho_g, r2);
                        }
                    }
#pragma unroll
                    for (int u = 0; u < FLUSH_W; ++u) {
                        const float g = pr[u].in ? grad[u] : 0.0f;
                        const float dx = pr[u].dx, dy = pr[u].dy,
                                    dz = pr[u].dz;
                        const float gx = g * dx, gy = g * dy, gz = g * dz;
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
    }
    if (!me.mine) return;
    F[(3 * (size_t)me.s) * n_ + me.c] = fx;
    F[(3 * (size_t)me.s + 1) * n_ + me.c] = fy;
    F[(3 * (size_t)me.s + 2) * n_ + me.c] = fz;
    if constexpr (STRESS) {
        // each pair is visited from both sides: each books half
        const size_t cs = (size_t)P.cap * n_;
        S[io] = 0.5f * vxx;
        S[cs + io] = 0.5f * vyy;
        S[2 * cs + io] = 0.5f * vzz;
        S[3 * cs + io] = 0.5f * vyz;
        S[4 * cs + io] = 0.5f * vzx;
        S[5 * cs + io] = 0.5f * vxy;
    }
}

// What the kernels assume of EamParams.tile (ops/forces_win.py:win_tile
// chooses it; tests/test_torch_stencil_tiles.py holds it to these rules).
static bool tile_ok(const EamParams& p, int nt, bool mt) {
    const WinTile& w = p.tile;
    const int t[3] = {w.tx, w.ty, w.tz}, nb[3] = {w.ntx, w.nty, w.ntz};
    const int g[3] = {p.gx, p.gy, p.gz};
    for (int a = 0; a < 3; ++a)
        if (t[a] < 1 || t[a] > g[a] || nb[a] < 1 || t[a] * nb[a] < g[a]
            || (nb[a] - 1) * t[a] >= g[a])
            return false;
    if (p.cap < 1 || w.tx > WIN_MAX_TXY || w.ty > WIN_MAX_TXY
        || w.tz > WIN_MAX_TZ || w.threads % 32 != 0
        || w.threads < w.tx * w.ty * w.tz * p.cap
        || w.threads > WIN_MAX_THREADS || w.list_len < p.cap)
        return false;
    const long tz2 = w.tz + 2, rows = (w.tx + 2L) * (w.ty + 2);
    const long nslots = rows * p.cap * tz2;
    if (nslots > 65536 || w.pos_off < 16 * rows * tz2 || w.pos_off % 16 != 0)
        return false;
    long end = w.pos_off + 16 * nslots;
    if (mt) {
        if (w.tab_off < end || w.tab_off % 4 != 0
            || w.typ_off < w.tab_off + 2L * nt * nt * PROW * 4)
            return false;
        end = w.typ_off + nslots;
    }
    return w.list_off >= end && w.list_off % 4 == 0
        && w.smem >= w.list_off + 2L * w.threads * w.list_len
        && w.smem <= WIN_MAX_SMEM;
}

// Check the tile, allow its shared memory, launch; cudaGetLastError().
template <typename K, typename... A>
static int launch(K kernel, const EamParams* p, int nt, bool mt,
                  void* stream, A... args) {
    if (mt && (nt < 2 || nt > MAX_NT)) return (int)cudaErrorInvalidValue;
    if (!tile_ok(*p, nt, mt)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->tile.smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks =
        (unsigned)(p->tile.ntx * p->tile.nty * p->tile.ntz);
    kernel<<<blocks, p->tile.threads, p->tile.smem, STREAM(stream)>>>(
        args..., *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_eam_rho(const void* xi, const void* alive, void* rho,
                           void* nn, const EamParams* p, int nc,
                           void* stream) {
    return launch(eam_rho_kernel<false, false>, p, 1, false, stream,
                  (const float*)xi, (const uint8_t*)alive,
                  (const int32_t*)nullptr, (const float*)nullptr, 1,
                  (float*)rho, (float*)nn, (float*)nullptr, nc);
}

extern "C" int imd_eam_rho_e(const void* xi, const void* alive, void* rho,
                             void* nn, void* e, const EamParams* p, int nc,
                             void* stream) {
    return launch(eam_rho_kernel<true, false>, p, 1, false, stream,
                  (const float*)xi, (const uint8_t*)alive,
                  (const int32_t*)nullptr, (const float*)nullptr, 1,
                  (float*)rho, (float*)nn, (float*)e, nc);
}

extern "C" int imd_eam_force(const void* xi, const void* alive,
                             const void* dF, void* F, const EamParams* p,
                             int nc, void* stream) {
    return launch(eam_force_kernel<false, false>, p, 1, false, stream,
                  (const float*)xi, (const uint8_t*)alive,
                  (const int32_t*)nullptr, (const float*)nullptr, 1,
                  (const float*)dF, (float*)F, (float*)nullptr, nc);
}

extern "C" int imd_eam_force_s(const void* xi, const void* alive,
                               const void* dF, void* F, void* S,
                               const EamParams* p, int nc, void* stream) {
    return launch(eam_force_kernel<true, false>, p, 1, false, stream,
                  (const float*)xi, (const uint8_t*)alive,
                  (const int32_t*)nullptr, (const float*)nullptr, 1,
                  (const float*)dF, (float*)F, (float*)S, nc);
}

// The multi-type entries: ``typ`` [cap, NC] int32 (-1 = dead) in place of
// the alive bytes, ``tab`` the [4][nt*nt][NPOLY + 2] coefficient buffer;
// the polynomials of ``p`` are not read.
extern "C" int imd_eam_rho_mt(const void* xi, const void* typ,
                              const void* tab, int nt, void* rho, void* nn,
                              const EamParams* p, int nc, void* stream) {
    return launch(eam_rho_kernel<false, true>, p, nt, true, stream,
                  (const float*)xi, (const uint8_t*)nullptr,
                  (const int32_t*)typ, (const float*)tab, nt, (float*)rho,
                  (float*)nn, (float*)nullptr, nc);
}

extern "C" int imd_eam_rho_e_mt(const void* xi, const void* typ,
                                const void* tab, int nt, void* rho, void* nn,
                                void* e, const EamParams* p, int nc,
                                void* stream) {
    return launch(eam_rho_kernel<true, true>, p, nt, true, stream,
                  (const float*)xi, (const uint8_t*)nullptr,
                  (const int32_t*)typ, (const float*)tab, nt, (float*)rho,
                  (float*)nn, (float*)e, nc);
}

extern "C" int imd_eam_force_mt(const void* xi, const void* typ,
                                const void* tab, int nt, const void* dF,
                                void* F, const EamParams* p, int nc,
                                void* stream) {
    return launch(eam_force_kernel<false, true>, p, nt, true, stream,
                  (const float*)xi, (const uint8_t*)nullptr,
                  (const int32_t*)typ, (const float*)tab, nt,
                  (const float*)dF, (float*)F, (float*)nullptr, nc);
}

extern "C" int imd_eam_force_s_mt(const void* xi, const void* typ,
                                  const void* tab, int nt, const void* dF,
                                  void* F, void* S, const EamParams* p,
                                  int nc, void* stream) {
    return launch(eam_force_kernel<true, true>, p, nt, true, stream,
                  (const float*)xi, (const uint8_t*)nullptr,
                  (const int32_t*)typ, (const float*)tab, nt,
                  (const float*)dF, (float*)F, (float*)S, nc);
}

