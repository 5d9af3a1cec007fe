// The half-stencil kernels over pre-rolled views, for Hopper (sm_90a):
//   eam_rho_half_kernel    K10 eam_rho_half:   host density rho, neighbour
//                                              count nn
//   eam_force_half_kernel  K11 eam_force_half: F from the combined gradient
//                                              phi' + (dF_i + dF_j) rho'
//   pair_half_kernel       K12 pair_half:      the pair force, energy
//                                              (phi/2 to each side), count
//                                              and the six stress sums
//   pair_half_mt_kernel    K12-mt pair_half_mt: K12 for 2-4 species, each
//                                              pair on its type pair's
//                                              table column
// Replaces the Pallas kernels
//   kern_r (eam_r_pass, imd_tpu/ops/forces_pallas.py:641, call :670) -> K10
//   kern_f (eam_f_pass, imd_tpu/ops/forces_pallas.py:747, call :772) -> K11
//   kern (compute_pair_forces_pallas, imd_tpu/ops/forces_pallas.py:487,
//         call :522)                                                 -> K12
// and K12-mt is that kernel's typed counterpart: imd_tpu's B6 bakes table
// column 0 into every pair whatever the types (ROADMAP C3); K12-mt reads
// column t_i * nt + t_j, as imd_tpu's XLA engines do
// (imd_tpu/ops/forces.py:116-127, forces_fast.py:136).
// with the same contract: the kernels read the views they are given and
// know nothing of the periodicity, and write i-sums and per-offset j-side
// partials that torch rolls back and adds (_assemble, forces_pallas.py).
// The three are one templated body, half_body<KIND>.
//
// Inputs (f32, cells last, NC = gx*gy*gz, NOF = 13 half-stencil offsets):
//   xi  [cap, 3, NC]       the cells' own slots (dead slots at 1e6)
//   nbr [NOF, cap, 3, NC]  view m: the slots of the neighbour cell at
//                          HALF_OFFSETS[m], box shift added, cells across an
//                          open face at 3e6 (prep_neighbors)
//   dF  [cap, NC], dFn [NOF, cap, NC]   K11: the half embedding derivative
//                          and its 13 views
//   typ [cap, NC] int32    K12-mt: the types (-1 in dead slots); tab
//                          [2][nt * nt][PROW] the fits' rows (phi, then
//                          2 dphi/dr^2; kernels.MT_TABLES' row layout)
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
// masked: the contract is unmasked, as on the TPU.  The kernels skip dead
// slots (x at or above EamParams.half.dead, half of the 1e6 sentinel) and
// write zeros for them: a dead slot's outputs are unspecified (the plain
// versions pair two dead slots of one cell), and the callers mask them.
// Live slots are ~1e6 away from any dead slot and ~3e6 from an invalid
// cell, so the outputs of live slots are exact either way.
//
// The design: in-cutoff pair lists, dead slots skipped.  The launch shape
// (EamParams.half: cells per block, threads, shared memory) comes from the
// host (forces_win.half_tile: the most cells, a power of two, whose cap *
// cells threads fit 256, halved until the shared memory fits), and half_ok
// checks it.  threadIdx.x = s * cpb + cell (cpb >= 8 up to capacity 32, so
// a warp reads whole 32-byte sectors of the cells-last arrays), rounded up
// to whole warps: a padding lane (s >= cap) stages, scans and writes
// nothing, and takes part in the barriers and warp votes only.  The block
// loads its cells' own slots into registers and stages them as float4 (x,
// y, z, and dF in K11; .w unused in K10 and K12), with each staged cell's
// limit, 1 + its last live slot (a shared atomicMax).  A block whose cells
// hold no live slot writes zeros and returns.  Then 14 sweeps: the own
// cell, and the 13 views one at a time.  A view is copied global -> shared
// with cp.async while the sweep before is scanned, into the other of two
// staged arrays, and lands (with its limits) before the barrier that opens
// its sweep.  Per sweep:
//   1. The scan.  A live slot i runs over the staged candidates below its
//      cell's limit (in the own cell j > i), computes r^2 with fused
//      multiply-adds and appends each candidate inside the cutoff widened by
//      2^-20 as j to its uint16 list in shared memory ([cap][threads]: lanes
//      of one entry are consecutive; a sweep has at most cap candidates).
//      A dead slot scans nothing; a warp without a live lane skips the scan
//      and the flush.
//   2. The flush.  The Horners (degree 12, 11 for a derivative: the port's
//      fits; the wrappers refuse higher) run over the list only, two
//      entries a step, so a warp evaluates them as often as its longest
//      list, not at every candidate that one of its lanes finds inside.  An
//      entry recomputes the rounded r^2 with the operands of the plain
//      one-candidate-at-a-time sweep (dx = x_i - x_j, unfused), so with its
//      bits, and decides the cutoff on it; its value (rho in K10, the
//      gradient g in K11, g and, with the energy, phi in K12) goes to a
//      per-cell [cap i][cap j] scratch (rows padded by one word against
//      bank conflicts) and bit i of the column mask for j is set (shared
//      atomicOr).  The i-side sums keep their per-view partials and are
//      added to the running total at each view's end (rho += ri, fx +=
//      -gx), the own cell's after its j side (rho = ri + rj, fx = -gx +
//      hx): the order of the one-sweep design, whose unlisted pairs added
//      exact zeros.
//   3. The j side.  After a barrier, slot j of the staged array walks the
//      set bits of its column mask in ascending i, sums the scratch (K11
//      and K12: g (x_i - x_j), and phi) and the count, and writes its
//      j-partial; it clears the mask for the next sweep.  The count
//      recomputes r^2 from the staged x_i - x_j, the flush's operands, so
//      with its bits; K10 recomputes nothing when nn's radius is the
//      cutoff's (a listed pair is inside it).  An unlisted pair adds
//      nothing, where it added an exact 0 before: the same sums.  The next
//      view's copies land, and a barrier opens its sweep.
// Every live output is formed over the same pairs in the same order with
// the same bits as in the one-sweep design (one thread per slot over all
// cap candidates of a view, a [cap][cap] scratch per view) at -fmad=false.
// No atomics touch a sum, so every run gives the same bits.
//
// What bounds it on the H100.  Instruction issue and latency: registers
// (K11 47, K12 73) hold an SM to 5 and 3 blocks of 256 threads, and shared
// memory holds K10 (39 registers) to 5.  At the flagship's shapes (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md section 6, variant builds) K11 spent
// ~0.22 ms in staging, barriers and stores, ~0.09 in the scan, ~0.17 in
// the flush and j side and ~0.10 in the Horners.  Per view a slot lists
// ~1.3 pairs, and the warp runs as long as its longest list: the flush's
// lanes are busy ~30% of the time.  At capacity 32 half the threads hold
// dead slots and the [32][32] scratch halves the blocks an SM holds.  Two
// views a sweep, a warp-shared queue of the lists (all lanes running the
// Horners) and scratch rows for fewer slots than cap were tried and lost;
// see PERF.md.
//
// K10 keeps rho and the count: one value Horner, the scratch holds rho.
// K11 keeps the gradient, from dF staged in .w.  K12 is K11's design for
// one pair table: the scratch holds g = 2 dphi/dr^2 and, when the energy is
// asked, phi; the j side recomputes x_i - x_j (and r^2 for the count).
// Per view it adds -sum_j g d_a d_b to six stress sums of slot i.  Its
// bytes are K11's less dF: the views in, five outputs and their 13
// j-partials out.
//
// K12-mt is K12 with a type per slot: the block copies the [2][nt * nt]
// coefficient rows into shared memory behind the lists (HALF_MT_TAB bytes,
// room for MAX_NT species), stages each slot's type in .w of its float4
// (the own cell's from typ at its cell, a view's from typ at the cell whose
// slots the view holds, the neighbour cell at the view's offset on the
// periodic lattice, half_neighbor; a cell across an open face sits at 3e6
// in the view and is never listed, so the type read there is unused), and
// the flush evaluates the row t_i * nt + t_j of each listed pair (types
// clamped to 0..nt-1, as the plain version clamps them).  Everything else
// is K12's: the scratch holds the typed g and phi, so the j side is
// unchanged.  Its bytes add the types: one int32 for each live slot and
// view entry.
//
// Rounding: compiled with -fmad=false (kernels.py), like eam_win.cu.  The
// scan's fused r^2 is a filter only: every value is computed from the
// rounded r^2.

#include "eam_common.cuh"

#define NOF 13
#define HALF_MAX_THREADS 256
#define HALF_MAX_SMEM 232448   // kernels.HALF_MAX_SMEM: the H100's 227 KB
#define HALF_MAX_CAP 128     // kernels.HALF_MAX_CAP: j fits the list's 8 bits
#define HALF_DEG 12          // kernels.WIN_DEG: the fits' value degree
// K12-mt's coefficient rows in shared memory: two tables of MAX_NT^2 rows
// (forces_win.HALF_MT_TAB)
#define HALF_MT_TAB (2 * MAX_NT * MAX_NT * PROW * 4)
#define FULL 0xffffffffu

// The block's view of its dynamic shared memory (layout: half_smem) and this
// thread's place.  Staged array 0 holds the own cell; view m goes to array
// 1 + m % 2, so that the next view's copies fly while this one is scanned.
// A scratch row (slot i) is cap * cpb + 1 floats, so that the rows of one
// column fall in different banks.
struct Half {
    float4* v;        // [3][cap][cpb]: x, y, z, dF (K11)
    float* sc;        // [nf][cap i][cap j * cpb + 1] pair values
    unsigned* mask;   // [words][cap j][cpb]: bit i, (i, j) listed
    int* lim;         // [3][cpb]: 1 + the last live slot
    uint16_t* list;   // [cap][threads]: the listed slots j
    int cap, cpb, words, row;
    int s, cl, c;     // slot, cell of the block, cell of the grid
    bool slot;        // s < cap: not a padding lane
    bool mine;        // a slot of a cell of the grid
};

// Bytes of dynamic shared memory for the launch shape (with K12-mt's
// coefficient rows behind the lists when ``mt``); host and device.
__host__ __device__ inline size_t half_smem(int cap, int cpb, int threads,
                                            int nf, bool mt = false) {
    const size_t words = (size_t)(cap + 31) / 32, cells = cpb;
    return 16 * 3 * (size_t)cap * cells
        + 4 * (size_t)nf * cap * (cap * cells + 1)
        + 4 * words * cap * cells
        + 4 * 3 * cells
        + 2 * (size_t)cap * threads
        + (mt ? HALF_MT_TAB : 0);
}

__device__ __forceinline__ Half carve_half(const EamParams& P, int nf,
                                           int nc) {
    extern __shared__ __align__(16) unsigned char smem[];
    Half h;
    h.cap = P.cap;
    h.cpb = P.half.cpb;
    h.words = (P.cap + 31) >> 5;
    h.row = h.cap * h.cpb + 1;
    const size_t per = (size_t)h.cap * h.cpb;
    unsigned char* p = smem;
    h.v = reinterpret_cast<float4*>(p);
    p += 16 * 3 * per;
    h.sc = reinterpret_cast<float*>(p);
    p += 4 * (size_t)nf * h.cap * h.row;
    h.mask = reinterpret_cast<unsigned*>(p);
    p += 4 * (size_t)h.words * per;
    h.lim = reinterpret_cast<int*>(p);
    p += 4 * 3 * (size_t)h.cpb;
    h.list = reinterpret_cast<uint16_t*>(p);
    h.cl = threadIdx.x % h.cpb;
    h.s = threadIdx.x / h.cpb;
    h.c = blockIdx.x * h.cpb + h.cl;
    h.slot = h.s < h.cap;
    h.mine = h.slot && h.c < nc;
    return h;
}

__device__ __forceinline__ float4& staged(const Half& h, int a, int j) {
    return h.v[(a * h.cap + j) * h.cpb + h.cl];
}

__device__ __forceinline__ float& scratch(const Half& h, int f, int i,
                                          int j) {
    return h.sc[(f * h.cap + i) * h.row + j * h.cpb + h.cl];
}

__device__ __forceinline__ unsigned& column(const Half& h, int w, int j) {
    return h.mask[(w * h.cap + j) * h.cpb + h.cl];
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(d), "l"(src) : "memory");
}

// The flat index of the cell whose slots view m holds at the index of
// cell (cx, cy, cz): the neighbour at HALF_OFFSETS[m] = ALL_OFFSETS[14 + m]
// on the periodic lattice (forces_fast._roll_cells).
__device__ __forceinline__ int half_neighbor(const EamParams& P, int cx,
                                             int cy, int cz, int m) {
    const int k = 14 + m;
    const int x = (cx + k / 9 - 1 + P.gx) % P.gx;
    const int y = (cy + (k / 3) % 3 - 1 + P.gy) % P.gy;
    const int z = (cz + k % 3 - 1 + P.gz) % P.gz;
    return (x * P.gy + y) * P.gz + z;
}

// Issue the asynchronous copies of slot s of view m of nbr (x, y, z, and dF
// from dFn when given; with MT the slot's type from typ at cell ``cn``, the
// view's neighbour cell) into staged array a; land_view waits for them and
// raises the cell's limit of that array.
template <bool MT>
__device__ __forceinline__ void copy_view(const Half& h,
                                          const float* __restrict__ nbr,
                                          const float* __restrict__ dFn,
                                          const int32_t* __restrict__ typ,
                                          int cn, int m, int a, size_t n) {
    if (!h.mine) return;
    const size_t row = (size_t)m * h.cap + h.s;
    const float* src = nbr + row * 3 * n + h.c;
    float* dst = reinterpret_cast<float*>(&staged(h, a, h.s));
    copy4(dst, src);
    copy4(dst + 1, src + n);
    copy4(dst + 2, src + 2 * n);
    if (MT)
        copy4(dst + 3, reinterpret_cast<const float*>(
                           typ + (size_t)h.s * n + cn));
    else if (dFn)
        copy4(dst + 3, dFn + row * n + h.c);
    asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void land_view(const Half& h, int a, float dead) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    if (h.mine && staged(h, a, h.s).x < dead)
        atomicMax(&h.lim[a * h.cpb + h.cl], h.s + 1);
}

// Scan staged array a from this thread's position, appending every
// candidate inside the widened cutoff (the own cell, a = 0, from j = s + 1
// on) to its list, which holds the cap candidates of one view; returns the
// list's length.  An append is one st.shared through a 32-bit address kept
// in a register (eam_win.cu's scan); the empty asm with a memory clobber
// keeps the flush's reads of the list after the stores.
__device__ __forceinline__ int scan_half(const Half& h, bool live, float x,
                                         float y, float z, float lim2,
                                         int a) {
    const unsigned step = 2u * blockDim.x;
    const unsigned first =
        (unsigned)__cvta_generic_to_shared(h.list + threadIdx.x);
    unsigned w = first;
    const int lm = live ? h.lim[a * h.cpb + h.cl] : 0;
    const float4* __restrict__ v = &staged(h, a, 0);
#pragma unroll 4
    for (int j = a ? 0 : h.s + 1; j < lm; ++j) {
        const float4 p = v[j * h.cpb];
        const float dx = x - p.x, dy = y - p.y, dz = z - p.z;
        const float r2 = __fmaf_rn(dx, dx, __fmaf_rn(dy, dy, dz * dz));
        if (r2 < lim2) {
            asm volatile("st.shared.u16 [%0], %1;"
                         :: "r"(w), "h"((unsigned short)j));
            w += step;
        }
    }
    asm volatile("" ::: "memory");
    return (int)((w - first) / step);
}

// Write zeros for this thread's slot (a block without a live slot).
__device__ __forceinline__ void zero_half(const Half& h, float* out_i,
                                          float* out_j, float* out_s, int nk,
                                          size_t n) {
    if (!h.mine) return;
    const size_t io = (size_t)h.s * n + h.c, cs = (size_t)h.cap * n;
    for (int k = 0; k < nk; ++k) {
        out_i[k * cs + io] = 0.0f;
        for (int m = 0; m < NOF; ++m)
            out_j[((size_t)k * NOF + m) * cs + io] = 0.0f;
    }
    if (out_s != nullptr)
        for (int k = 0; k < 6; ++k) out_s[k * cs + io] = 0.0f;
}

// A listed pair as the flush sees it: the slot j of staged array a, the
// rounded differences and r^2, dF_j (K11; K12-mt: the bits of t_j).
struct Entry {
    int j;
    float dx, dy, dz, r2, dfj;
};

__device__ __forceinline__ Entry entry(const Half& h, int a, unsigned j,
                                       float x, float y, float z) {
    Entry q;
    q.j = (int)j;
    const float4 p = staged(h, a, q.j);
    q.dx = x - p.x;
    q.dy = y - p.y;
    q.dz = z - p.z;
    q.r2 = q.dx * q.dx + q.dy * q.dy + q.dz * q.dz;
    q.dfj = p.w;
    return q;
}

// r^2 of the staged x_i - x_j, unfused: the flush's operands and bits.
__device__ __forceinline__ float r2_from(const float4& pi, const float4& pj) {
    const float dx = pi.x - pj.x, dy = pi.y - pj.y, dz = pi.z - pj.z;
    return dx * dx + dy * dy + dz * dz;
}

// Horner of D steps: the fits' own degree (HALF_DEG, 11 for a derivative).
// poly_eval's NPOLY - 1 = 15 steps add 0 * t + 0 above it: the same bits.
template <int D>
__device__ __forceinline__ float horner_d(const Poly& p, float x) {
    const float t = fminf(fmaxf(x * p.a - p.b0, -1.0f), 1.0f);
    float v = p.c[D];
#pragma unroll
    for (int k = D - 1; k >= 0; --k) v = v * t + p.c[k];
    return v;
}

// What a kernel of the one body computes.
enum HalfKind { HALF_RHO, HALF_FORCE, HALF_PAIR };   // K10, K11, K12

// The sums of one slot: the running totals, and the i-side partials of
// the sweep being flushed: the force (K11, K12), the value sum e (K10's
// rho, K12's energy), the count (K10, K12) and K12's stress.
struct Sums {
    float fx, fy, fz, e, cnt;
    float st[6];
    float gx, gy, gz, ei, ni;
    float sp[6];
};

// A view's partials into the totals, in the order of the one-sweep design.
template <int KIND>
__device__ __forceinline__ void fold_view(Sums& u) {
    if (KIND == HALF_RHO) {
        u.e += u.ei;
        u.cnt += u.ni;
        u.ei = u.ni = 0.0f;
        return;
    }
    u.fx += -u.gx;
    u.fy += -u.gy;
    u.fz += -u.gz;
    u.gx = u.gy = u.gz = 0.0f;
    if (KIND == HALF_PAIR) {
        u.e += 0.5f * u.ei;
        u.cnt += u.ni;
        u.ei = u.ni = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
            u.st[k] += -u.sp[k];
            u.sp[k] = 0.0f;
        }
    }
}

// K10 (HALF_RHO: rho, and the count within nr2 when ``count``), K11
// (HALF_FORCE: F from phi' + (dF_i + dF_j) rho') and K12 (HALF_PAIR: the
// pair force, phi/2 to each side when ``energy``, the count within nr2
// when ``count``, the stress sums when out_s is given), for fits of value
// degree at most DV (the wrappers hold them to it).  ``energy`` is 0 in
// K10 and K11, ``count`` 0 in K11.  MT (K12-mt, HALF_PAIR only): the
// pair's fit is row t_i * nt + t_j of ``tab`` for ``nt`` species, with the
// types from ``typ``.
template <int KIND, int DV, bool MT = false>
__device__ __forceinline__ void half_body(
    const float* __restrict__ xi, const float* __restrict__ nbr,
    const float* __restrict__ dF, const float* __restrict__ dFn,
    float* __restrict__ out_i, float* __restrict__ out_s,
    float* __restrict__ out_j, int energy, int count, float nr2, int nc,
    const EamParams& P, const int32_t* __restrict__ typ = nullptr,
    const float* __restrict__ tab = nullptr, int nt = 1) {
    static_assert(!MT || KIND == HALF_PAIR, "MT is K12's");
    constexpr bool RHO = KIND == HALF_RHO, PAIR = KIND == HALF_PAIR;
    constexpr bool GRAD = !RHO;   // a gradient per pair, forces out
    const Half h = carve_half(P, 1 + energy, nc);
    const int cap = h.cap, s = h.s;
    const size_t n = (size_t)nc;
    // output rows of e (K10's rho, K12's energy) and nn; e is field 0 of
    // K10's scratch, field 1 of K12's.  K10 always keeps e, K12 when
    // ``energy`` (tested where it is used: a flag held in a register cost
    // K12 two)
    const int ke = RHO ? 0 : 3, kn = RHO ? 1 : 3 + energy;
    const int fe = RHO ? 0 : 1;
    const bool stress = PAIR && out_s != nullptr;
    const float dead = P.half.dead;
    const float lim2 = P.rcut2 * (1.0f + 0x1p-20f);
    // zero the column masks and the limits
    const int nm = h.words * h.cap * h.cpb;
    for (int k = threadIdx.x; k < nm; k += blockDim.x) h.mask[k] = 0u;
    for (int k = threadIdx.x; k < 3 * h.cpb; k += blockDim.x) h.lim[k] = 0;
    // K12-mt: the coefficient rows behind the lists, this cell's place on
    // the lattice (for the views' neighbour cells) and the slot's type
    const Poly* rows = nullptr;
    int cx = 0, cy = 0, cz = 0, ti = 0;
    if constexpr (MT) {
        float* st = reinterpret_cast<float*>(h.list + (size_t)cap
                                             * blockDim.x);
        for (int k = threadIdx.x; k < 2 * nt * nt * PROW; k += blockDim.x)
            st[k] = tab[k];
        rows = reinterpret_cast<const Poly*>(st);
        cz = h.c % P.gz;
        cy = (h.c / P.gz) % P.gy;
        cx = h.c / (P.gz * P.gy);
    }
    float x = 0.0f, y = 0.0f, z = 0.0f, dfi = 0.0f;
    if (h.mine) {
        x = xi[(3 * (size_t)s) * n + h.c];
        y = xi[(3 * (size_t)s + 1) * n + h.c];
        z = xi[(3 * (size_t)s + 2) * n + h.c];
        if (KIND == HALF_FORCE) dfi = dF[(size_t)s * n + h.c];
        if (MT) ti = min(max(typ[(size_t)s * n + h.c], 0), nt - 1);
    }
    copy_view<MT>(h, nbr, dFn, typ,
                  MT ? half_neighbor(P, cx, cy, cz, 0) : 0, 0, 1, n);
    __syncthreads();
    const bool live = h.mine && x < dead;
    if (h.slot)
        staged(h, 0, s) = make_float4(x, y, z,
                                      MT ? __int_as_float(ti) : dfi);
    if (live) atomicMax(&h.lim[h.cl], s + 1);
    if (!__syncthreads_or(live)) {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        zero_half(h, out_i, out_j, out_s, kn + count, n);
        return;
    }
    const bool scans = __any_sync(FULL, live);
    Sums u = {};
    const size_t plane = (size_t)NOF * cap * n;   // one row of out_j
    // sweep 0 is the own cell (staged array 0); sweep m >= 1 is view m - 1
    // in array 1 + (m - 1) % 2
    for (int m = 0;; ++m) {
        const int a = m ? 1 + ((m - 1) & 1) : 0;
        const int a_next = 1 + (m & 1);
        // the next view flies into the array of the one before (the
        // prologue copied the first)
        if (m && m < NOF)
            copy_view<MT>(h, nbr, dFn, typ,
                          MT ? half_neighbor(P, cx, cy, cz, m) : 0, m,
                          a_next, n);
        if (scans) {
            const int n_list = scan_half(h, live, x, y, z, lim2, a);
            // the flush: the Horners over the list, two entries a step
            const uint16_t* lst = h.list + threadIdx.x;
            for (int k = 0; k < n_list; k += 2) {
                const bool two = k + 1 < n_list;
                const unsigned e0 = lst[k * blockDim.x];
                const unsigned e1 = two ? lst[(k + 1) * blockDim.x] : e0;
                const Entry q[2] = {entry(h, a, e0, x, y, z),
                                    entry(h, a, e1, x, y, z)};
                // g: the gradient; v: the value (rho, or phi)
                float g[2], v[2] = {0.0f, 0.0f};
#pragma unroll
                for (int t = 0; t < 2; ++t) {
                    if (RHO) {
                        v[t] = horner_d<DV>(P.rho_v, q[t].r2);
                    } else if (PAIR && MT) {
                        // row t_i * nt + t_j: phi in table 0, 2 dphi/dr^2
                        // in table 1
                        const int tj = min(
                            max(__float_as_int(q[t].dfj), 0), nt - 1);
                        const Poly& pv = rows[ti * nt + tj];
                        g[t] = horner_d<DV - 1>((&pv)[nt * nt], q[t].r2);
                        if (energy) v[t] = horner_d<DV>(pv, q[t].r2);
                    } else if (PAIR) {
                        g[t] = horner_d<DV - 1>(P.pair_g, q[t].r2);
                        if (energy) v[t] = horner_d<DV>(P.pair_v, q[t].r2);
                    } else {
                        g[t] = horner_d<DV - 1>(P.pair_g, q[t].r2)
                            + (dfi + q[t].dfj)
                            * horner_d<DV - 1>(P.rho_g, q[t].r2);
                    }
                }
#pragma unroll
                for (int t = 0; t < 2; ++t) {
                    if (t == 1 && !two) break;
                    if (q[t].r2 < P.rcut2) {
                        if (GRAD) {
                            const float dx = q[t].dx, dy = q[t].dy,
                                        dz = q[t].dz;
                            const float gdx = g[t] * dx, gdy = g[t] * dy,
                                        gdz = g[t] * dz;
                            u.gx += gdx;
                            u.gy += gdy;
                            u.gz += gdz;
                            if (stress) {
                                u.sp[0] += gdx * dx;
                                u.sp[1] += gdy * dy;
                                u.sp[2] += gdz * dz;
                                u.sp[3] += gdy * dz;
                                u.sp[4] += gdz * dx;
                                u.sp[5] += gdx * dy;
                            }
                        }
                        if (KIND != HALF_FORCE) {
                            u.ei += v[t];
                            if (q[t].r2 < nr2) u.ni += 1.0f;
                        }
                        if (GRAD) scratch(h, 0, s, q[t].j) = g[t];
                        if (RHO || energy)
                            scratch(h, fe, s, q[t].j) = v[t];
                        atomicOr(&column(h, s >> 5, q[t].j), 1u << (s & 31));
                    }
                }
            }
        }
        __syncthreads();
        // the j side: slot s of the staged array; a view's limit is cleared
        // for the sweep after next, and the next view's copies land
        if (h.slot) {
            const float4 pj = staged(h, a, s);
            // K10: a listed pair is inside nn's radius when it is the
            // cutoff's, as on the main path
            const bool all_in = RHO && nr2 >= P.rcut2;
            float hx = 0.0f, hy = 0.0f, hz = 0.0f, ej = 0.0f, nj = 0.0f;
            for (int w = 0; w < h.words; ++w) {
                unsigned bits = column(h, w, s);
                if (bits) column(h, w, s) = 0u;
                while (bits) {
                    const int i = (w << 5) + __ffs(bits) - 1;
                    bits &= bits - 1;
                    if (RHO) {
                        ej += scratch(h, 0, i, s);
                        if (count && (all_in || r2_from(staged(h, 0, i), pj)
                                                    < nr2))
                            nj += 1.0f;
                        continue;
                    }
                    const float gij = scratch(h, 0, i, s);
                    const float4 pi = staged(h, 0, i);
                    const float dx = pi.x - pj.x;
                    const float dy = pi.y - pj.y;
                    const float dz = pi.z - pj.z;
                    hx += gij * dx;
                    hy += gij * dy;
                    hz += gij * dz;
                    if (PAIR) {
                        if (energy) ej += scratch(h, 1, i, s);
                        if (count && dx * dx + dy * dy + dz * dz < nr2)
                            nj += 1.0f;
                    }
                }
            }
            if (m == 0) {   // the own cell's partials, with its j side
                if (RHO) {
                    u.e = u.ei + ej;
                    u.cnt = u.ni + nj;
                    u.ei = u.ni = 0.0f;
                }
                if (PAIR) {
#pragma unroll
                    for (int k = 0; k < 6; ++k) {
                        u.st[k] += -u.sp[k];
                        u.sp[k] = 0.0f;
                    }
                    u.e = 0.5f * u.ei + 0.5f * ej;
                    u.cnt = u.ni + nj;
                    u.ei = u.ni = 0.0f;
                }
                if (GRAD) {
                    u.fx = -u.gx + hx;
                    u.fy = -u.gy + hy;
                    u.fz = -u.gz + hz;
                    u.gx = u.gy = u.gz = 0.0f;
                }
            } else {
                if (h.mine) {
                    const size_t jo = ((size_t)(m - 1) * cap + s) * n + h.c;
                    if (GRAD) {
                        out_j[jo] = hx;
                        out_j[plane + jo] = hy;
                        out_j[2 * plane + jo] = hz;
                    }
                    if (RHO) out_j[ke * plane + jo] = ej;
                    if (PAIR && energy) out_j[ke * plane + jo] = 0.5f * ej;
                    if (KIND != HALF_FORCE && count)
                        out_j[kn * plane + jo] = nj;
                }
                if (s == 0) h.lim[a * h.cpb + h.cl] = 0;
            }
        }
        if (m) fold_view<KIND>(u);   // the view's partials
        if (m == NOF) break;
        land_view(h, a_next, dead);
        __syncthreads();
    }
    if (h.mine) {
        const size_t io = (size_t)s * n + h.c;
        const size_t cs = (size_t)cap * n;
        if (GRAD) {
            out_i[io] = u.fx;
            out_i[cs + io] = u.fy;
            out_i[2 * cs + io] = u.fz;
        }
        if (RHO || energy) out_i[ke * cs + io] = u.e;
        if (KIND != HALF_FORCE && count) out_i[kn * cs + io] = u.cnt;
        if (stress)
#pragma unroll
            for (int k = 0; k < 6; ++k) out_s[k * cs + io] = u.st[k];
    }
}

__global__ void __launch_bounds__(HALF_MAX_THREADS)
eam_rho_half_kernel(const float* __restrict__ xi,
                    const float* __restrict__ nbr,
                    float* __restrict__ out_i, float* __restrict__ out_j,
                    int count, float nr2, int nc,
                    const __grid_constant__ EamParams P) {
    half_body<HALF_RHO, HALF_DEG>(xi, nbr, nullptr, nullptr, out_i, nullptr,
                                  out_j, 0, count, nr2, nc, P);
}

__global__ void __launch_bounds__(HALF_MAX_THREADS)
eam_force_half_kernel(const float* __restrict__ xi,
                      const float* __restrict__ nbr,
                      const float* __restrict__ dF,
                      const float* __restrict__ dFn,
                      float* __restrict__ out_i, float* __restrict__ out_j,
                      int nc, const __grid_constant__ EamParams P) {
    half_body<HALF_FORCE, HALF_DEG>(xi, nbr, dF, dFn, out_i, nullptr, out_j,
                                    0, 0, 0.0f, nc, P);
}

__global__ void __launch_bounds__(HALF_MAX_THREADS)
pair_half_kernel(const float* __restrict__ xi, const float* __restrict__ nbr,
                 float* __restrict__ out_i, float* __restrict__ out_s,
                 float* __restrict__ out_j, int energy, int count, float nr2,
                 int nc, const __grid_constant__ EamParams P) {
    half_body<HALF_PAIR, HALF_DEG>(xi, nbr, nullptr, nullptr, out_i, out_s,
                                   out_j, energy, count, nr2, nc, P);
}

__global__ void __launch_bounds__(HALF_MAX_THREADS)
pair_half_mt_kernel(const float* __restrict__ xi,
                    const float* __restrict__ nbr,
                    const int32_t* __restrict__ typ,
                    const float* __restrict__ tab, int nt,
                    float* __restrict__ out_i, float* __restrict__ out_s,
                    float* __restrict__ out_j, int energy, int count,
                    float nr2, int nc, const __grid_constant__ EamParams P) {
    half_body<HALF_PAIR, HALF_DEG, true>(xi, nbr, nullptr, nullptr, out_i,
                                         out_s, out_j, energy, count, nr2,
                                         nc, P, typ, tab, nt);
}

// The launch shape of K10-K12 (nf scratch fields; K12-mt's rows when
// ``mt``) as forces_win.half_tile makes it: whole warps of cap * cpb
// threads and half_smem's bytes within the H100's 227 KB.
static bool half_ok(const EamParams& P, int nf, bool mt = false) {
    const HalfTile& t = P.half;
    const int cap = P.cap;
    if (cap < 1 || cap > HALF_MAX_CAP || t.cpb < 1) return false;
    const int threads = (cap * t.cpb + 31) / 32 * 32;
    return t.threads == threads && threads <= HALF_MAX_THREADS
        && t.smem <= HALF_MAX_SMEM
        && (size_t)t.smem == half_smem(cap, t.cpb, threads, nf, mt);
}

template <typename K>
static cudaError_t prepare_half(K kernel, const EamParams& P, int nf,
                                bool mt = false) {
    if (!half_ok(P, nf, mt)) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                P.half.smem);
}

extern "C" int imd_eam_rho_half(const void* xi, const void* nbr, void* out_i,
                                void* out_j, int count, float nr2,
                                const EamParams* p, int nc, void* stream) {
    const HalfTile& t = p->half;
    count = count ? 1 : 0;
    cudaError_t err = prepare_half(eam_rho_half_kernel, *p, 1);
    if (err != cudaSuccess) return (int)err;
    eam_rho_half_kernel<<<(nc + t.cpb - 1) / t.cpb, t.threads, t.smem,
                          STREAM(stream)>>>(
        (const float*)xi, (const float*)nbr, (float*)out_i, (float*)out_j,
        count, nr2, nc, *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_eam_force_half(const void* xi, const void* nbr,
                                  const void* dF, const void* dFn,
                                  void* out_i, void* out_j,
                                  const EamParams* p, int nc, void* stream) {
    const HalfTile& t = p->half;
    cudaError_t err = prepare_half(eam_force_half_kernel, *p, 1);
    if (err != cudaSuccess) return (int)err;
    eam_force_half_kernel<<<(nc + t.cpb - 1) / t.cpb, t.threads, t.smem,
                            STREAM(stream)>>>(
        (const float*)xi, (const float*)nbr, (const float*)dF,
        (const float*)dFn, (float*)out_i, (float*)out_j, nc, *p);
    return (int)cudaGetLastError();
}

extern "C" int imd_pair_half(const void* xi, const void* nbr, void* out_i,
                             void* out_s, void* out_j, int energy, int count,
                             float nr2, const EamParams* p, int nc,
                             void* stream) {
    const HalfTile& t = p->half;
    energy = energy ? 1 : 0;
    count = count ? 1 : 0;
    cudaError_t err = prepare_half(pair_half_kernel, *p, 1 + energy);
    if (err != cudaSuccess) return (int)err;
    pair_half_kernel<<<(nc + t.cpb - 1) / t.cpb, t.threads, t.smem,
                       STREAM(stream)>>>(
        (const float*)xi, (const float*)nbr, (float*)out_i, (float*)out_s,
        (float*)out_j, energy, count, nr2, nc, *p);
    return (int)cudaGetLastError();
}

// ``typ`` [cap, NC] int32, ``tab`` [2][nt * nt][PROW] float32 (phi's rows,
// then 2 dphi/dr^2's), 2 <= nt <= MAX_NT.
extern "C" int imd_pair_half_mt(const void* xi, const void* nbr,
                                const void* typ, const void* tab, int nt,
                                void* out_i, void* out_s, void* out_j,
                                int energy, int count, float nr2,
                                const EamParams* p, int nc, void* stream) {
    const HalfTile& t = p->half;
    if (nt < 2 || nt > MAX_NT) return (int)cudaErrorInvalidValue;
    energy = energy ? 1 : 0;
    count = count ? 1 : 0;
    cudaError_t err = prepare_half(pair_half_mt_kernel, *p, 1 + energy,
                                   true);
    if (err != cudaSuccess) return (int)err;
    pair_half_mt_kernel<<<(nc + t.cpb - 1) / t.cpb, t.threads, t.smem,
                          STREAM(stream)>>>(
        (const float*)xi, (const float*)nbr, (const int32_t*)typ,
        (const float*)tab, nt, (float*)out_i, (float*)out_s, (float*)out_j,
        energy, count, nr2, nc, *p);
    return (int)cudaGetLastError();
}
