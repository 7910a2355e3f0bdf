// Batched ridge-Cholesky solves with the rank-1, rank-2, rank-8 panel,
// two-level Schur and dual-chain factor schedules of the reference's
// non-default TPU variants, hand-written for Hopper (sm_90a). Built by
// nvcc into a shared library with a plain C interface and called through
// ctypes (recommendation_models_tpu_torch/ops/cholesky.py).
//
// Replaces, in recommendation_models_tpu/ops/pallas/cholesky.py:
//   cholesky_solve_rank1 <FCOLS, SROWS> <- _cholesky_solve_kernel (:198,
//       pair=False: _factor_solve_body with _substitutions :812, or
//       _substitutions_pair :749 when subs2), and the pair=True, subs2=False
//       combination of _cholesky_solve_kernel_pair (:226) (FCOLS=2, SROWS=1)
//   cholesky_solve_panel               <- _cholesky_solve_kernel_panel (:107)
//   cholesky_solve_schur <SROWS>       <- _cholesky_solve_kernel_schur (:697;
//       _factor_body_schur :429), k % 16 == 0
//   cholesky_solve_dual                <- _cholesky_solve_kernel_dual (:675;
//       _factor_body_pair_multi :554, _substitutions_pair_multi :605)
//   cholesky_solve_batched_panel       <- _cholesky_solve_kernel_pair (:226)
//       past kp = 128, where its batches beyond the latency kernel take
//       this source's panel frame (csrc/cholesky_solve.cu has the rest)
//
// Contract (as csrc/cholesky_solve.cu): f32 throughout, no TF32 and no
// tensor cores; the ridge is added on load (A = G + reg_b I); pivots are
// clamped at max(d, 1e-30) (L_jj = d * rsqrt(max(d, 1e-30)), substitutions
// multiply by 1 / max(L_jj, 1e-30)), so identity-padded and all-zero systems
// with rhs 0 solve to exactly 0. G (B, k, k), rhs (B, k), reg (B,), batch
// major; 1 <= k <= 160 (Schur: k % 16 == 0), any B. Results repeat bitwise
// (no atomics, fixed orders). Past k = 160 the reference runs these kernels
// only at a one-block grid; csrc/cholesky_large_variants.cu takes that
// regime.
//
// What bounds them on an H100: at k = 64 a system must read 8.6 KB (the
// lower triangle of G, rhs, reg) and write 256 B for ~0.1 MFLOP, so the
// bound is device-memory bytes (0.173 ms for 65,536 systems at 3.35 TB/s);
// at k = 128 it is ~0.73 MFLOP for 34 KB, and f32 operations bound it
// (0.716 ms at 67 TFLOP/s; 0.856 and 1.386 ms at k = 136 and 160). All
// run far above: a factor is a chain of
// dependent column (or panel) steps separated by block barriers, and a
// substitution a chain of 2k dependent shuffle rounds.
//
// The old design (one system per block, row-ordered tiles, one warp running
// both substitutions while the block waited), read with per-phase clocks on
// an H100 at k = 64 and 65,536 systems: a rank-1 system took ~47 K cycles
// to factor and ~62 K to substitute (~450 cycles a shuffle round); the
// panel kernel's one-warp panel factor took 64 K of its 75 K factor
// cycles; at k = 128 nvcc gave the panel kernel 146 registers (one block
// per SM). This frame answers each limit:
//
// - The substitutions leave the critical path. A block is NTH factor
//   threads and one substitution warp per system. The factor threads write
//   L and the right-hand side of system n into one of two slots and signal
//   it (named barrier FULL[s], bar.arrive), then go on to system n + 1 in
//   the other slot; the substitution warp waits on FULL[s], derives
//   1 / L_jj, solves from the slot, and hands it back (EMPTY[s]). The
//   factor threads' own barriers are named barriers without the
//   substitution warp. L is stored packed (row i at i (i + 1) / 2: two
//   slots take what one square did, 66 KB at k = 128), which keeps both
//   substitutions free of bank conflicts (triangular numbers of 32
//   consecutive rows fall on 32 distinct banks). A round loads its L
//   entries and 1 / L_jj before its shuffle. Measured with the same clocks,
//   the two stages now overlap and take about the same time per system;
//   the substitution warp rarely waits for a slot, so at 65,536 systems it
//   is the (slightly) slower stage.
// - The next system's tiles arrive while this one factors: each factor
//   thread copies its own tiles of system n + 1 into a shared-memory stage
//   with cp.async (16-byte copies where k % 4 == 0) right after reading
//   system n's from it, and waits for them only at the next system. A
//   thread reads only what it copied, so the stage needs no barrier; it is
//   laid out row-major across tiles, so neighbouring threads' 16-byte
//   chunks are neighbours. rhs and reg come one system ahead in registers.
// - Tiles are numbered by column from the right (as csrc/cholesky_solve.cu),
//   so a warp's tiles finish together, and in the rank steps a warp whose
//   tiles and rows of L are done leaves the factor: each step's barrier
//   counts only the warps still in it (nbar), and a warp that has left
//   goes on to the next system, whose steps use the other of two barriers
//   and buffer sets.
// - A residency target per thread configuration (min_blocks below), read
//   back from nvcc -Xptxas -v: the targets nvcc was first given (7 and 5
//   blocks at k <= 68) spilled and ran 24-28% slower.
// - The panel (B5a): the owners publish the panel's tiles column-major into
//   one of two buffers by panel parity (column stride kp + 4, 16-byte rows:
//   neighbouring threads write and read neighbouring chunks, no bank
//   conflicts); one barrier; then every thread of a row at or below the
//   panel factors the 8 x 8 diagonal block in registers from broadcast
//   reads (each warp once; no extra barrier), and solves its own row
//   against it, column by column in the reference's order (each row
//   independent, 8 steps), writing the row's L into the packed L and back
//   over its raw values in the buffer; a second barrier; then the rank-8
//   trailing update reads the solved panel with 16-byte loads into register
//   tiles. L reaches the packed L once. Not built: a lookahead that starts
//   the next panel's diagonal block during the update (its three tiles have
//   three owners, so it needs a barrier of its own).
// - Schur (B5b) to kp = 128: the old kernel ran its three phases in turn,
//   with a block barrier between phase 1 (rank-2 steps over [0, h), h = k
//   / 2, left tiles only) and phase 2 (A22 -= L21 L21^T in groups of 8
//   columns),
//   and phase 2 ran on A22's tiles alone, a quarter of the block, while
//   the rest waited. Here phase 2 rides phase 1: after step j's barrier
//   L's columns < j are complete in the slot, so A22's owners apply group
//   j - 8 there, while the left tiles' steps go on; only the last group
//   waits for one more barrier. A22's owners cannot leave phase 1 (every
//   thread below k writes its row of L at every step up to its row), so
//   the barriers of phase 1 hand the groups over and no further barrier is
//   needed. The groups keep their order and sum their terms before
//   subtracting, so the result is the old kernel's.
// - Dual (B5c) to kp = 128: each factor thread owns the same tiles of
//   both systems, and each step publishes both systems' columns and takes
//   one barrier for the two chains (two independent FMA chains a thread,
//   half a barrier a system a step). Each system has its own substitution
//   warp and slots, so the pair's two substitutions run side by side and
//   overlap the next pair's factor, where the old kernel's two warps
//   substituted while the block waited. Both substitution warps wait on
//   one FULL and arrive on one EMPTY barrier. A pair past an odd B factors
//   an identity in its second place, and that place's warp takes the
//   hand-overs without solving.
// - Past kp = 128 (frame_config 3) B4 in its three forms and B5c run the
//   panel frame (ALONE): factor_panel as B5a runs it, with each of the
//   trailing update's eight terms subtracted alone, in p order, instead
//   of summed first. Before (PR 16's frame, an H100 at 65,536 rows, k =
//   136 / 160) they stepped a column (fcols 1) or a column pair (fcols 2,
//   dual) at a time, one barrier a step (160 or 80 a system at kp = 160)
//   around one float4 pair and 16-32 FMAs a tile, and one block an SM
//   (shared memory allows no more) had nothing to hide the barriers with:
//   B4 22.8-30.5 ms, B5c 30.7-37.8 (its pair kept one slot a system, so
//   factor and substitutions took turns), where B5a took 13.4-16.7. A
//   panel takes two barriers (40 a system at kp = 160) around 128 FMAs a
//   tile. Each schedule keeps its order of terms: every element takes
//   every term alone, in increasing p, inside the panel (left-looking,
//   factor_panel's own order) and in the update; the rank-2 form
//   L[i][j+1] = (A[i][j+1] - L[i][j] L[j+1][j]) / L[j+1][j+1] is the
//   panel's column j + 1 taking its last term. In this frame the rank-1
//   and rank-2 orders coincide (as their plain versions do, bit for bit),
//   so fcols 1 and 2 share the kernel of their srows, and the dual is the
//   srows 2 kernel: one system a block, one substitution warp and two
//   slots, so its substitution overlaps the next system's factor again
//   and an odd B needs no identity partner. Its two-row rounds take their
//   results by selects (substitute, SELECTS): with the other kernels'
//   nested form the two-row kernel ran 18.9 ms at k = 136 against the
//   one-row kernel's 13.3, and a lone system at k = 160 took 0.074 ms
//   against 0.057. The two srows give the same bits: a two-row round's
//   arithmetic is two one-row rounds'. Measured against the old frame
//   (an H100, 700 W, alternated in one call; PERF.md, PR 18): at 65,536
//   rows B4 13.3-13.6 ms at k = 136 (24.8-25.0 / 23.0 before) and
//   16.4-16.9 at 160 (30.1-30.5 / 28.4), B5c 13.5-13.6 (31.0) and 16.8-16.9
//   (37.8), B5a 13.4-13.5 and 16.6-16.7; 231 registers, no spills. B4
//   (2,1) and B5c keep their old bits (the rank-2 step took the same
//   terms, rounded the same way); B4 (1,1) and (1,2) now round each term
//   as L_ip L_lp, where the rank-1 step formed (A_ip / L_pp^2) A_lp.
// - Past kp = 128 B5b runs the panel frame too (SCHUR_PANEL), in Schur's
//   order of terms. In the rank frame it took 80 rank-2 step barriers a
//   system at kp = 160, one block an SM with nothing to hide them, and
//   kept its groups' sums: 25.2-29.4 ms at 65,536 rows and k = 144 / 160
//   on an H100, where B5a took 14.4-16.7. Here h = k / 2 is a multiple of
//   8, so each panel left of h holds exactly the columns of one of
//   Schur's groups: its trailing update takes each term alone on the
//   tiles left of h (phase 1's rank-2 steps, which skip A22) and the
//   group's sum on A22's tiles (the grouped update B5a takes everywhere,
//   as schur_group summed it), right after the panel's own barrier, where
//   the steps' frame had to wait a step for a group; the panels from h on
//   take each term alone (phase 3). Each element takes the same terms in
//   the same order, rounded alike, so the bits are the rank frame's. Every
//   factor thread takes part in every panel's barriers, so A22's owners
//   need no exit rule, and a panel's buffer is not rewritten before every
//   thread has passed the next panel's first barrier, which a thread
//   reaches only after its group. The two-row rounds take selects.
// - Past kp = 128 B1 (cholesky_solve_batched) takes this source's one-row
//   panel frame at the batches that ops/cholesky.py::solve_frame gives
//   it (cholesky_solve_batched_panel); its old throughput kernel there
//   (csrc/cholesky_solve.cu, one barrier a column, 160 a system at kp =
//   160) took 17.8 / 25.5 ms at 65,536 rows and k = 136 / 160. Its plain
//   version is B4's (1, 1), which has the same bits in this frame.
//
// The factors' arithmetic is the old kernels': the rank-1 and rank-2 steps
// of the reference's column schedules (to kp = 128); the panel's column jj
// takes the panel's earlier columns' terms in order p = 0 .. jj - 1
// (left-looking, as the reference and cholesky_solve_panel_plain), and
// B5a's trailing update sums its eight terms before subtracting them (as
// each Schur group).

#include <cuda_runtime.h>
#include <stdint.h>

#define CHOL_KMAX 160   // largest system order of these kernels
#include "cholesky_common.cuh"

namespace {

using chol::KMAX;
using chol::PIVOT_FLOOR;
using chol::pick4;

constexpr int PW = 8;                 // panel width; the Schur groups' too
// the factor schedules; RANK1 .. DUAL are also the kernels' codes in
// cholesky_rank_panel_resident. ALONE and SCHUR_PANEL are no export's:
// they are the frames that RANK1, PAIR and DUAL, and SCHUR, take past kp =
// 128 (frame_config 3), the panel factor with every term alone, and with
// Schur's grouped A22 update (see the header).
enum Sched { RANK1 = 1, PAIR = 2, PANEL = 8, SCHUR = 16, DUAL = 32,
             ALONE = 64, SCHUR_PANEL = 128 };

// the schedules that factor in panels (factor_panel)
__host__ __device__ constexpr bool panel_frame(int sched) {
    return sched == PANEL || sched == ALONE || sched == SCHUR_PANEL;
}

// systems a block carries (DUAL, to kp = 128: two, each with its own
// substitution warp; past it the dual runs as ALONE, one), and a block's
// threads
__host__ __device__ constexpr int systems(int sched) {
    return sched == DUAL ? 2 : 1;
}
__host__ __device__ constexpr int block_threads(int nth, int sched) {
    return nth + 32 * systems(sched);
}

// named barriers: 0 is __syncthreads; the factor threads' own (one per
// system parity: warps that retire early from one system's rank steps go
// on to the next system's while the others finish, and the two must not
// share a barrier), and the two slot parities' FULL and EMPTY hand-overs
// between them and the substitution warps (DUAL: both warps wait on one
// FULL and both arrive on one EMPTY, since the factor threads fill and
// reuse the two systems' slots together: seven barriers in every
// schedule)
constexpr int BAR_FACTOR = 1, BAR_FULL = 2, BAR_EMPTY = 4,
              BAR_FACTOR_ODD = 6;

__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// rsqrt of a normal positive float (every pivot is clamped at 1e-30): the
// hardware's approximation, as rsqrtf gives it for such inputs, without the
// subnormal range check on the pivots' chain (csrc/cholesky_solve.cu).
__device__ __forceinline__ float rsqrt_normal(float x) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// Shared memory of a block, in floats (every region a multiple of 4, so
// each stays 16-byte aligned), for NS systems a block (DUAL: 2, else 1):
// NS stages (the tiles of the next system, 16 floats a tile), the
// factor's buffers (rank steps: four sets a system, by system and step
// parity, of two column buffers of kp + 4, at (parity NS + system) 4
// (kp + 4); the panel: two, by panel parity, of PW columns of kp + 4),
// nslot NS slots of [packed L, rhs / y (kp), 1 / L_jj (kp)] (slot
// parity NS + system), and the rank steps' barrier counts (kp ints).
//
// Two slots a system: the factor writes L as it goes, so with one slot
// the next system's factor waits for the substitution and the two stages
// do not overlap. DUAL's block (two systems, to kp = 128) takes 213 KB at
// k = 128, one block per SM; at k = 64, 57 KB. Past kp = 128 the rank
// schedules and the dual take the panel frame (ALONE), one system a block
// with the panel's buffers and two slots, as B5a: 124.3 KB at kp = 136,
// 169.2 KB at 160. (Before, PR 16's dual block kept its pair past kp = 132
// in one slot a system, 162 KB at 136 and 221.7 KB at 160, so its factor
// and substitutions took turns.) One slot would let two blocks share an
// SM up to kp = 156 (85.9 KB at 136, 111.0 KB at 156, against the SM's
// 228 KB less 1 KB a block); measured, that lost (see min_blocks).
constexpr int SMEM_MAX = 227 * 1024;   // an H100 block's dynamic bytes

struct Layout {
    int ntiles, ps, lsz;
    int work, slot0, slot_floats, nslot, nbar, total;
};

__host__ __device__ inline Layout layout(int kp, int sched) {
    Layout q;
    const int T = kp / 4, ns = systems(sched);
    q.ntiles = T * (T + 1) / 2;
    q.ps = kp + 4;
    q.lsz = (tri(kp) + 3) & ~3;
    q.work = ns * q.ntiles * 16;
    q.slot0 = q.work + (panel_frame(sched) ? 2 * PW : 8 * ns) * q.ps;
    q.slot_floats = q.lsz + 2 * kp;
    q.nslot = 2;
    if (4 * (q.slot0 + 2 * ns * q.slot_floats + kp) > SMEM_MAX) q.nslot = 1;
    q.nbar = q.slot0 + q.nslot * ns * q.slot_floats;
    q.total = q.nbar + kp;
    return q;
}

// Thread configurations: NTH factor threads with NT tiles each cover the
// T (T + 1) / 2 tiles: <160, 1> up to k = 68, <224, 2> up to k = 116,
// <224, 3> to k = 128, <224, 4> (896 tiles; 820 at kp = 160) past it; a
// block adds a substitution warp per system, whose lanes hold NQ rows each
// (3 at <160, 1>, 4 to k = 128, 5 past it). A
// block's warps share the SM's four schedulers, each with a quarter of the
// registers, so 224 + 32 threads (8 warps) at two blocks per SM keep 128
// registers a thread where 256 + 32 (9 warps) kept 96 and spilled. DUAL
// (one block per SM above k = 68) takes <288, 2> there: 288 + 64 threads
// are 11 warps, three on one scheduler, which caps a thread at 168
// registers, and two tiles a thread of each system fit in 154 without
// spills. On an H100 at k = 128, <224, 3> (9 warps, the same cap, three
// tiles) spilled 204 bytes, and <192, 3> (8 warps, 214 registers) ran
// 19.0 ms against 15.6 (PERF.md). Past k = 128 every schedule is one
// system a block at <224, 4>, and every one runs the panel frame (RANK1,
// PAIR and DUAL as ALONE, SCHUR as SCHUR_PANEL; see the header): a column
// or pair step a barrier there left one
// block an SM (shared memory allows no more) idle at 160 or 80 barriers a
// system. (Before, DUAL took <288, 3>, 864 tiles, with three tiles of
// each of its two systems a thread; 168 registers and 268 bytes of
// spills.)
int frame_config(int kp) {
    const int T = kp / 4, tiles = T * (T + 1) / 2;
    return kp > 128 ? 3 : tiles <= 160 ? 0 : tiles <= 448 ? 1 : 2;
}

// Residency targets (blocks per SM; measured on an H100, PERF.md): at
// k <= 68, 5 blocks of the rank kernels (64 registers) and 4 of the panel
// and Schur kernels (80: the panel's diagonal block lives in registers;
// the Schur groups add a 4 x 4 accumulator to the rank-2 step's); 7 and 5
// spilled and ran 24-28% slower, 8 and 6 no faster; 6 rank blocks ran
// within 2%, 3 panel blocks 7% slower. The card's occupancy query holds 4
// blocks of either at k = 64 (the rank kernels' registers alone would
// allow 5). Above, 2 blocks (shared memory allows no more at k = 128; 1
// ran 16-74% slower). DUAL holds two systems' tiles (twice the
// accumulators): at k <= 68, 3 blocks of 224 threads (80 registers; 2
// blocks, at 117 registers without spills, ran 10% slower at k = 64);
// above, one block (its shared memory allows no more at k = 128). Schur at
// k <= 68: 3 blocks, at 96 registers without spills, ran 18% slower. Past
// k = 128 (the NQ = 5 configurations) the target is 1 at every kp: shared
// memory allows one block of the panel frame with two slots (124.3-169.2
// KB), and a thread of four tiles is not held to 128 registers (the panel
// frame takes 217-231). Two blocks of the
// panel frame with one slot each, which fit to kp = 156, are held to 128
// registers and spilled 368 bytes; on an H100 at 65,536 rows they ran
// 29-32% slower at k = 129-153 with one-row substitutions (17.5 ms against
// 13.3 at k = 136) and 10-17% slower with two-row ones (PERF.md, PR 18).
constexpr int min_blocks(int nth, int nq, int sched) {
    return nq == 5       ? 1
           : sched == DUAL ? (nth == 160 ? 3 : 1)
           : nth != 160  ? 2
           : sched == PANEL || sched == SCHUR ? 4
                                              : 5;
}

// r with tri(r) <= t < tri(r + 1): tile t's column, counted from the right
__device__ __forceinline__ int tri_root(int t) {
    int r = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while (tri(r + 1) <= t) ++r;
    while (tri(r) > t) --r;
    return r;
}

// A factor thread's tiles of the lower triangle (ti >= tl), numbered by
// column from the right: tile t = tid + n NTH, t = 0 the last column's.
template <int NT>
struct Tiles {
    int ti[NT], tl[NT];
    bool live[NT];
    float a[NT][4][4];
};

template <int NTH, int NT>
__device__ __forceinline__ void own_tiles(int tid, int T, Tiles<NT>& s) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        const int t = tid + n * NTH;
        s.live[n] = t < tri(T);
        const int r = tri_root(t);
        s.tl[n] = s.live[n] ? T - 1 - r : 0;
        s.ti[n] = s.live[n] ? T - 1 - r + (t - tri(r)) : 0;
    }
}

// The thread's tiles of system b into the stage (row r of tile t at
// (r ntiles + t) 4); rows and columns past k are not copied (take masks
// them).
template <int NTH, int NT>
__device__ __forceinline__ void prefetch(const Tiles<NT>& s, float* stage,
                                         int ntiles, const float* G, int b,
                                         int k, int vec, int tid) {
    const float* Gb = G + (size_t)b * k * k;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        if (!s.live[n]) continue;
        const int t = tid + n * NTH, l0 = s.tl[n] * 4;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = s.ti[n] * 4 + r;
            if (i >= k) continue;
            float* dst = stage + ((size_t)r * ntiles + t) * 4;
            const float* src = Gb + (size_t)i * k + l0;
            if (vec) {
                cp_async16(dst, src);
            } else {
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    if (l0 + c < k) cp_async4(dst + c, src + c);
            }
        }
    }
}

// The staged system into the tiles: A = G + rb I, identity on the padding
// (and G = 0 for a system that is not present: nothing was staged).
template <int NTH, int NT>
__device__ __forceinline__ void take(Tiles<NT>& s, const float* stage,
                                     int ntiles, int k, float rb,
                                     bool present, int tid) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        const int t = tid + n * NTH, l0 = s.tl[n] * 4;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = s.ti[n] * 4 + r;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (present && s.live[n] && i < k)
                v = *reinterpret_cast<const float4*>(
                    stage + ((size_t)r * ntiles + t) * 4);
            const float g[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int l = l0 + c;
                float x = (i < k && l < k) ? g[c] : 0.f;
                if (i == l) x += (i < k) ? rb : 1.f;
                s.a[n][r][c] = x;
            }
        }
    }
}

// Owners of column j write A[i][j] for rows i > j into buf (0 for rows
// <= j) and the pivot A[j][j] into buf[kp].
template <int NT>
__device__ __forceinline__ void publish(const Tiles<NT>& s, int j, int kp,
                                        float* buf) {
    const int jt = j >> 2, jj = j & 3;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        if (s.live[n] && s.tl[n] == jt) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = s.ti[n] * 4 + r;
                const float v = pick4(s.a[n][r], jj);
                buf[i] = i > j ? v : 0.f;
                if (i == j) buf[kp] = v;
            }
        }
    }
}

// What a factor writes: thread tid's row of L, packed (row i at tri(i),
// lrow = tri(tid)); the substitution warp derives 1 / L_jj from its
// diagonal.
struct Out {
    float* L;
    int lrow, k, kp;
};

// The last column step in which factor warp w has work: its tiles are
// numbered by column from the right, so its first lane's first tile is its
// rightmost, and a tile of column tl is published and updated up to step
// 4 tl + 3; thread i < k writes row i of L up to step i. -1 for a warp
// with neither.
__device__ __forceinline__ int warp_exit(int w, int T, int k) {
    const int t = 32 * w;
    int e = t < k ? min(k - 1, t + 31) : -1;
    if (t < tri(T)) e = max(e, 4 * (T - 1 - tri_root(t)) + 3);
    return e;
}

// One right-looking column step for each of the block's NS systems: the
// owners publish column j (buffer b, system w's at b + 4 w bs), a barrier
// of the nb threads still factoring (named barrier bar), then thread
// i >= j writes L[i][j] and every thread applies the rank-1 update to its
// trailing tiles.
template <int NT>
__device__ __forceinline__ void finish1(Tiles<NT>& s, const Out& o, int j,
                                        const float* buf, int tid) {
    const float d = buf[o.kp];
    const float inv = rsqrt_normal(fmaxf(d, PIVOT_FLOOR));
    const float inv2 = inv * inv;
    if (tid < o.k && tid >= j)
        o.L[o.lrow + j] = (tid == j ? d : buf[tid]) * inv;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        if (!s.live[n]) continue;
        const int i0 = s.ti[n] * 4, l0 = s.tl[n] * 4;
        if (l0 + 3 > j) {   // the tile still has trailing columns
            const float4 qi = *reinterpret_cast<const float4*>(buf + i0);
            const float4 ql = *reinterpret_cast<const float4*>(buf + l0);
            const float ci[4] = {qi.x * inv2, qi.y * inv2, qi.z * inv2,
                                 qi.w * inv2};
            const float cl[4] = {ql.x, ql.y, ql.z, ql.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    s.a[n][r][c] = fmaf(-ci[r], cl[c], s.a[n][r][c]);
        }
    }
}

template <int NT, int NS>
__device__ __forceinline__ void step1(Tiles<NT> (&s)[NS],
                                      const Out (&o)[NS], int j, float* b,
                                      int bs, int tid, int bar, int nb) {
#pragma unroll
    for (int w = 0; w < NS; ++w) publish(s[w], j, o[w].kp, b + 4 * w * bs);
    bar_sync(bar, nb);
#pragma unroll
    for (int w = 0; w < NS; ++w) finish1<NT>(s[w], o[w], j, b + 4 * w * bs,
                                             tid);
}

// One rank-2 step over columns (j, j + 1), j even, for each of the NS
// systems: both columns published raw (b1, b1 + bs), one barrier; thread
// i >= j writes L[i][j] and, corrected by it, L[i][j+1], and every thread
// applies the rank-2 update, with LEFT (the Schur factor's first phase)
// only to the tiles left of column 4 ht.
template <int NT, bool LEFT>
__device__ __forceinline__ void finish2(Tiles<NT>& s, const Out& o, int j,
                                        const float* b1, int bs, int tid,
                                        int ht) {
    const float* b2 = b1 + bs;
    const float d1 = b1[o.kp];
    const float inv1 = rsqrt_normal(fmaxf(d1, PIVOT_FLOOR));
    const float l12 = b1[j + 1] * inv1;             // L[j+1][j]
    const float d2 = fmaf(-l12, l12, b2[o.kp]);
    const float inv2 = rsqrt_normal(fmaxf(d2, PIVOT_FLOOR));
    if (tid < o.k && tid >= j) {
        if (tid == j) {
            o.L[o.lrow + j] = d1 * inv1;
        } else {
            const float c1 = b1[tid] * inv1;
            o.L[o.lrow + j] = c1;
            o.L[o.lrow + j + 1] = tid == j + 1
                                      ? d2 * inv2
                                      : fmaf(-c1, l12, b2[tid]) * inv2;
        }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        if (!s.live[n] || (LEFT && s.tl[n] >= ht)) continue;
        const int i0 = s.ti[n] * 4, l0 = s.tl[n] * 4;
        if (l0 + 3 > j) {
            const float4 p1 = *reinterpret_cast<const float4*>(b1 + i0);
            const float4 p2 = *reinterpret_cast<const float4*>(b2 + i0);
            const float4 q1 = *reinterpret_cast<const float4*>(b1 + l0);
            const float4 q2 = *reinterpret_cast<const float4*>(b2 + l0);
            const float r1[4] = {p1.x, p1.y, p1.z, p1.w};
            const float r2[4] = {p2.x, p2.y, p2.z, p2.w};
            const float s1[4] = {q1.x, q1.y, q1.z, q1.w};
            const float s2[4] = {q2.x, q2.y, q2.z, q2.w};
            float ci1[4], ci2[4], cl1[4], cl2[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                ci1[r] = r1[r] * inv1;
                ci2[r] = i0 + r > j + 1 ? fmaf(-ci1[r], l12, r2[r]) * inv2
                                        : 0.f;
                cl1[r] = s1[r] * inv1;
                cl2[r] = l0 + r > j + 1 ? fmaf(-cl1[r], l12, s2[r]) * inv2
                                        : 0.f;
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    s.a[n][r][c] = fmaf(-ci2[r], cl2[c],
                                        fmaf(-ci1[r], cl1[c], s.a[n][r][c]));
        }
    }
}

template <int NT, int NS, bool LEFT = false>
__device__ __forceinline__ void step2(Tiles<NT> (&s)[NS],
                                      const Out (&o)[NS], int j, float* b,
                                      int bs, int tid, int bar, int nb,
                                      int ht = 0) {
#pragma unroll
    for (int w = 0; w < NS; ++w) {
        publish(s[w], j, o[w].kp, b + 4 * w * bs);
        publish(s[w], j + 1, o[w].kp, b + 4 * w * bs + bs);
    }
    bar_sync(bar, nb);
#pragma unroll
    for (int w = 0; w < NS; ++w)
        finish2<NT, LEFT>(s[w], o[w], j, b + 4 * w * bs, bs, tid, ht);
}

// One group of the Schur factor's deferred update, A22 -= L21 L21^T over
// L's columns g .. g + 7, read from the packed L: each tile of A22 (row
// and column at or past h = 4 ht) sums its eight terms in order p = g ..
// g + 7, then subtracts the sum. A22's tri(ht) tiles are the first in the
// column-from-the-right order, so they are all n = 0 tiles
// (tri(ht) <= NTH at every k % 16 == 0: 210 <= 224 at k = 160).
template <int NT>
__device__ __forceinline__ void schur_group(Tiles<NT>& s, const float* L,
                                            int g, int ht) {
    if (!s.live[0] || s.tl[0] < ht) return;
    const int i0 = s.ti[0] * 4, l0 = s.tl[0] * 4;
    int ri[4], rl[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        ri[r] = tri(i0 + r) + g;
        rl[r] = tri(l0 + r) + g;
    }
    // two rows at a time: half the accumulators live at once, each sum
    // in the same order
#pragma unroll
    for (int r0 = 0; r0 < 4; r0 += 2) {
        float acc[2][4] = {};
#pragma unroll
        for (int p = 0; p < PW; ++p) {
            float ll[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) ll[c] = L[rl[c] + p];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float li = L[ri[r0 + r] + p];
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    acc[r][c] = fmaf(li, ll[c], acc[r][c]);
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s.a[0][r0 + r][c] -= acc[r][c];
    }
}

// The rank-8 panel factor (see the header). The panel goes to one of two
// buffers by panel parity (a panel's publish must not overwrite the last
// panel's while slower threads still update from it), column-major: column
// c of the panel at R + c ps, row i at [i]. SCHED is the order of the
// trailing update's terms: PANEL sums a panel's eight terms and subtracts
// the sum, ALONE subtracts each term in turn, and SCHUR_PANEL (k % 16 ==
// 0, h = k / 2 = 4 ht) takes Schur's order: a panel left of h updates the
// tiles left of h term by term and A22's tiles (tl >= ht, untouched by
// the panels before) by its grouped sum, the group of L's columns j0 ..
// j0 + 7 that the reference defers to its phase 2; a panel from h on
// updates term by term.
template <int NTH, int NT, int SCHED>
__device__ __forceinline__ void factor_panel(Tiles<NT>& s, const Out& o,
                                             float* work, int ps, int tid) {
    const int kp = o.kp, h = kp >> 1, ht = h >> 2;
    for (int j0 = 0; j0 < kp; j0 += PW) {
        float* R = work + ((j0 / PW) & 1) * PW * ps;
        // a panel narrower than PW (kp % 8 == 4) is the last; its missing
        // columns act as identity columns
        const int pw = min(PW, kp - j0), t0 = j0 >> 2;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            if (s.live[n] && s.tl[n] >= t0 && s.tl[n] * 4 < j0 + pw) {
                const int c0 = s.tl[n] * 4 - j0, i0 = s.ti[n] * 4;
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    *reinterpret_cast<float4*>(R + (c0 + c) * ps + i0) =
                        make_float4(s.a[n][0][c], s.a[n][1][c], s.a[n][2][c],
                                    s.a[n][3][c]);
            }
        }
        bar_sync(BAR_FACTOR, NTH);
        if (tid >= j0 && tid < kp) {
            // the diagonal block's factor D (lower) and inv_c, left-looking:
            // column c takes the terms of columns p < c in order
            float D[PW][PW], inv[PW];
#pragma unroll
            for (int c = 0; c < PW; ++c) {
                if (c >= pw) {
                    inv[c] = 1.f;
#pragma unroll
                    for (int p = 0; p < PW; ++p) D[c][p] = 0.f;
                    continue;
                }
                float d = R[c * ps + j0 + c];
#pragma unroll
                for (int p = 0; p < c; ++p) d = fmaf(-D[c][p], D[c][p], d);
                inv[c] = rsqrt_normal(fmaxf(d, PIVOT_FLOOR));
                D[c][c] = d * inv[c];
#pragma unroll
                for (int r = c + 1; r < PW; ++r) {
                    float x = r < pw ? R[c * ps + j0 + r] : 0.f;
#pragma unroll
                    for (int p = 0; p < c; ++p) x = fmaf(-D[r][p], D[c][p], x);
                    D[r][c] = x * inv[c];
                }
            }
            // this thread's row against D, in the same order: for a row of
            // the diagonal block (rr < PW) the entries left of its diagonal
            // repeat D's own arithmetic, and its pivot is D's
            const int rr = tid - j0;
            float v[PW], l[PW];
#pragma unroll
            for (int c = 0; c < PW; ++c)
                v[c] = c < pw ? R[c * ps + tid] : 0.f;
#pragma unroll
            for (int c = 0; c < PW; ++c) {
                float x = v[c];
#pragma unroll
                for (int p = 0; p < c; ++p) x = fmaf(-l[p], D[c][p], x);
                l[c] = c <= rr ? x * inv[c] : 0.f;
            }
            if (rr >= PW) {
#pragma unroll
                for (int c = 0; c < PW; ++c) R[c * ps + tid] = l[c];
            }
            if (tid < o.k) {
#pragma unroll
                for (int c = 0; c < PW; ++c) {
                    // c == rr: the pivot (x was d), L_jj = d inv_j
                    if (c <= rr && c < pw) o.L[o.lrow + j0 + c] = l[c];
                }
            }
        }
        bar_sync(BAR_FACTOR, NTH);
        // one rank-8 update of the tiles right of the panel (only a full
        // panel has such tiles)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            if (!s.live[n] || s.tl[n] * 4 < j0 + PW) continue;
            const int i0 = s.ti[n] * 4, l0 = s.tl[n] * 4;
            const bool grouped = SCHED == PANEL
                                 || (SCHED == SCHUR_PANEL && j0 < h
                                     && s.tl[n] >= ht);
            if (!grouped) {
                // each of the eight terms subtracted in turn, in p order
#pragma unroll
                for (int p = 0; p < PW; ++p) {
                    const float4 u = *reinterpret_cast<const float4*>(
                        R + p * ps + i0);
                    const float4 w = *reinterpret_cast<const float4*>(
                        R + p * ps + l0);
                    const float pi[4] = {u.x, u.y, u.z, u.w};
                    const float pl[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            s.a[n][r][c] = fmaf(-pi[r], pl[c], s.a[n][r][c]);
                }
                continue;
            }
            float acc[4][4] = {};
#pragma unroll
            for (int p = 0; p < PW; ++p) {
                const float4 u = *reinterpret_cast<const float4*>(
                    R + p * ps + i0);
                const float4 w = *reinterpret_cast<const float4*>(
                    R + p * ps + l0);
                const float pi[4] = {u.x, u.y, u.z, u.w};
                const float pl[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        acc[r][c] = fmaf(pi[r], pl[c], acc[r][c]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) s.a[n][r][c] -= acc[r][c];
        }
    }
}

template <int NQ>
__device__ __forceinline__ float pick(const float (&y)[NQ], int q) {
    float v = y[0];
#pragma unroll
    for (int s = 1; s < NQ; ++s) v = q == s ? y[s] : v;
    return v;
}

// Forward (L y = b) and back (L^T x = y) substitution in one warp against
// the packed L, SROWS rows per shuffle round, with the right-hand side in
// registers (lane l holds rows l, l + 32, ...). The warp first writes
// 1 / max(L_jj, 1e-30) into rinv (correctly rounded, as 1.f / x); each
// round loads its L entries and 1 / L_jj before its shuffle. Rows at or
// past k are never read into the result. SELECTS (the panel frame of the
// rank schedules, ALONE) takes a two-row round's results by selects: the
// nested conditional of the other kernels compiles to a divergent branch
// for each of a lane's rows (BSSY / BSYNC), and their two-row rounds take
// twice a one-row round's time a row (same bits either way).
template <int SROWS, int NQ, bool SELECTS = false>
__device__ __forceinline__ void substitute(const float* L, float* rinv,
                                           const float* ys, float* ob, int k,
                                           int lane) {
    float y[NQ];
    int ti[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int i = lane + 32 * q;
        y[q] = i < k ? ys[i] : 0.f;
        ti[q] = tri(min(i, k - 1));   // rows past k: in bounds, unused
        if (i < k) rinv[i] = __frcp_rn(fmaxf(L[ti[q] + i], PIVOT_FLOOR));
    }
    __syncwarp();
    int j = 0;
    if (SROWS == 2) {
#pragma unroll 2
        for (; j + 1 < k; j += 2) {
            float l0[NQ], l1[NQ];
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                l0[q] = L[ti[q] + j];
                l1[q] = L[ti[q] + j + 1];
            }
            const float r0 = rinv[j], r1 = rinv[j + 1];
            const float d10 = L[tri(j + 1) + j];
            const float bj = __shfl_sync(0xffffffffu, pick(y, j >> 5),
                                         j & 31);
            const float bj1 = __shfl_sync(0xffffffffu, pick(y, (j + 1) >> 5),
                                          (j + 1) & 31);
            const float yj = bj * r0;
            const float yj1 = fmaf(-d10, yj, bj1) * r1;
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const int i = lane + 32 * q;
                const float u = fmaf(-l1[q], yj1, fmaf(-l0[q], yj, y[q]));
                if constexpr (SELECTS) {
                    float v = (i > j + 1) & (i < k) ? u : y[q];
                    v = i == j + 1 ? yj1 : v;
                    y[q] = i == j ? yj : v;
                } else {
                    y[q] = i == j ? yj : i == j + 1 ? yj1
                           : (i > j + 1 && i < k) ? u : y[q];
                }
            }
        }
    }
#pragma unroll 4
    for (; j < k; ++j) {
        float l0[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) l0[q] = L[ti[q] + j];
        const float r0 = rinv[j];
        const float yj = __shfl_sync(0xffffffffu, pick(y, j >> 5), j & 31)
                         * r0;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            const int i = lane + 32 * q;
            const float u = fmaf(-l0[q], yj, y[q]);
            y[q] = i == j ? yj : (i > j && i < k) ? u : y[q];
        }
    }
    // back substitution: row j of L is column j of L^T
    j = k - 1;
    if (SROWS == 2) {
#pragma unroll 2
        for (; j >= 1; j -= 2) {
            const float* Lj = L + tri(j);
            const float* Lj1 = L + tri(j - 1);
            float a0[NQ], a1[NQ];
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const int i = min(lane + 32 * q, j);
                a0[q] = Lj[i];
                a1[q] = Lj1[min(i, j - 1)];
            }
            const float r0 = rinv[j], r1 = rinv[j - 1];
            const float d = Lj[j - 1];
            const float xj = __shfl_sync(0xffffffffu, pick(y, j >> 5),
                                         j & 31) * r0;
            const float yj1 = __shfl_sync(0xffffffffu, pick(y, (j - 1) >> 5),
                                          (j - 1) & 31);
            const float xj1 = fmaf(-d, xj, yj1) * r1;
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const int i = lane + 32 * q;
                const float u = fmaf(-a1[q], xj1, fmaf(-a0[q], xj, y[q]));
                if constexpr (SELECTS) {
                    float v = i < j - 1 ? u : y[q];
                    v = i == j - 1 ? xj1 : v;
                    y[q] = i == j ? xj : v;
                } else {
                    y[q] = i == j ? xj : i == j - 1 ? xj1
                           : i < j - 1 ? u : y[q];
                }
            }
        }
    }
#pragma unroll 4
    for (; j >= 0; --j) {
        const float* Lj = L + tri(j);
        float a0[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) a0[q] = Lj[min(lane + 32 * q, j)];
        const float r0 = rinv[j];
        const float xj = __shfl_sync(0xffffffffu, pick(y, j >> 5), j & 31)
                         * r0;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            const int i = lane + 32 * q;
            const float u = fmaf(-a0[q], xj, y[q]);
            y[q] = i == j ? xj : i < j ? u : y[q];
        }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q)
        if (lane + 32 * q < k) ob[lane + 32 * q] = y[q];
}

// NTH factor threads with NT tiles each, plus one substitution warp per
// system (DUAL: two systems a block, b = 2 p and 2 p + 1 for the block's
// pair p) with NQ rows a lane (kp <= 32 NQ); SCHED the factor schedule,
// SROWS the substitutions' rows per round.
template <int NTH, int NT, int NQ, int SCHED, int SROWS>
__global__ void __launch_bounds__(block_threads(NTH, SCHED),
                                  min_blocks(NTH, NQ, SCHED))
rank_panel_kernel(const float* __restrict__ G, const float* __restrict__ rhs,
                  const float* __restrict__ reg, float* __restrict__ out,
                  int B, int k, int kp, int vec) {
    constexpr int NS = systems(SCHED);
    constexpr int HAND = block_threads(NTH, SCHED);   // FULL / EMPTY count
    extern __shared__ __align__(16) float smem[];
    const Layout q = layout(kp, SCHED);
    float* work = smem + q.work;
    const int tid = threadIdx.x;
    // this block's systems (pairs): p = blockIdx.x + it gridDim.x
    const int count = ((B + NS - 1) / NS - (int)blockIdx.x
                       + (int)gridDim.x - 1) / (int)gridDim.x;
    // the rank steps' barrier counts: 32 x the factor warps with work at
    // step j
    int* nbar = reinterpret_cast<int*>(smem + q.nbar);
    if (!panel_frame(SCHED)) {
        for (int j = tid; j < kp; j += HAND) {
            int n = 0;
            for (int w = 0; w < NTH / 32; ++w)
                n += warp_exit(w, kp >> 2, k) >= j;
            nbar[j] = 32 * n;
        }
    }
    __syncthreads();

    if (tid >= NTH) {
        // substitution warp w: slot (it % nslot, w) holds system it's
        // factor; a system past the batch (DUAL, odd B) still takes the
        // hand-overs
        const int lane = tid & 31, w = (tid - NTH) >> 5;
        for (int it = 0; it < count; ++it) {
            const int s = it % q.nslot;
            const int b = (blockIdx.x + it * gridDim.x) * NS + w;
            float* slot = smem + q.slot0 + (s * NS + w) * q.slot_floats;
            bar_sync(BAR_FULL + s, HAND);
            if (NS == 1 || b < B)
                substitute<SROWS, NQ,
                           SCHED == ALONE || SCHED == SCHUR_PANEL>(
                    slot, slot + q.lsz + kp, slot + q.lsz,
                    out + (size_t)b * k, k, lane);
            // the factor threads wait for the slot only if they use it again
            if (it + q.nslot < count) bar_arrive(BAR_EMPTY + s, HAND);
        }
        return;
    }

    Tiles<NT> t[NS];
    own_tiles<NTH, NT>(tid, kp >> 2, t[0]);
#pragma unroll
    for (int w = 1; w < NS; ++w) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            t[w].ti[n] = t[0].ti[n];
            t[w].tl[n] = t[0].tl[n];
            t[w].live[n] = t[0].live[n];
        }
    }
    // system w's stage, and its next system: present (a DUAL pair's second
    // system past an odd B is the identity with rhs 0, not stored), ridge,
    // right-hand side
    float* stage[NS];
    bool here[NS];
    float rb[NS], bi[NS];
    int p = blockIdx.x;
#pragma unroll
    for (int w = 0; w < NS; ++w) {
        stage[w] = smem + w * q.ntiles * 16;
        const int b = p * NS + w;
        here[w] = NS == 1 || b < B;
        if (here[w]) prefetch<NTH, NT>(t[w], stage[w], q.ntiles, G, b, k,
                                       vec, tid);
        rb[w] = here[w] ? reg[b] : 1.f;
        bi[w] = here[w] && tid < k ? rhs[(size_t)b * k + tid] : 0.f;
    }
    // the last rank step this thread's warp takes part in
    const int last = warp_exit(tid >> 5, kp >> 2, k);
    for (int it = 0; it < count; ++it, p += gridDim.x) {
        // s: the system's parity (its barrier and column buffers); sl: its
        // slot
        const int s = it & 1, sl = it % q.nslot;
        Out o[NS];
#pragma unroll
        for (int w = 0; w < NS; ++w)
            o[w] = {smem + q.slot0 + (sl * NS + w) * q.slot_floats,
                    tri(min(tid, KMAX - 1)), k, kp};
        if (it >= q.nslot) bar_sync(BAR_EMPTY + sl, HAND);
        cp_async_wait_all();
#pragma unroll
        for (int w = 0; w < NS; ++w) {
            take<NTH, NT>(t[w], stage[w], q.ntiles, k, rb[w], here[w], tid);
            if (tid < k) o[w].L[q.lsz + tid] = bi[w];
        }
        if (it + 1 < count) {
            const int pn = p + gridDim.x;
#pragma unroll
            for (int w = 0; w < NS; ++w) {
                const int bn = pn * NS + w;
                here[w] = NS == 1 || bn < B;
                if (here[w]) prefetch<NTH, NT>(t[w], stage[w], q.ntiles, G,
                                               bn, k, vec, tid);
                rb[w] = here[w] ? reg[bn] : 1.f;
                bi[w] = here[w] && tid < k ? rhs[(size_t)bn * k + tid] : 0.f;
            }
        }
        // a warp leaves the rank steps after its last step (its tiles are
        // done); the column buffers alternate by step, and this system's
        // (pair's) sets are its parity's
        const int bs = q.ps, bar = s ? BAR_FACTOR_ODD : BAR_FACTOR;
        float* cb = work + s * NS * 4 * bs;
        if constexpr (panel_frame(SCHED)) {
            factor_panel<NTH, NT, SCHED>(t[0], o[0], work, q.ps, tid);
        } else if constexpr (SCHED == SCHUR) {
            // k % 16 == 0, so kp == k; h = k / 2 = 4 ht. Phase 1 (rank-2
            // steps over [0, h), left tiles only) carries phase 2: after
            // step j's barrier L's columns < j are complete, and A22's
            // tiles take group j - 8 while the left tiles' steps go on.
            // The last group waits for one more barrier (the warps still
            // factoring at step h); then phase 3 over [h, k).
            const int h = k >> 1, ht = h >> 2;
            int j = 0;
            for (; j < h && j <= last; j += 2) {
                step2<NT, 1, true>(t, o, j, cb + ((j >> 1) & 1) * 2 * bs,
                                   bs, tid, bar, nbar[j], ht);
                if (j >= PW && j % PW == 0)
                    schur_group<NT>(t[0], o[0].L, j - PW, ht);
            }
            if (h <= last) {
                bar_sync(bar, nbar[h]);
                schur_group<NT>(t[0], o[0].L, h - PW, ht);
            }
            for (j = h; j < k && j <= last; j += 2)
                step2<NT, 1>(t, o, j, cb + ((j >> 1) & 1) * 2 * bs, bs, tid,
                             bar, nbar[j]);
        } else {
            // RANK1, PAIR, DUAL (the pair schedule for both systems, one
            // barrier a step)
            constexpr bool two = SCHED != RANK1;
            int j = 0;
            if constexpr (two) {
                for (; j + 1 < k && j <= last; j += 2)
                    step2<NT, NS>(t, o, j, cb + ((j >> 1) & 1) * 2 * bs, bs,
                                  tid, bar, nbar[j]);
            }
            for (; j < k && j <= last; ++j)
                step1<NT, NS>(t, o, j, cb + ((j >> two) & 1) * 2 * bs, bs,
                              tid, bar, nbar[j]);
        }
        // L, y's right-hand side and 1 / L_jj of the systems are in the
        // slots
        __threadfence_block();
        bar_arrive(BAR_FULL + sl, HAND);
    }
}

template <int NTH, int NT, int NQ, int SCHED, int SROWS>
cudaError_t launch(const float* G, const float* rhs, const float* reg,
                   float* out, int B, int k, int kp, int vec,
                   cudaStream_t stream, long long* resident) {
    const size_t smem = sizeof(float) * layout(kp, SCHED).total;
    const auto kern = rank_panel_kernel<NTH, NT, NQ, SCHED, SROWS>;
    constexpr int nth = block_threads(NTH, SCHED), ns = systems(SCHED);
    if (resident)
        return chol::resident_blocks(reinterpret_cast<const void*>(kern),
                                     nth, smem, resident);
    return chol::launch_persistent(kern, nth, smem, (B + ns - 1) / ns,
                                   stream, G, rhs, reg, out, B, k, kp, vec);
}

// Launches the kernel of (SCHED, SROWS) at order k, or with resident set
// reports its resident blocks on the current device and launches nothing.
template <int SCHED, int SROWS>
cudaError_t dispatch(const void* G, const void* rhs, const void* reg,
                     void* out, int B, int k, void* stream,
                     long long* resident = nullptr) {
    if (k < 1 || k > KMAX || B < 0) return cudaErrorInvalidValue;
    if (SCHED == SCHUR && k % 16) return cudaErrorInvalidValue;
    if (B == 0 && !resident) return cudaSuccess;
    const int kp = (k + 3) & ~3;
    const int vec = (k % 4 == 0) && (((uintptr_t)G & 15) == 0);
    auto g = static_cast<const float*>(G);
    auto r = static_cast<const float*>(rhs);
    auto rg = static_cast<const float*>(reg);
    auto o = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    if constexpr (SCHED == DUAL) {
        switch (frame_config(kp)) {
        case 0:
            return launch<160, 1, 3, SCHED, SROWS>(g, r, rg, o, B, k, kp,
                                                   vec, s, resident);
        case 3:
            return launch<224, 4, 5, ALONE, SROWS>(g, r, rg, o, B, k, kp,
                                                   vec, s, resident);
        default:
            return launch<288, 2, 4, SCHED, SROWS>(g, r, rg, o, B, k, kp,
                                                   vec, s, resident);
        }
    } else {
        switch (frame_config(kp)) {
        case 0:
            return launch<160, 1, 3, SCHED, SROWS>(g, r, rg, o, B, k, kp,
                                                   vec, s, resident);
        case 1:
            return launch<224, 2, 4, SCHED, SROWS>(g, r, rg, o, B, k, kp,
                                                   vec, s, resident);
        case 2:
            return launch<224, 3, 4, SCHED, SROWS>(g, r, rg, o, B, k, kp,
                                                   vec, s, resident);
        default: {
            // past kp = 128 RANK1 and PAIR take the panel frame (ALONE),
            // SCHUR the panel frame in its own order (SCHUR_PANEL)
            constexpr int sched = SCHED == RANK1 || SCHED == PAIR ? ALONE
                                  : SCHED == SCHUR ? SCHUR_PANEL
                                                   : SCHED;
            return launch<224, 4, 5, sched, SROWS>(g, r, rg, o, B, k, kp,
                                                   vec, s, resident);
        }
        }
    }
}

// The kernels of this source, by (schedule, srows): the rank-1 schedules
// (fcols, srows) = (1, 1), (1, 2), (2, 1); the panel (PANEL, 1); Schur
// (SCHUR, 1 or 2); dual (DUAL, 2). -1 for any other pair.
int kind_of(int sched, int srows) {
    return sched == RANK1 && srows == 1   ? 0
           : sched == RANK1 && srows == 2 ? 1
           : sched == PAIR && srows == 1  ? 2
           : sched == PANEL && srows == 1 ? 3
           : sched == SCHUR && srows == 1 ? 4
           : sched == SCHUR && srows == 2 ? 5
           : sched == DUAL && srows == 2  ? 6
                                          : -1;
}

cudaError_t by_kind(int kind, const void* G, const void* rhs,
                    const void* reg, void* out, int B, int k, void* stream,
                    long long* resident) {
    auto s = stream;
    auto r = resident;
    switch (kind) {
    case 0: return dispatch<RANK1, 1>(G, rhs, reg, out, B, k, s, r);
    case 1: return dispatch<RANK1, 2>(G, rhs, reg, out, B, k, s, r);
    case 2: return dispatch<PAIR, 1>(G, rhs, reg, out, B, k, s, r);
    case 3: return dispatch<PANEL, 1>(G, rhs, reg, out, B, k, s, r);
    case 4: return dispatch<SCHUR, 1>(G, rhs, reg, out, B, k, s, r);
    case 5: return dispatch<SCHUR, 2>(G, rhs, reg, out, B, k, s, r);
    case 6: return dispatch<DUAL, 2>(G, rhs, reg, out, B, k, s, r);
    default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// x (B, k) = (G + diag(reg))^-1 rhs for G (B, k, k), rhs (B, k), reg (B,),
// all f32, contiguous, batch-major, 1 <= k <= 160: a right-looking factor
// with fcols (1 or 2) columns per step, then substitutions with srows (1 or
// 2) rows per step (past kp = 128 in the panel frame, every term alone).
// (fcols, srows) = (2, 2) is cholesky_solve_batched's combination and is
// refused here.
int cholesky_solve_rank1(const void* G, const void* rhs, const void* reg,
                         void* out, int B, int k, int fcols, int srows,
                         void* stream) {
    const int kind = fcols == 1 || fcols == 2 ? kind_of(fcols, srows) : -1;
    if (kind < 0) return (int)cudaErrorInvalidValue;
    return (int)by_kind(kind, G, rhs, reg, out, B, k, stream, nullptr);
}

// The same solve with the rank-8 panel factor and one-row substitutions.
int cholesky_solve_panel(const void* G, const void* rhs, const void* reg,
                         void* out, int B, int k, void* stream) {
    return (int)by_kind(3, G, rhs, reg, out, B, k, stream, nullptr);
}

// The same solve with the two-level Schur factor, k % 16 == 0, and srows
// (1 or 2) rows per substitution step.
int cholesky_solve_schur(const void* G, const void* rhs, const void* reg,
                         void* out, int B, int k, int srows, void* stream) {
    const int kind = kind_of(SCHUR, srows);
    if (kind < 0) return (int)cudaErrorInvalidValue;
    return (int)by_kind(kind, G, rhs, reg, out, B, k, stream, nullptr);
}

// cholesky_solve_batched's solve (B1, csrc/cholesky_solve.cu) past kp =
// 128 at a batch that its rule gives the panel frame
// (ops/cholesky.py::solve_frame): the factor in panels with every term
// alone and one-row substitutions, the kernel of cholesky_solve_rank1
// (1, 1) there (the same bits). 128 < kp, k <= 160, any B.
int cholesky_solve_batched_panel(const void* G, const void* rhs,
                                 const void* reg, void* out, int B, int k,
                                 void* stream) {
    if (frame_config((k + 3) & ~3) != 3) return (int)cudaErrorInvalidValue;
    return (int)by_kind(0, G, rhs, reg, out, B, k, stream, nullptr);
}

// The same solve with the rank-2 factor and two-row substitutions: to
// kp = 128 two systems a block, their factors interleaved (an odd B leaves
// the last block's second system empty); past it one system a block in
// the panel frame. Any B.
int cholesky_solve_dual(const void* G, const void* rhs, const void* reg,
                        void* out, int B, int k, void* stream) {
    return (int)by_kind(6, G, rhs, reg, out, B, k, stream, nullptr);
}

// *resident = the blocks of the kernel of (sched, srows) at order k that
// the current device holds at once (sched: 1 or 2, cholesky_solve_rank1's
// fcols; 8 the panel kernel; 16 Schur; 32 dual, whose block carries two
// systems to kp = 128). Launches nothing.
int cholesky_rank_panel_resident(int sched, int srows, int k,
                                 long long* resident) {
    const int kind = kind_of(sched, srows);
    if (kind < 0) return (int)cudaErrorInvalidValue;
    return (int)by_kind(kind, nullptr, nullptr, nullptr, nullptr, 0, k,
                        nullptr, resident);
}

// (cholesky_kernel_kmax and cholesky_error_string: cholesky_common.cuh)

}  // extern "C"
