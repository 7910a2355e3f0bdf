"""Where the time of one launch of the one-block kernel goes, inside it.

    python -m recommendation_models_tpu_torch.probes.cluster_trace \
        [--shapes 656:1:8,168:120:1,168:1:6,512:8:8]

Builds an instrumented copy of ``csrc/cholesky_large.cu`` (B1's
``cholesky_solve_large``) under ``build/cluster_trace/``: the source's
``csrc/cholesky_cluster.cuh`` with timestamps (``%globaltimer``, ns, the
same clock on every SM) written by thread 0 of each of the first 16 CTAs
at the frame's phase boundaries, and ``clock64`` cycle counts summed per
call of the tile update (whole tiles and the diagonal tile's quarters),
the diagonal factor, the rows below it and the back substitution block.
Then, for each shape ``k:B:C`` (B systems of order k, clusters of C
CTAs), three launches on random systems (``probes.solve_latency
.random_systems``, seed 0), the last one traced, and one JSON line:
``load_us`` (start to the first cluster barrier), ``forward_us`` (to the
last panel's publication), ``back_us`` (the back substitution),
``total_us``, ``steps`` (per lookahead step, in µs: the owner's wait and copy of
the first block of rows, the diagonal tile beside the copy of the rest,
the diagonal factor, the rows below), ``cycles_per_call``
by phase, ``clock_ghz`` (cycles over ns of CTA 0) and ``max_abs_err``
against float64 ``torch.linalg.solve``. Instrumentation adds its own
stores, so the totals sit a few percent above the untraced kernel's.

The instrumentation is inserted at fixed places of the header's text; a
header that no longer has one of them stops the probe with the place's
text. Runs only on a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

SLOTS = 256          # timestamps a CTA
TRACED = 16          # CTAs traced
STEP, TILE, DIAG, ROWS, BACK, END = 2, 130, 160, 192, 225, 250

_HOOKS = """
__device__ unsigned long long trace_buf[16 * 256];
__device__ unsigned long long trace_cyc[16 * 16];
#define T(slot) do { if (threadIdx.x == 0 && blockIdx.x < 16) { \\
    unsigned long long t_; asm volatile("mov.u64 %0, %globaltimer;" \\
    : "=l"(t_)); trace_buf[blockIdx.x * 256 + (slot)] = t_; \\
    if ((slot) == 0 || (slot) == 250) \\
        trace_buf[blockIdx.x * 256 + 251 + ((slot) == 250)] = clock64(); \\
    } } while (0)
#define CYC(slot, t0) do { if ((threadIdx.x & 31) == 0 \\
    && blockIdx.x < 16) { atomicAdd(&trace_cyc[blockIdx.x * 16 + (slot)], \\
    (unsigned long long)(clock64() - (t0))); \\
    atomicAdd(&trace_cyc[blockIdx.x * 16 + (slot) + 1], 1ull); } } while (0)
"""

# (text in csrc/cholesky_cluster.cuh, text with the hook)
_PLACES = [
    ("namespace clu {\n", "namespace clu {\n" + _HOOKS),
    ("    if (tid < np) {\n        const int o = owner_of(tid, C);",
     "    T(0);\n    if (tid < np) {\n        const int o = owner_of(tid, C);"),
    ("    cluster.sync();     // every CTA's signals set before any arrives\n",
     "    cluster.sync();     // every CTA's signals set before any arrives\n"
     "    T(1);\n"),
    ("        Panel L{cp, first * NB};\n",
     "        Panel L{cp, first * NB};\n        T(2 + 6 * j);\n"),
    ("            __syncthreads();\n            factor_panel<SCHED, SROWS>(",
     "            __syncthreads();\n            T(3 + 6 * j);\n"
     "            factor_panel<SCHED, SROWS>("),
    ("            if (warp == 0) signal_all(ready + first, C, lane);\n",
     "            if (warp == 0) signal_all(ready + first, C, lane);\n"
     "            T(4 + 6 * j);\n"),
    ("    if (warp == 0) {\n        factor_diagonal<SCHED, SROWS>(",
     "    if (warp == 0) {\n        T(130 + j);\n"
     "        factor_diagonal<SCHED, SROWS>("),
    ("rinv, pinv, DT, lane);\n    } else if (L) {",
     "rinv, pinv, DT, lane);\n        T(160 + j);\n    } else if (L) {"),
    ("    __syncthreads();\n    solve_rows<SCHED>(",
     "    __syncthreads();\n    T(192 + j);\n    solve_rows<SCHED>("),
    ("        signal_wait(xready + j);\n",
     "        signal_wait(xready + j);\n        T(225 + j);\n"),
    ("    __syncthreads();\n    for (int m = 0; panel_of(me, m, C) < np; ++m) {",
     "    __syncthreads();\n    T(250);\n"
     "    for (int m = 0; panel_of(me, m, C) < np; ++m) {"),
    ("int j0, int h, int lane, int rq) {\n",
     "int j0, int h, int lane, int rq) {\n    const long long tc0 = clock64();\n"),
    ("        tile_pass<SCHED, 0, RB>(L, P, c, ti, j0, h, lane, rq);\n    }\n}",
     "        tile_pass<SCHED, 0, RB>(L, P, c, ti, j0, h, lane, rq);\n    }\n"
     "    CYC(RB == 1 ? 0 : 2, tc0);\n}"),
    ("    const int j0 = j * NB, R = j0 + lane;\n",
     "    const int j0 = j * NB, R = j0 + lane;\n"
     "    const long long tc0 = clock64();\n"),
    ("    y[R] = t;\n}\n", "    y[R] = t;\n    CYC(4, tc0);\n}\n"),
    ("    const int j0 = j * NB;\n    for (int R = j0 + NB + tid;",
     "    const int j0 = j * NB;\n    const long long tc0 = clock64();\n"
     "    for (int R = j0 + NB + tid;"),
    ("        if (ynext) ynext[R] = yr;\n    }\n}",
     "        if (ynext) ynext[R] = yr;\n    }\n    CYC(6, tc0);\n}"),
    ("    const int j0 = j * NB;\n    const float rj = rinv[j0 + lane];",
     "    const int j0 = j * NB;\n    const long long tc0 = clock64();\n"
     "    const float rj = rinv[j0 + lane];"),
    ("    y[j0 + lane] = t;\n}", "    y[j0 + lane] = t;\n    CYC(8, tc0);\n}"),
]

_READERS = """
extern "C" int trace_read(unsigned long long* buf, unsigned long long* cyc) {
    cudaError_t e = cudaMemcpyFromSymbol(buf, clu::trace_buf,
                                         sizeof(unsigned long long) * 4096);
    if (e == cudaSuccess)
        e = cudaMemcpyFromSymbol(cyc, clu::trace_cyc,
                                 sizeof(unsigned long long) * 256);
    return (int)e;
}
extern "C" int trace_clear(void) {
    static unsigned long long z[4096];
    cudaError_t e = cudaMemcpyToSymbol(clu::trace_buf, z, sizeof(z));
    if (e == cudaSuccess)
        e = cudaMemcpyToSymbol(clu::trace_cyc, z,
                               sizeof(unsigned long long) * 256);
    return (int)e;
}
"""


def instrumented(header: str) -> str:
    """The header with the hooks at their places (raises naming a place the
    header no longer has)."""
    for place, hooked in _PLACES:
        if header.count(place) != 1:
            raise RuntimeError(f"the header has {header.count(place)} of "
                               f"{place!r}, not one")
        header = header.replace(place, hooked)
    return header


def build_library(out_dir: Path):
    from recommendation_models_tpu_torch.ops import build
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = build.CSRC
    (out_dir / "cholesky_common.cuh").write_text(
        (csrc / "cholesky_common.cuh").read_text())
    (out_dir / "cholesky_cluster.cuh").write_text(
        instrumented((csrc / "cholesky_cluster.cuh").read_text()))
    (out_dir / "cholesky_large.cu").write_text(
        (csrc / "cholesky_large.cu").read_text() + _READERS)
    lib = out_dir / "libcluster_trace.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(out_dir / "cholesky_large.cu")], check=True)
    return ctypes.CDLL(str(lib))


def trace(lib, k: int, b: int, c: int):
    """One traced launch at (k, B, C): the module docstring's line."""
    from recommendation_models_tpu_torch.probes.solve_latency import (
        random_systems)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cholesky_solve_large.argtypes = [P, P, P, P, P, I, I, I, I, P]
    dev = torch.device("cuda")
    kq, np_ = -(-k // 32) * 32, -(-k // 32)
    gen = torch.Generator(device=dev).manual_seed(0)
    G, rhs, reg = random_systems(b, k, 3 * k // 4, gen, dev)
    out = torch.empty(b, k, device=dev)
    for _ in range(3):
        lib.trace_clear()
        err = lib.cholesky_solve_large(G.data_ptr(), None, rhs.data_ptr(),
                                       reg.data_ptr(), out.data_ptr(), b, k,
                                       kq, c, None)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    A = (G + reg[:, None, None] * torch.eye(k, device=dev)).double()
    ref = torch.linalg.solve(A, rhs.double()[:, :, None])[:, :, 0]
    buf = (ctypes.c_ulonglong * (TRACED * SLOTS))()
    cyc = (ctypes.c_ulonglong * (TRACED * 16))()
    lib.trace_read(buf, cyc)
    ctas = min(c, TRACED)
    rows = [[buf[x * SLOTS + s] for s in range(SLOTS)] for x in range(ctas)]
    t0 = min(r[0] for r in rows if r[0])

    def us(r, s):
        return (r[s] - t0) / 1e3 if r[s] else None

    steps = []
    for j in range(np_ - 1):
        # the owner of panel j + 1 is the CTA whose step j recorded the
        # lookahead's publication
        owner = next((r for r in rows if r[STEP + 6 * j + 2]), None)
        if owner is None:
            continue
        start, copied, published = (us(owner, STEP + 6 * j + i)
                                    for i in range(3))
        tile, diag, rows_start = (us(owner, s + j + 1)
                                  for s in (TILE, DIAG, ROWS))
        steps.append(dict(step=j, wait_copy_us=copied - start,
                          diagonal_tile_us=tile - copied,
                          diagonal_factor_us=diag - tile,
                          rows_us=published - rows_start))
    loaded = max(us(r, 1) for r in rows)
    back_start = max(us(r, BACK + np_ - 1) or 0.0 for r in rows)
    end = max(us(r, END) for r in rows)
    names = ("diagonal_quarter", "tile", "diagonal_factor", "rows_per_warp",
             "back_block")
    per_call = {}
    for i, name in enumerate(names):
        n = sum(cyc[x * 16 + 2 * i + 1] for x in range(ctas))
        per_call[name] = (sum(cyc[x * 16 + 2 * i] for x in range(ctas)) / n
                          if n else None)
    r0 = rows[0]
    return dict(k=k, batch=b, cluster=c, load_us=loaded,
                forward_us=back_start - loaded if back_start else None,
                back_us=end - back_start if back_start else None,
                total_us=end, steps=steps, cycles_per_call=per_call,
                clock_ghz=(r0[252] - r0[251]) / max(r0[END] - r0[0], 1),
                max_abs_err=float((out.double() - ref).abs().max()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="656:1:8,168:120:1,168:1:6,512:8:8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cluster_trace: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"# {torch.cuda.get_device_name(0)} torch {torch.__version__}",
          flush=True)
    out_dir = Path(__file__).resolve().parents[2] / "build" / "cluster_trace"
    lib = build_library(out_dir)
    for shape in args.shapes.split(","):
        k, b, c = (int(v) for v in shape.split(":"))
        print(json.dumps(trace(lib, k, b, c)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
