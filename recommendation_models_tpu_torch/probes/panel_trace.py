"""Where a system's time goes inside the panel frame of
``csrc/cholesky_rank_panel.cu`` (past kp = 128: B1's, B4's and B5c's
kernel with every term alone, B5a's, and B5b's in Schur's order).

    python -m recommendation_models_tpu_torch.probes.panel_trace \
        [--shapes 160:65536,160:1] [--kernels batched_panel,panel,schur]

Builds an instrumented copy of ``csrc/cholesky_rank_panel.cu`` under
``build/panel_trace/``: lane 0 of each warp of block 0 adds ``clock64``
cycles, by phase, into a device counter (a fire-and-forget atomic add, so
the warp does not wait for it). A factor warp's phases per system, summed
over its panels: ``publish`` (its tiles of the panel into the buffer),
``wait_publish`` (the panel's first barrier), ``diagonal`` (the 8 x 8
diagonal block in registers, for the warps with rows at or below the
panel), ``row`` (its rows solved against it, and the rest of the branch),
``wait_rows`` (the second barrier), ``update`` (the trailing update) and
``start`` (the next system's slot hand-over, its staged tiles' arrival and
its prefetch); the substitution warp's: ``wait_full`` (for the factor's
hand-over) and ``substitute`` (both substitutions). Then, for each shape
``k:B`` and kernel (``batched_panel``: B1's export past kp = 128, one-row
substitutions, every term alone; ``panel``: B5a; ``schur``: B5b with
two-row substitutions, k % 16 == 0), three launches on random systems
(``probes.solve_latency.random_systems``, seed 0), the last one traced,
and one JSON line: ``systems`` (block 0's), ``cycles_per_system`` (the
block's first to last cycle over its systems), ``clock_ghz`` (those
cycles over ``%globaltimer`` ns), ``factor_warps`` (cycles a system by
phase for each of the seven factor warps) and their ``mean``,
``substitution`` (the substitution warp's), and ``equal_to_untraced``
(whether the traced launch's solution equals the wrapper's bit for bit:
the instrumentation changes no arithmetic). The counters add their own
instructions, so the traced kernel runs a few percent slower than the
untraced one.

The instrumentation is inserted at fixed places of the source's text; a
source that no longer has one of them stops the probe with the place's
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

FACTOR_PHASES = ("publish", "wait_publish", "diagonal", "row", "wait_rows",
                 "update", "start")
SUBST_PHASES = ("wait_full", "substitute")
SLOTS = 96          # 8 warps x 8 counters, then the block's marks
MARKS = 88          # first / last clock64, first / last globaltimer

_HOOKS = """
__device__ unsigned long long ptrace[96];
__device__ __forceinline__ unsigned long long pt_ns() {
    unsigned long long t_;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_));
    return t_;
}
#define PT_ADD(ph, v) do { if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) \\
    atomicAdd(&ptrace[(threadIdx.x >> 5) * 8 + (ph)], \\
              (unsigned long long)(v)); } while (0)
#define PT(ph) do { const unsigned long long n_ = clock64(); \\
    PT_ADD(ph, n_ - pt_t); pt_t = n_; } while (0)
#define PT_MARK(slot) do { if (blockIdx.x == 0) { \\
    ptrace[88 + (slot)] = clock64(); ptrace[90 + (slot)] = pt_ns(); } \\
    } while (0)
"""

# (text in csrc/cholesky_rank_panel.cu, text with the hook)
_PLACES = [
    ("namespace {\n", "namespace {\n" + _HOOKS),
    ("    const int kp = o.kp, h = kp >> 1, ht = h >> 2;\n",
     "    const int kp = o.kp, h = kp >> 1, ht = h >> 2;\n"
     "    unsigned long long pt_t = clock64();\n"),
    ("        bar_sync(BAR_FACTOR, NTH);\n        if (tid >= j0 && tid < kp) {\n",
     "        PT(0);\n        bar_sync(BAR_FACTOR, NTH);\n        PT(1);\n"
     "        if (tid >= j0 && tid < kp) {\n"),
    ("            // this thread's row against D, in the same order: for a row",
     "            PT(2);\n"
     "            // this thread's row against D, in the same order: for a row"),
    ("        bar_sync(BAR_FACTOR, NTH);\n        // one rank-8 update",
     "        PT(3);\n        bar_sync(BAR_FACTOR, NTH);\n        PT(4);\n"
     "        // one rank-8 update"),
    ("                for (int c = 0; c < 4; ++c) s.a[n][r][c] -= acc[r][c];\n"
     "        }\n    }\n}\n",
     "                for (int c = 0; c < 4; ++c) s.a[n][r][c] -= acc[r][c];\n"
     "        }\n        PT(5);\n    }\n}\n"),
    ("            bar_sync(BAR_FULL + s, HAND);\n",
     "            unsigned long long sw_t = clock64();\n"
     "            bar_sync(BAR_FULL + s, HAND);\n"
     "            PT_ADD(0, clock64() - sw_t);\n"
     "            sw_t = clock64();\n"),
    ("            // the factor threads wait for the slot only if they use it",
     "            PT_ADD(1, clock64() - sw_t);\n            PT_ADD(7, 1);\n"
     "            // the factor threads wait for the slot only if they use it"),
    ("        return;\n    }\n\n    Tiles<NT> t[NS];",
     "        if (lane == 0) PT_MARK(1);\n        return;\n    }\n\n"
     "    Tiles<NT> t[NS];"),
    ("    __syncthreads();\n\n    if (tid >= NTH) {",
     "    __syncthreads();\n    if (tid == 0) PT_MARK(0);\n\n"
     "    if (tid >= NTH) {"),
    ("        if (it >= q.nslot) bar_sync(BAR_EMPTY + sl, HAND);\n",
     "        const unsigned long long ps_t = clock64();\n"
     "        if (it >= q.nslot) bar_sync(BAR_EMPTY + sl, HAND);\n"),
    ("        // a warp leaves the rank steps after its last step",
     "        PT_ADD(6, clock64() - ps_t);\n        PT_ADD(7, 1);\n"
     "        // a warp leaves the rank steps after its last step"),
]

_READERS = """
extern "C" int panel_trace_read(unsigned long long* buf) {
    return (int)cudaMemcpyFromSymbol(buf, ptrace,
                                     sizeof(unsigned long long) * 96);
}
extern "C" int panel_trace_clear(void) {
    static unsigned long long z[96];
    return (int)cudaMemcpyToSymbol(ptrace, z, sizeof(z));
}
"""

# kernel -> (C export, its extra int arguments, the public wrapper's call)
KERNELS = {
    "batched_panel": ("cholesky_solve_batched_panel", (),
                      lambda ch, G, r, g: ch.cholesky_solve_rank1(G, r, g, 1,
                                                                  1)),
    "panel": ("cholesky_solve_panel", (), lambda ch, G, r, g:
              ch.cholesky_solve_panel(G, r, g)),
    "schur": ("cholesky_solve_schur", (2,), lambda ch, G, r, g:
              ch.cholesky_solve_schur(G, r, g, 2)),
}


def instrumented(source: str) -> str:
    """The source with the hooks at their places and the trace's readers
    (raises naming a place the source does not have exactly once)."""
    for place, hooked in _PLACES:
        if source.count(place) != 1:
            raise RuntimeError(f"the source has {source.count(place)} of "
                               f"{place!r}, not one")
        source = source.replace(place, hooked)
    return source + _READERS


def build_library(out_dir: Path):
    from recommendation_models_tpu_torch.ops import build
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = build.CSRC
    (out_dir / "cholesky_common.cuh").write_text(
        (csrc / "cholesky_common.cuh").read_text())
    src = out_dir / "cholesky_rank_panel.cu"
    src.write_text(instrumented((csrc / "cholesky_rank_panel.cu").read_text()))
    lib = out_dir / "libpanel_trace.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True)
    return ctypes.CDLL(str(lib))


def per_system(buf, warp: int, phases, systems: int) -> dict:
    return {name: buf[warp * 8 + i] / max(systems, 1)
            for i, name in enumerate(phases)}


def trace(lib, name: str, k: int, b: int) -> dict:
    """One traced launch of ``name`` at (k, B): the module docstring's
    line."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes.solve_latency import (
        random_systems)
    export, ints, wrapper = KERNELS[name]
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, export)
    fn.argtypes = [P, P, P, P, I, I, *([I] * len(ints)), P]
    fn.restype = I
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    G, rhs, reg = random_systems(b, k, 48, gen, dev)
    out = torch.empty(b, k, device=dev)
    for _ in range(3):
        lib.panel_trace_clear()
        err = fn(G.data_ptr(), rhs.data_ptr(), reg.data_ptr(),
                 out.data_ptr(), b, k, *ints, None)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"{export} failed: CUDA error {err}")
    buf = (ctypes.c_ulonglong * SLOTS)()
    lib.panel_trace_read(buf)
    nth = 224 // 32
    systems = buf[0 * 8 + 7]
    warps = [per_system(buf, w, FACTOR_PHASES, systems) for w in range(nth)]
    mean = {p: sum(w[p] for w in warps) / nth for p in FACTOR_PHASES}
    cycles = buf[MARKS + 1] - buf[MARKS]
    ns = buf[MARKS + 3] - buf[MARKS + 2]
    return dict(kernel=name, k=k, batch=b, systems=systems,
                cycles_per_system=cycles / max(systems, 1),
                clock_ghz=cycles / max(ns, 1),
                factor_warps=warps, mean=mean,
                substitution=per_system(buf, nth, SUBST_PHASES,
                                        buf[nth * 8 + 7]),
                equal_to_untraced=bool(torch.equal(
                    out, wrapper(ch, G, rhs, reg))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="160:65536,160:1")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("panel_trace: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"# {torch.cuda.get_device_name(0)} torch {torch.__version__}",
          flush=True)
    out_dir = Path(__file__).resolve().parents[2] / "build" / "panel_trace"
    lib = build_library(out_dir)
    for shape in args.shapes.split(","):
        k, b = (int(v) for v in shape.split(":"))
        for name in args.kernels.split(","):
            if name == "schur" and k % 16:
                continue
            print(json.dumps(trace(lib, name, k, b)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
