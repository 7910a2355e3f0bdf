"""solve_roofline.train: the least time of every real system's solve in a
sweep (``run.work["solve"]``) over the device time of the solve kernels
in a traced sweep, in %. Solve kernels are known by name
(``solve_kernel``, copied from the port's ``probes/epoch_profile.py``)."""

import re

from benchmark import trace, work


def solve_kernel(name: str):
    """The regime solve a device kernel's name belongs to, or None:
    ``chol_solve_kernel<NTH, NT, HOT, TWO_G, ...>`` of csrc/cholesky_solve.cu
    by its flags, and ``rank_panel_kernel<NTH, NT, NQ, SCHED, SROWS, FUSE>``
    of csrc/cholesky_rank_panel.cu by FUSE (0: B1's panel frame; 1: B3; 2:
    B2)."""
    m = re.search(r"chol_solve_kernel<([^>]*)", name)
    if m:
        args = [a.strip() for a in m.group(1).split(",")]
        return ("cholesky_solve_hot" if args[2] == "true"
                else "cholesky_solve_2g" if args[3] == "true"
                else "cholesky_solve_batched")
    m = re.search(r"rank_panel_kernel<([^>]*)>", name)
    if m:
        args = [a.strip() for a in m.group(1).split(",")]
        fuse = args[5] if len(args) > 5 else "0"
        return {"0": "cholesky_solve_batched", "1": "cholesky_solve_2g",
                "2": "cholesky_solve_hot"}[fuse]
    return None


def read(run):
    cap = run.capture
    need = run.work.get("solve")
    if cap is None or need is None or not run.traced_units:
        return None
    ns = sum(e - s for name, s, e, _ in
             trace.ops_in(cap, trace.call_windows(cap))
             if solve_kernel(name))
    if ns <= 0:
        return None
    return work.roofline_share(*need, ns / 1e9 / run.traced_units)
