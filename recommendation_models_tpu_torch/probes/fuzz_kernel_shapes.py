"""Kernel shape fuzz on the card: random (k, b) batched solves through
``ops.solve.solve_spd_t`` on the CUDA kernels, against the torch anchor
(``solver="xla"``) on the same device.

    python -m recommendation_models_tpu_torch.probes.fuzz_kernel_shapes \
        [n_trials] [seed]

The port's counterpart of ``scripts/fuzz_kernel_shapes.py``, with its draws
from ``np.random.default_rng(seed)`` in its order (``trials``): k = 8 x
[1, 32], b in [1, 600), two grams with probability 0.3, the ridge in [0.05,
1), then the systems' factors, the rhs and the second gram's factors. The
same (n_trials, seed) gives the same trials; the defaults are 25 and 0.
Each trial's grams, ``A Aᵀ + 0.1 I`` (and ``B Bᵀ``) of the drawn factors
(which carry the script's 1/√k), are formed on the card. A trial passes
when the kernel's x is finite and max|x - ref| / max(max|ref|, 1) <
5e-3, and when the launch counts moved as the port's copy of
``pallas_supported`` (``ops.cholesky.kernel_supported``) says:
one launch of the kernel it takes (B1 or B3 at k <= 160, the one-block
kernel past it) and nothing routed, or, where the reference goes to XLA,
one routed call and no launch. Prints a line a trial, then
``KERNEL SHAPE FUZZ PASS`` and one JSON line (the trials, the card); exits
1 at the first failure. ``chip_smoke.py`` phase 13 runs it with these
functions. The probe runs only on a CUDA card.
"""

from __future__ import annotations

import json
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

N_TRIALS, SEED = 25, 0
TOL = 5e-3


class Trial(NamedTuple):
    """One trial's draws: its index, order, batch, two-gram flag, ridge,
    the (b, k, k) factors of G, rhs (b, k) and the factors of G2 (or
    None)."""
    t: int
    k: int
    b: int
    two_op: bool
    reg: float
    A: np.ndarray
    rhs: np.ndarray
    B2: Optional[np.ndarray]


def trials(n_trials: int = N_TRIALS, seed: int = SEED):
    """The trials' draws, in ``scripts/fuzz_kernel_shapes.py``'s order."""
    rng = np.random.default_rng(seed)
    for t in range(n_trials):
        k = int(rng.integers(1, 33)) * 8          # 8..256
        b = int(rng.integers(1, 600))
        two_op = bool(rng.random() < 0.3)
        reg = float(rng.uniform(0.05, 1.0))
        A = rng.standard_normal((b, k, k)).astype(np.float32) / np.sqrt(k)
        rhs = rng.standard_normal((b, k)).astype(np.float32)
        B2 = None
        if two_op:
            B2 = rng.standard_normal((b, k, k)).astype(np.float32) \
                / np.sqrt(k)
        yield Trial(t, k, b, two_op, reg, A, rhs, B2)


def grams(trial: Trial, device) -> tuple:
    """(Gt, Gt2 or None) of a trial, batch-minor (k, k, b) f32: the
    script's ``A Aᵀ + 0.1 I`` and ``B Bᵀ``, formed on ``device`` in the
    factors' own precision and rounded to f32 once."""
    def gram(F):
        F = torch.from_numpy(F).to(device)
        return F @ F.transpose(1, 2)

    k = trial.k
    G = gram(trial.A) + 0.1 * torch.eye(k, dtype=torch.float32,
                                        device=device)
    Gt = G.float().permute(1, 2, 0)
    Gt2 = None if trial.B2 is None else gram(trial.B2).float().permute(
        1, 2, 0)
    return Gt, Gt2


def expected(trial: Trial):
    """(supported, the kernel a supported trial launches, the wrapper that
    counts a routed one) by the port's copy of ``pallas_supported``."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    supported = ch.kernel_supported(trial.k, trial.b, trial.two_op)
    entry = "cholesky_solve_2g" if trial.two_op else "cholesky_solve_batched"
    kernel = "cholesky_solve_large" if trial.k > ch.KMAX else entry
    return supported, kernel, entry


def _require(cond: bool, msg: str) -> None:
    # an explicit raise: the checks hold under ``python -O`` too
    if not cond:
        raise AssertionError(msg)


def run_trial(trial: Trial, device) -> dict:
    """One trial on the card; raises AssertionError if it fails."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.ops.solve import solve_spd_t
    Gt, Gt2 = grams(trial, device)
    rt = torch.from_numpy(trial.rhs.T.copy()).to(device)
    rv = torch.full((trial.b,), trial.reg, dtype=torch.float32,
                    device=device)
    supported, kernel, entry = expected(trial)
    tag = (f"trial {trial.t}: k={trial.k} b={trial.b} 2op={trial.two_op} "
           f"supported={supported}")
    ch.reset_counts()
    x = solve_spd_t(Gt, rt, "pallas", reg_vec=rv, Gt2=Gt2)
    launches, routed = dict(ch.LAUNCHES), dict(ch.ROUTED)
    ref = solve_spd_t(Gt, rt, "xla", reg_vec=rv, Gt2=Gt2)
    scale = max(float(ref.abs().max()), 1.0)
    err = float((x - ref).abs().max()) / scale
    moved = ({n: c for n, c in launches.items() if c},
             {n: c for n, c in routed.items() if c})
    want = ({kernel: 1}, {}) if supported else ({}, {entry: 1})
    _require(bool(torch.isfinite(x).all()), f"not finite\n{tag}")
    _require(err < TOL, f"diverged ({err:.2e})\n{tag}")
    _require(moved == want, f"counts {moved}, expected {want}\n{tag}")
    return {"t": trial.t, "k": trial.k, "b": trial.b,
            "two_op": trial.two_op, "supported": supported,
            "launched": moved[0], "routed": moved[1], "err": err,
            "tag": tag}


def run(n_trials: int = N_TRIALS, seed: int = SEED, device=None,
        log=print) -> list:
    """Every trial on ``device`` (the card by default), one line each."""
    device = device or torch.device("cuda")
    t0 = time.time()
    out = []
    for trial in trials(n_trials, seed):
        r = run_trial(trial, device)
        out.append(r)
        log(f"ok {r['tag']} err={r['err']:.1e} launched={r['launched']} "
            f"routed={r['routed']} [{time.time() - t0:.0f}s]")
    log(f"KERNEL SHAPE FUZZ PASS: {n_trials} trials, {time.time() - t0:.0f}s")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("fuzz_kernel_shapes: needs a CUDA card", file=sys.stderr)
        return 2
    n_trials = int(argv[0]) if argv else N_TRIALS
    seed = int(argv[1]) if len(argv) > 1 else SEED
    from recommendation_models_tpu_torch.ops.gram import full_f32
    full_f32()
    try:
        out = run(n_trials, seed, log=lambda m: print(m, flush=True))
    except AssertionError as exc:
        print(f"KERNEL SHAPE FUZZ FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"trials": [{k: v for k, v in r.items() if k != "tag"}
                                 for r in out],
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
