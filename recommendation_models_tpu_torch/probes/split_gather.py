"""One gather-and-gram over the whole user table against the same work as a
masked gather over two table halves, and a gather from a small table.

    python -m recommendation_models_tpu_torch.probes.split_gather \
        [--dtype bfloat16|float32] [--platform cpu]

The port's counterpart of the JAX package's ``scripts/probe_split_gather.py``.
Its constants are the script's: a table of N = 162,541 rows (ML-25M's
users) of K = 64, NBLK = 6 row blocks of B = 14,592 rows (a real item-half
bucket's shape) and P = 56 ids each, uniform from ``default_rng(0)`` with
weights in [0, 1), REPS = 20 passes. Each block's gram is the script's
``gram_from``: the rows gathered from the table (in ``--dtype``), weighted
in f32, rounded back to the table's dtype, and multiplied with the
gathered rows with the products and sums in f32, as ``ops/gram.py``'s
``_accumulate`` computes them (TF32 off). A pass sums every block's gram.
Three lines, each ms a pass and M gathered rows/s, from CUDA events over
REPS passes after a warm pass (``probes.time_ms``):

- baseline: one gather from the whole table;
- split: two gathers a block from the halves (rows below ``half`` and the
  rest, ``half = (N // 2) // 8 * 8``), each masked, twice the slots;
- reference: the same slot count from the 62,423-row table (ML-25M's
  items), the ids taken modulo its size.

On the TPU the question was scoped VMEM; on the card it is the L2 (50 MB on
an H100 SXM; the probe prints the card's ``L2_cache_size``). The bf16 table
is 20.8 MB and fits already; the f32 table, 41.6 MB, is the one the port's
f32 path gathers, so ``--dtype float32`` runs the three lines on it. One
gathered block is 14,592 x 56 x 64 rows: 105 MB in bf16, 209 MB in f32.

With ``--platform cpu`` the three lines run once each, untimed, at a small
shape (``CPU_SHAPE``). Prints the script's three lines, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from recommendation_models_tpu_torch.probes import time_ms

N = 162_541            # user-table rows (ML-25M)
K = 64
B = 14_592             # rows per block (a real item-half bucket shape)
P = 56
NBLK = 6               # row blocks a pass
REPS = 20
SMALL = 62_423         # the item table's rows (ML-25M)
CPU_SHAPE = dict(n=2_000, b=256, nblk=2, small=1_500, reps=1)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def gram_from(tbl, idx_b, w_b):
    """(B, K, K) f32 gram of one block: ``Σ_p w g gᵀ`` with g the rows of
    ``tbl`` at ``idx_b`` (B, P), the weighted copy rounded to ``tbl``'s
    dtype as the script rounds it, products and sums in f32."""
    g = tbl.index_select(0, idx_b.reshape(-1)).view(*idx_b.shape, -1)
    gw = (g.float() * w_b[..., None]).to(tbl.dtype)
    return torch.bmm(gw.float().transpose(1, 2), g.float())


def split_gram(t1, t2, half: int, idx_b, w_b):
    """``gram_from`` of one block as the sum of two masked gathers: the ids
    below ``half`` from ``t1``, the rest from ``t2`` (offset by ``half``);
    each gather's other slots read row 0 with weight 0."""
    m1 = idx_b < half
    g1 = gram_from(t1, torch.where(m1, idx_b, 0), w_b * m1)
    g2 = gram_from(t2, torch.where(m1, 0, idx_b - half), w_b * ~m1)
    return g1 + g2


def inputs(n: int, nblk: int, b: int, p: int, k: int, dtype, device):
    """The script's table (N(0, 1), in ``dtype``), ids and weights from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    V = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, size=(nblk, b, p)))
    w = torch.from_numpy(rng.random((nblk, b, p)).astype(np.float32))
    return V.to(device=device, dtype=dtype), idx.to(device), w.to(device)


def _pass(fn, idx, w):
    """One pass: the sum over the blocks of ``fn(idx_b, w_b).sum()``."""
    acc = torch.zeros((), dtype=torch.float32, device=idx.device)
    for i in range(idx.shape[0]):
        acc = acc + fn(idx[i], w[i]).sum()
    return acc


def run(dtype: str = "bfloat16", device=None, n: int = N, b: int = B,
        p: int = P, nblk: int = NBLK, small: int = SMALL, reps: int = REPS,
        k: int = K) -> dict:
    """The script's three lines; returns the record (ms a pass and M rows/s
    per line on the card, None on the host, and each line's sum)."""
    from recommendation_models_tpu_torch.device import resolve_device
    from recommendation_models_tpu_torch.ops.gram import full_f32
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        full_f32()
    dt = DTYPES[dtype]
    V, idx, w = inputs(n, nblk, b, p, k, dt, dev)
    half = (n // 2) // 8 * 8
    rows = nblk * b * p
    itemsize = torch.finfo(dt).bits // 8
    rec = {"dtype": dtype, "n": n, "k": k, "b": b, "p": p, "nblk": nblk,
           "reps": reps, "half": half, "rows_per_pass": rows,
           "table_mb": n * k * itemsize / 1e6,
           "half_table_mb": half * k * itemsize / 1e6,
           "small_table_mb": small * k * itemsize / 1e6,
           "block_mb": b * p * k * itemsize / 1e6,
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "l2_mb": (torch.cuda.get_device_properties(dev).L2_cache_size
                     / 1e6 if on_card else None)}
    if on_card:
        print(f"# {rec['device']}: L2 {rec['l2_mb']:.1f} MB; {dtype} table "
              f"{rec['table_mb']:.1f} MB, halves {rec['half_table_mb']:.1f} "
              f"MB, small table {rec['small_table_mb']:.1f} MB, one "
              f"gathered block {rec['block_mb']:.0f} MB", flush=True)
    V1, V2 = V[:half], V[half:]
    Vs = V[:small]
    idx_s = idx % small
    lines = (
        ("baseline", f"baseline  1x{n} table :",
         lambda i, ww: gram_from(V, i, ww), idx, ""),
        ("split", f"split     2x{half} tables:",
         lambda i, ww: split_gram(V1, V2, half, i, ww), idx,
         " (2x slots gathered)"),
        ("reference", f"reference 1x{small} table:",
         lambda i, ww: gram_from(Vs, i, ww), idx_s, ""))
    for key, label, fn, ids, note in lines:
        total = float(_pass(fn, ids, w))              # also the warm pass
        ms = time_ms(lambda: _pass(fn, ids, w), reps) if on_card else None
        rate = None if ms is None else rows / (ms / 1e3) / 1e6
        rec[key] = {"ms_per_pass": ms, "m_rows_per_s": rate, "sum": total}
        if ms is None:
            print(f"{label} (cpu, untimed){note}", flush=True)
        else:
            print(f"{label} {ms:7.3f} ms/pass  {rate:7.1f}M rows/s{note}",
                  flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the host; default: the CUDA card")
    args = ap.parse_args(argv)
    shape = CPU_SHAPE if args.platform == "cpu" else {}
    rec = run(args.dtype, args.platform, **shape)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
