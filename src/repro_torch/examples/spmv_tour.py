"""Storage-format tour: how each paper format encodes the SAME 8x8 matrix,
printed for inspection (the didactic companion to ``quickstart``).

Run:  PYTHONPATH=src python -m repro_torch.examples.spmv_tour --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (convert, coo_to_bicrs, coo_to_csr,
                              coo_to_icrs, curve_key, resolve_device, spmv,
                              spmv_dense_oracle, to_coo)

# the 8x8 example matrix
ROWS = [0, 0, 1, 2, 3, 3, 4, 5, 6, 7, 7]
COLS = [1, 7, 2, 0, 3, 4, 6, 5, 2, 0, 7]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    vals = np.arange(1, len(ROWS) + 1, dtype=np.float32)
    coo = to_coo(ROWS, COLS, vals, (8, 8), device=dev)
    print("dense:\n", coo.todense().cpu().numpy().astype(int))

    csr = coo_to_csr(coo)
    print("\nCSR  row_ptr:", csr.row_ptr.tolist())
    print("CSR  col_ind:", csr.col_ind.tolist())

    icrs = coo_to_icrs(coo)
    print("\nICRS col_start:", icrs.col_start,
          "col_inc:", icrs.col_inc.tolist())
    print("ICRS row_jump:", icrs.row_jump.tolist(),
          " (overflow past n=8 signals a row change)")

    bic = coo_to_bicrs(coo, order="hilbert")
    print("\nBICRS (Hilbert order) col_inc:", bic.col_inc.tolist())
    print("BICRS row_jump:", bic.row_jump.tolist(),
          " (negative jumps = bidirectional)")

    hk = curve_key(torch.tensor(ROWS), torch.tensor(COLS), "hilbert", 3)
    order = torch.argsort(hk).tolist()
    print("\nHilbert visit order of the nonzeros:",
          [(ROWS[i], COLS[i]) for i in order])

    bs = convert(coo, "csb", beta=4)
    print(f"\nCSB: grid {bs.grid}, beta={bs.beta}, "
          f"{bs.num_blocks} non-empty blocks")
    print("  block coords:", list(zip(bs.block_rows.tolist(),
                                      bs.block_cols.tolist())))
    lr, lc = bs.local_rows_cols()
    print("  packed in-block (row,col):",
          list(zip(lr.tolist(), lc.tolist())))
    print("  storage bytes:", bs.storage_bytes(), "vs CSR:",
          csr.storage_bytes())

    x = torch.arange(1, 9, dtype=torch.float32, device=dev)
    want = spmv_dense_oracle(coo, x)
    for mat in (csr, icrs, bic, bs):
        if not torch.allclose(spmv(mat, x), want):
            raise AssertionError(f"{type(mat).__name__} multiply is off")
    print("\nspmv_tour OK")
    return {"icrs": icrs, "bicrs": bic, "csb": bs}


if __name__ == "__main__":
    main()
