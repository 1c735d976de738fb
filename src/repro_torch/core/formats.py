"""Flat sparse storage formats as dataclasses of tensors (paper §2).

``COO``  triplet format (rows, cols, data)
``CSR``  compressed row storage (row_ptr, col_ind, data)

Each object lives on one device (its tensors' device). Conversions run on
the host, so each object may also keep the numpy arrays it was built from
(``host``): later host-side planning (the merge plan, the SELL-C-σ sort)
reads those instead of copying the tensors back from the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def host_arrays(t: torch.Tensor) -> np.ndarray:
    """numpy view of a tensor (a device-to-host copy off the CPU)."""
    return t.detach().cpu().numpy()


@dataclasses.dataclass(eq=False)
class COO:
    rows: torch.Tensor          # int32[nnz]
    cols: torch.Tensor          # int32[nnz]
    data: torch.Tensor          # float[nnz]
    shape: Tuple[int, int]
    host: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = \
        dataclasses.field(default=None, repr=False)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def host_triplets(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, data) as numpy, from the kept host copy if any."""
        if self.host is not None:
            return self.host
        return (host_arrays(self.rows), host_arrays(self.cols),
                host_arrays(self.data))

    def storage_bytes(self) -> int:
        return self.nnz * (4 + 4 + self.data.element_size())

    def todense(self) -> torch.Tensor:
        m, n = self.shape
        out = torch.zeros((m, n), dtype=self.data.dtype, device=self.device)
        return out.index_put_((self.rows.long(), self.cols.long()),
                              self.data, accumulate=True)


@dataclasses.dataclass(eq=False)
class CSR:
    row_ptr: torch.Tensor       # int32[m+1]
    col_ind: torch.Tensor       # int32[nnz]
    data: torch.Tensor          # float[nnz]
    shape: Tuple[int, int]
    host: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = \
        dataclasses.field(default=None, repr=False)
    # merge plans built from ``host`` once per span count and reused by
    # every multiply (kernels.merge_spmv.cached_merge_plan)
    plans: Dict[int, object] = dataclasses.field(default_factory=dict,
                                                 repr=False)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def host_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(row_ptr, col_ind, data) as numpy, from the kept host copy if
        any."""
        if self.host is not None:
            return self.host
        return (host_arrays(self.row_ptr), host_arrays(self.col_ind),
                host_arrays(self.data))

    def storage_bytes(self) -> int:
        return (self.row_ptr.shape[0] + self.col_ind.shape[0]) * 4 \
            + self.nnz * self.data.element_size()

    def row_of_nnz(self) -> torch.Tensor:
        """int32[nnz] row index of each stored element (decompression)."""
        k = torch.arange(self.nnz, dtype=torch.int32, device=self.device)
        return (torch.searchsorted(self.row_ptr, k, right=True) - 1
                ).to(torch.int32)
