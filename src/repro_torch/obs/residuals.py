"""The observed-vs-modeled residual ledger — closing the roofline loop.

Every selector decision is scored by the ``repro_torch.roofline`` traffic
model (``spmm_distributed_time``). The ledger checks that model against
measurement: each entry pairs one *measured* timing (a serve flush) with
the model's prediction for the same ``core.selector.DistributedChoice``
knobs and stores

    residual = observed_s / modeled_s

so ``residual == 1`` means the model nailed it, ``> 1`` means reality is
slower than the streaming-bytes story (launch overhead, gather on the
critical path, allocator noise), ``< 1`` means the model over-prices
(overlap the model does not credit). The paper's own min-of-550 timing
discipline (§5.2) exists because SpMV is memory-bound and measured time
routinely diverges from predicted bytes — the ledger makes that
divergence a first-class, queryable quantity.

Consumers:

* ``core.selector.select_distributed(feedback=ledger)`` rescales each
  grid candidate's modeled score by ``ledger.correction(**choice_labels
  (...))`` — the geometric mean of matching residuals — which the serve
  migration controller runs between flushes.
* The dumped ``residuals`` of the metrics document.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple


def choice_labels(schedule: Optional[str] = None,
                  num_chunks: Optional[int] = None,
                  mesh_shape: Optional[Tuple[int, int]] = None,
                  compact_x: Optional[bool] = None,
                  gather: Optional[str] = None,
                  **extra) -> Dict[str, str]:
    """Canonical label dict for a ``DistributedChoice``-shaped config, so
    the serve path (which *records*) and autotune (which *queries*) key
    residuals identically: ``schedule``, ``num_chunks``, ``mesh``
    (``"PdxPm"``), ``compact_x`` (``"on"``/``"off"``), ``gather``
    (``"upfront"``/``"overlap"``/``"fused"``), plus any extras (matrix
    name, k, backend)."""
    labels: Dict[str, str] = {}
    if schedule is not None:
        labels["schedule"] = str(schedule)
    if num_chunks is not None:
        labels["num_chunks"] = str(int(num_chunks))
    if mesh_shape is not None:
        labels["mesh"] = f"{int(mesh_shape[0])}x{int(mesh_shape[1])}"
    if compact_x is not None:
        labels["compact_x"] = "on" if compact_x else "off"
    if gather is not None:
        labels["gather"] = str(gather)
    for k, v in extra.items():
        labels[str(k)] = str(v)
    return labels


@dataclasses.dataclass(frozen=True)
class ResidualRecord:
    """One measured-vs-modeled pairing. ``residual`` is always exactly
    ``observed_s / modeled_s`` (asserted in the tests)."""
    name: str
    observed_s: float
    modeled_s: float
    residual: float
    labels: Tuple[Tuple[str, str], ...] = ()

    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)


class ResidualLedger:
    """Append-only store of :class:`ResidualRecord` with label-matched
    correction queries."""

    def __init__(self):
        self._records: List[ResidualRecord] = []

    def __len__(self) -> int:
        return len(self._records)

    def record(self, name: str, observed_s: float, modeled_s: float,
               **labels) -> ResidualRecord:
        """Pair one measurement with its model prediction. Both sides
        must be finite and > 0 — a zero or NaN on either side means the
        caller measured (or modeled) nothing, and storing it would poison
        every correction query downstream."""
        obs_s = float(observed_s)
        mod_s = float(modeled_s)
        if not (math.isfinite(obs_s) and obs_s > 0):
            raise ValueError(f"observed_s must be finite and > 0, got "
                             f"{observed_s!r}")
        if not (math.isfinite(mod_s) and mod_s > 0):
            raise ValueError(f"modeled_s must be finite and > 0, got "
                             f"{modeled_s!r}")
        rec = ResidualRecord(
            name, obs_s, mod_s, obs_s / mod_s,
            tuple(sorted((str(k), str(v)) for k, v in labels.items())))
        self._records.append(rec)
        return rec

    def records(self) -> List[ResidualRecord]:
        return list(self._records)

    def _matching(self, query: Dict[str, str]) -> List[ResidualRecord]:
        out = []
        for rec in self._records:
            lab = rec.label_dict()
            if all(lab.get(k, v) == v for k, v in query.items()):
                out.append(rec)
        return out

    def correction(self, default: float = 1.0, **labels) -> float:
        """Geometric-mean residual over records matching ``labels``.

        A record matches when every queried key it *carries* agrees;
        keys the record never stored are wildcards (a record labelled
        only ``schedule=merge`` corrects every merge candidate). With no
        matching record the query returns ``default`` — no evidence, no
        correction. The geometric mean is the right average for a
        multiplicative correction factor: corrections of 2x and 0.5x
        cancel to exactly 1."""
        query = {str(k): str(v) for k, v in labels.items()}
        matches = self._matching(query)
        if not matches:
            return float(default)
        log_sum = sum(math.log(r.residual) for r in matches)
        return math.exp(log_sum / len(matches))

    def as_dicts(self) -> List[dict]:
        return [{"name": r.name, "observed_s": r.observed_s,
                 "modeled_s": r.modeled_s, "residual": r.residual,
                 "labels": r.label_dict()} for r in self._records]
