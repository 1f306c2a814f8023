"""Area model (paper Table III): base DRAM vs pLUTo-BSA vs pLUTo+Shared-PIM.
(PyTorch port of ``repro/core/area.py``: plain Python floats, the same
expressions in the same order, no tensors.)

Component areas in mm^2, reproduced from the paper's breakdown, which itself
derives from pLUTo's published DRAM area decomposition plus the Shared-PIM
additions (GWL transistors/drivers, BK-bus metal, BK-SAs, shared-row
decoder).  The module computes totals and the overhead percentage so that
the +7.16%-vs-pLUTo claim is an output, not an input.
"""

from __future__ import annotations

# component -> (base DRAM, pLUTo-BSA, pLUTo+Shared-PIM); None = absent
TABLE_III: dict[str, tuple[float | None, float | None, float | None]] = {
    "DRAM cell":              (45.23, 45.23, 45.29),  # +GWL transistors
    "Local WL driver":        (12.45, 12.45, 12.45),
    "Match logic":            (None,  4.61,  4.61),
    "Match lines":            (None,  0.02,  0.02),
    "Sense amp":              (11.40, 18.23, 18.23),
    "Row decoder":            (0.16,  0.47,  0.47),
    "Column decoder":         (0.01,  0.01,  0.01),
    "GWL driver":             (None,  None,  0.05),
    "BK-bus lines":           (None,  None,  0.04),
    "BK-SAs":                 (None,  None,  5.70),
    "Shared-PIM Row decoder": (None,  None,  0.01),
    "Other":                  (0.99,  0.99,  0.99),
}


def total(column: int) -> float:
    """Total area of design column 0=base, 1=pLUTo-BSA, 2=pLUTo+Shared-PIM."""
    return round(sum(v[column] for v in TABLE_III.values()
                     if v[column] is not None), 2)


def sharedpim_overhead_pct() -> float:
    """Shared-PIM area overhead relative to the pLUTo baseline (paper: 7.16%)."""
    return round(100.0 * (total(2) - total(1)) / total(1), 2)
