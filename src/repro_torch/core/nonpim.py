"""Non-PIM scenario model (paper Fig 9 / Table IV).
(PyTorch port of ``repro/core/nonpim.py``: plain Python floats, the same
expressions in the same order, no tensors.)

The paper runs gem5 (X86 OoO, DDR4) with three bulk-copy backends — memcpy
(1366.25 ns), LISA (260.5 ns), Shared-PIM (158.25 ns; the full unstaged
row->shared->bus->shared->row path, Table IV) — and reports IPC normalized
to memcpy.  Without gem5 we reproduce the figure with the
standard analytic IPC decomposition:

    T(app, mode) = T_core(app) + n_copies(app) * t_copy(mode)
    IPC_norm(app, mode) = T(app, memcpy) / T(app, mode)

where ``copy_fraction`` is the share of memcpy-backend runtime spent in bulk
row copies (app-dependent; bootup is the most copy-heavy, SPEC compute-bound
— matching the paper's qualitative ranking).  The validated claims are
structural: Shared-PIM >= LISA >= memcpy = 1.0 for every app, with the
largest benefit for copy-heavy workloads and no regressions anywhere.
"""

from __future__ import annotations

from repro_torch.core import copy_models

T_MEMCPY = copy_models.memcpy_copy().latency_ns                      # 1366.25
T_LISA = copy_models.lisa_copy(distance=1).latency_ns                # 260.5
T_SHAREDPIM = copy_models.sharedpim_copy(staged=False,
                                         restore=False).latency_ns   # 158.25

#: share of (memcpy-backend) runtime spent in bulk page/row copies
COPY_FRACTION = {
    "ntt": 0.18,
    "bfs": 0.22,
    "dfs": 0.22,
    "pmm": 0.25,
    "mm": 0.28,
    "spec2006": 0.06,
    "forkbench": 0.35,
    "bootup": 0.55,
}


def normalized_ipc(app: str, mode: str) -> float:
    f = COPY_FRACTION[app]
    t_copy = {"memcpy": T_MEMCPY, "lisa": T_LISA,
              "shared_pim": T_SHAREDPIM}[mode]
    # runtime with memcpy normalized to 1.0; copies scale by latency ratio
    t = (1.0 - f) + f * (t_copy / T_MEMCPY)
    return 1.0 / t


def fig9_table() -> dict[str, dict[str, float]]:
    return {app: {m: normalized_ipc(app, m)
                  for m in ("memcpy", "lisa", "shared_pim")}
            for app in COPY_FRACTION}
