"""Reduce a ``torch.profiler`` trace of the traced window to what the
per-layer readers take: device seconds by kernel name, the device's busy
time (the union of kernel intervals) in the window, and the breakdown the
result line carries (the ten device operations that took most time, the
ten longest idle gaps named by what the host was doing).

Kernel kinds go by name: the port's own kernels by their ``__global__``
names in ``src/repro_torch/kernels/csrc``, cuBLAS's GEMMs by its naming,
and everything else is eager work (elementwise, reductions, copies).
"""

from __future__ import annotations

import dataclasses

WINDOW_SPAN = "bench.traced_window"

KINDS = {
    "flash_fwd": ("fa_fwd",),
    "flash_bwd": ("dkdv_", "dq_bf16", "dq_f32", "delta_kernel"),
    "mamba2_scan_fwd": ("mamba2_chunked_kernel",),
    "mamba2_scan_other": ("mamba2_direct_kernel", "mamba2_staged_kernel"),
    "mamba2_scan_bwd": ("mamba2_bwd",),
    "port_other": ("selective_", "mamba_scan_kernel", "grouped_mm", "lut_"),
    "gemm": ("nvjet", "gemm", "xmma", "cutlass", "splitK", "cublas"),
}


def kind_of(name: str) -> str:
    for kind, keys in KINDS.items():
        if any(k in name for k in keys):
            return kind
    return "eager"


@dataclasses.dataclass
class Trace:
    kernels: list[tuple[str, float, float]]     # (name, start, end), seconds
    host: list[tuple[str, float, float]]        # CPU-side ops and spans
    window: tuple[float, float]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def seconds(self, kind: str) -> float:
        """Device seconds of the window's kernels of one kind."""
        return sum(e - s for n, s, e in self.kernels if kind_of(n) == kind)

    def busy_intervals(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, self.window[0]), min(e, self.window[1])
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for n, s, e in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] \
            + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n[:160], t] for n, t in ops],
                "idle_gaps": [[self.host_at((a + b) / 2), b - a]
                              for a, b in gaps]}

    def host_at(self, t: float) -> str:
        """What the host was doing at time ``t``: the innermost op running
        then, or, between ops (Python), the op it started next (CUDA
        runtime calls and the profiler's own events are not ops)."""
        inner, after = None, None
        for n, s, e in self.host:
            if n == WINDOW_SPAN or n.startswith(("cuda", "Activity")):
                continue
            if s <= t <= e and (inner is None or e - s < inner[2] - inner[1]):
                inner = (n, s, e)
            if s > t and (after is None or s < after[1]):
                after = (n, s, e)
        if inner is not None:
            return inner[0][:160]
        return "host python before " + (after[0][:140] if after else "end")


def from_profiler(prof) -> Trace:
    """The traced window (the ``WINDOW_SPAN`` span) of a finished
    ``torch.profiler.profile``."""
    kernels, host, window = [], [], None
    for ev in prof.events():
        s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if str(ev.device_type).endswith("CUDA"):
            # a span's mirror on the device's timeline is no device work
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name == WINDOW_SPAN):
                kernels.append((ev.name, s, e))
        else:
            host.append((ev.name, s, e))
            if ev.name == WINDOW_SPAN:
                window = (s, e)
    if window is None:
        raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
    kernels = [k for k in kernels if k[2] > window[0] and k[1] < window[1]]
    return Trace(kernels, host, window)
