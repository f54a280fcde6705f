"""The traced stretch: `torch.profiler` over a short steady part of a
window, reduced to the device's records (kernels, copies, sets), the
host's ops, and the program's launch counters over the same stretch.

The program's four kernels are known by name (K1 `mtsl_update`, K2
`flash_attention`, K3 `ssd_scan`, K4 `flash_decode`). Their records in
the trace are held against the launches the program counted over the
stretch (`repro_torch/kernels/counts.py`): the profiler has been seen to
lose records late in long runs, and a share read from a partial trace
would be wrong. A stretch whose records and counts differ is measured
again, and after `TRIES` such stretches the run fails.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Tuple

KERNELS = {"k1": "mtsl_update", "k2": "flash_attention", "k3": "ssd_scan",
           "k4": "flash_decode"}
TRIES = 3


class ProfilerLost(RuntimeError):
    pass


class Trace(NamedTuple):
    device: List[Tuple[str, int, int]]  # (name, start ns, end ns): kernels, copies, sets
    kernels: List[Tuple[str, int, int]]  # the kernels alone
    host: List[Tuple[str, int, int]]  # the main thread's ops
    counted: Dict[str, int]  # K1..K4 launches the program counted
    wall_s: float  # the stretch on the host's clock

    def records(self, key: str) -> List[Tuple[str, int, int]]:
        """Kernel records of one of the program's kernels ("k1".."k4")."""
        return [k for k in self.kernels if KERNELS[key] in k[0]]

    def kernel_s(self, key: str, name_part: str = "") -> float:
        return sum(e - s for n, s, e in self.records(key) if name_part in n) * 1e-9

    @property
    def window_s(self) -> float:
        """From the first device record's start to the last one's end."""
        if not self.device:
            return 0.0
        return (max(e for _, _, e in self.device) - min(s for _, s, _ in self.device)) * 1e-9

    @property
    def busy_s(self) -> float:
        """The union of the device records' intervals."""
        busy, end = 0, None
        for _, s, e in sorted(self.device, key=lambda r: r[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-9

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle intervals between the device records, longest first."""
        out, end = [], None
        for _, s, e in sorted(self.device, key=lambda r: r[1]):
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return sorted(out, key=lambda g: g[0] - g[1])


def _counters():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.mtsl_update.ops import mtsl_update_, mtsl_update_multi_
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    return {"k1": lambda: mtsl_update_multi_.launches + mtsl_update_.launches,
            "k2": lambda: flash_attention.launches,
            "k3": lambda: ssd_scan.counts.total(),
            "k4": lambda: flash_decode.counts.total()}


def _reduce(prof, wall_s: float, counted: Dict[str, int]) -> Trace:
    from torch.autograd import DeviceType

    device, kernels, host = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        rec = (ev.name(), ev.start_ns(), ev.end_ns())
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation():  # a host range drawn on the device's line
                continue
            device.append(rec)
            low = rec[0].lower()
            if not (low.startswith("memcpy") or low.startswith("memset")):
                kernels.append(rec)
        elif rec[2] > rec[1]:
            host.setdefault(ev.start_thread_id(), []).append(rec)
    # the thread that issued the most ops is the one driving the device
    main = max(host.values(), key=len) if host else []
    return Trace(device, kernels, main, counted, wall_s)


def stretch(torch, fn: Callable[[], object]) -> Tuple[Trace, object]:
    """Run fn() under the profiler and return (the reduced trace, fn's
    result), checking the kernel records against the launch counters."""
    from torch.profiler import ProfilerActivity, profile

    counters = _counters()
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(TRIES):
        sync()
        before = {k: c() for k, c in counters.items()}
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            sync()
            wall = time.perf_counter() - t0
        counted = {k: c() - before[k] for k, c in counters.items()}
        tr = _reduce(prof, wall, counted)
        lost = {k: (len(tr.records(k)), n) for k, n in counted.items()
                if len(tr.records(k)) != n}
        if not lost and (tr.device or not cuda):
            return tr, out
    raise ProfilerLost(f"kernel records (seen, counted) differ in {TRIES} stretches: "
                       f"{lost}; device records {len(tr.device)}")


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    by the innermost op the main thread was in at the gap's middle."""
    by_name: Dict[str, int] = {}
    for n, s, e in tr.device:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    for a, b in tr.gaps()[:top]:
        mid = (a + b) // 2
        inside = [h for h in tr.host if h[1] <= mid <= h[2]]
        what = min(inside, key=lambda h: h[2] - h[1])[0] if inside else "(no host op)"
        gaps.append([what[:120], (b - a) * 1e-9])
    return {"device_ops": [[n[:120], t * 1e-9] for n, t in ops], "idle_gaps": gaps}
