"""What repro_torch's profile tools count as device time, in one place.

Used by ``tools/torch_port_profile.py`` (a GRLE slot) and
``tools/torch_lm_profile.py`` (LM prefill and decode). A kernel is a CUDA
event of ``torch.profiler`` with device time; ``record_function`` spans,
which also appear on the device under the span's name, are left out by
name. The busy share is kernel time over the host's wall time of the
profiled calls, which ends in a synchronize and includes the profiler's
own overhead.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    from repro_torch.obs.log import card_line
    return card_line()


def device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


# torch.profiler (torch 2.11, CUDA 12.8, H100) can lose the device records
# of the last milliseconds of work in its window, even after a synchronize
# (tools/torch_profiler_window.py); the window stays open this long after.
TAIL_S = 0.2


def profiled(fn, n_calls: int = 1):
    """Run ``fn`` ``n_calls`` times under the profiler, whose window stays
    open ``TAIL_S`` after them -> (profile, wall seconds of the calls)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(TAIL_S)
    return prof, wall


def device_summary(prof, wall: float, n: int, per: str, ours,
                   spans=(), top: int = 6) -> dict:
    """Kernel time, busy share and launches of a profiled window, divided
    over its ``n`` units (slots, calls) named ``per``; ``ours`` are name
    fragments of the hand-written kernels, ``spans`` the
    ``record_function`` names to leave out."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda
               and device_us(e) > 0 and e.key not in spans]
    total = sum(device_us(e) for e in kernels)
    return {
        f"device_us_per_{per}": total / n,
        "device_busy_share": total / (wall * 1e6),
        f"kernel_launches_per_{per}": sum(e.count for e in kernels) / n,
        f"our_kernels_device_us_per_{per}": {
            k: sum(device_us(e) for e in kernels if k in e.key) / n
            for k in ours},
        f"top_kernels_device_us_per_{per}": {
            e.key[:60]: device_us(e) / n
            for e in sorted(kernels, key=device_us, reverse=True)[:top]},
    }
