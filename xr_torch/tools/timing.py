"""Device time of a short call, read at the device's pace.

A gather kernel lasts 0.01-0.05 ms, about what its wrapper costs the host
(checks, ``torch.empty``, a ctypes call). Events around calls that the host
enqueues one by one then hold the host's time: the start event fires before
the kernel is queued. ``device_ms`` first lets the device spin
(``torch.cuda._sleep``), enqueues every repetition behind the spin, and
checks that the spin was still running when the last one was queued, so the
time between the events is the device's own.
"""

from __future__ import annotations

import torch

SPIN_CYCLES = 40_000_000  # ~20 ms of an H100's SM clock
FLUSH_WORDS = 32 << 20  # 128 MB of int32: larger than the 50 MB L2


def flush_buffer(device) -> torch.Tensor:
    """A buffer whose rewrite evicts the L2 (pass it as ``flush``)."""
    return torch.empty(FLUSH_WORDS, dtype=torch.int32, device=device)


def device_ms(fn, reps: int = 50, warmup: int = 1, flush: torch.Tensor | None = None,
              spin_cycles: int = SPIN_CYCLES) -> tuple[float, int]:
    """(mean device time of fn() in ms, repetitions it was taken over).

    With ``flush`` the L2 is cold: the buffer is rewritten before each call
    and events bracket each call alone. Without it the L2 is warm: two
    events bracket all repetitions, queued back to back. Either way the
    repetitions are queued behind ``spin_cycles`` of spinning on the device;
    if the host was still enqueuing when the spin ended, the count is halved
    and the measurement repeated (an error below 4)."""
    for _ in range(warmup):
        fn()
    while True:
        n = reps if flush is not None else 1
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(n)]
        gate = torch.cuda.Event()
        torch.cuda.synchronize()
        torch.cuda._sleep(spin_cycles)
        gate.record()
        if flush is not None:
            for start, end in events:
                flush.zero_()
                start.record()
                fn()
                end.record()
        else:
            start, end = events[0]
            start.record()
            for _ in range(reps):
                fn()
            end.record()
        queued_ahead = not gate.query()  # the spin outlasted the host's enqueuing
        torch.cuda.synchronize()
        if queued_ahead:
            total = sum(s.elapsed_time(e) for s, e in events)
            return total / reps, reps
        if reps < 8:
            raise RuntimeError("device_ms: the host cannot queue 4 calls inside the spin")
        reps //= 2
