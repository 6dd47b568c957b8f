"""Completion marks and device synchronisation, on the card or, for the
harness's own CPU tests, on the host.

On the card a mark is a CUDA event with timing, recorded on the current
stream after the work it marks; ``elapsed_ms`` is the device clock's
time between two marks.  On the CPU the work has finished when the call
returns, and a mark is the host clock's reading.
"""

from __future__ import annotations

import time

import torch


class Mark:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.event = torch.cuda.Event(enable_timing=True) if self.cuda \
            else None
        self.t = None

    def record(self) -> "Mark":
        if self.cuda:
            self.event.record()
        else:
            self.t = time.perf_counter()
        return self

    def synchronize(self) -> None:
        if self.cuda:
            self.event.synchronize()

    def elapsed_ms(self, later: "Mark") -> float:
        if self.cuda:
            return self.event.elapsed_time(later.event)
        return (later.t - self.t) * 1e3


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
