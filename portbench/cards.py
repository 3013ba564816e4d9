"""The cards a run measures: every card this process sees.

``run.py`` narrows ``CUDA_VISIBLE_DEVICES`` to the cell's ``chips`` before
CUDA starts, and the server it starts inherits that, so in both processes
the visible cards are the cell's cards.  Every place the harness touches a
card goes through these: the window's synchronisation and the reset and
reading of each card's peak memory.  Without CUDA there is no card and
each is a no-op.
"""
from __future__ import annotations

from typing import List

import torch


def visible() -> List[int]:
    """The indices of the cards this process sees."""
    return list(range(torch.cuda.device_count()))


def sync() -> None:
    """Wait until every card has finished its work."""
    for d in visible():
        torch.cuda.synchronize(d)


def reset_peaks() -> None:
    for d in visible():
        torch.cuda.reset_peak_memory_stats(d)


def peaks() -> List[int]:
    """Each card's peak allocated bytes since its last reset."""
    return [int(torch.cuda.max_memory_allocated(d)) for d in visible()]
