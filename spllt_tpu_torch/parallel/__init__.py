"""Multi-device paths: the forest-parallel factorization and solve
(:mod:`.forest`, :mod:`.forest_mega`) and the solve sharded over the
right-hand-side columns (:mod:`.rhs`).

Devices are explicit: every function takes a list of ``torch.device``s, and
a list may name one device several times (its shards then run one after
the other there).  :func:`device_list` is the rule that ``Options(ndevices=k)``
follows."""

from __future__ import annotations

import torch

__all__ = ["device_list"]


def device_list(device, k: int) -> list:
    """The ``k`` devices that ``Options(device=device, ndevices=k)`` means:
    k shards on the CPU for 'cpu'; for 'cuda' (or 'cuda:N') the cards
    cuda:N … cuda:N+k-1, and ``ValueError`` when fewer are visible — never
    the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * k
    first = dev.index or 0
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if first + k > count:
        raise ValueError(
            f"Options(ndevices={k}) from {dev} but only {count} CUDA devices "
            "are visible; to run several shards on one card pass "
            "factor(..., devices=[...]) an explicit device list")
    return [torch.device("cuda", first + i) for i in range(k)]
