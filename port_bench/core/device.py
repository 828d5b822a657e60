"""The few CUDA calls the drivers make, as no-ops on the CPU (where the
tests dry-run a cell at a tiny size; a measured run always has a card)."""

from __future__ import annotations

import torch


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def alloc_retries(dev: torch.device) -> int:
    return torch.cuda.memory_stats(dev).get("num_alloc_retries", 0) if dev.type == "cuda" else 0


def free(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
