"""Whether the machine has the cards a cell asks for. A run without them
fails; it never falls back to the CPU."""

from __future__ import annotations


class NoCard(RuntimeError):
    """The machine has no CUDA card, or fewer than the cell asks for."""


def describe() -> dict:
    """What torch sees: ``available``, ``count`` and card 0's ``name``."""
    import torch

    if not torch.cuda.is_available():
        return {"available": False, "count": 0, "name": ""}
    count = torch.cuda.device_count()
    return {"available": True, "count": count,
            "name": torch.cuda.get_device_name(0) if count else ""}


def judge(seen: dict, chips: int) -> str:
    """Card 0's name; raises ``NoCard`` when CUDA is unavailable or has
    fewer than ``chips`` cards."""
    if not seen["available"]:
        raise NoCard("torch.cuda.is_available() is false")
    if seen["count"] < chips:
        raise NoCard(f"the cell asks for {chips} card(s), "
                     f"{seen['count']} visible")
    return seen["name"]


def check(chips: int) -> str:
    """``judge`` of what this process's torch sees."""
    return judge(describe(), chips)
