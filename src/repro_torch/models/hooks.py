"""Logical-axis sharding hook.

The port of ``repro/models/hooks.py``. Models are mesh-agnostic: they
annotate intermediates with *logical* axis names via ``constrain``. A
launcher installs a hook that maps logical names to mesh axes
(divisibility-aware) and redistributes a DTensor to those placements
(``repro_torch.launch.sharding.install_hook``). Without a hook, and on a
plain tensor, ``constrain`` returns its input as it is.
"""
from __future__ import annotations

_HOOK = None


def set_hook(fn) -> None:
    global _HOOK
    _HOOK = fn


def clear_hook() -> None:
    set_hook(None)


def constrain(x, logical_axes):
    """logical_axes: tuple of logical names (or None) per dim of ``x``."""
    if _HOOK is None:
        return x
    return _HOOK(x, logical_axes)
