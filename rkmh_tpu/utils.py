"""Small host/device utilities."""

from __future__ import annotations

import jax


def to_host(tree):
    """Device->host transfer of a pytree in one grouped device_get."""
    return jax.device_get(tree)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    p = 1
    while p < n:
        p <<= 1
    return p
