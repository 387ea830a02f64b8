"""Shared Pallas helpers."""

from __future__ import annotations

import jax


def sds_like(shape, dtype, *like):
    """ShapeDtypeStruct that varies over the mesh axes any of ``like`` does.

    Under shard_map with check_vma=True, pallas_call outputs must declare
    how they vary over the mesh axes; outside shard_map the vma set is
    empty and omitted.
    """
    vma = frozenset().union(*(jax.typeof(x).vma for x in like))
    if vma:
        return jax.ShapeDtypeStruct(shape, dtype, vma=vma)
    return jax.ShapeDtypeStruct(shape, dtype)
