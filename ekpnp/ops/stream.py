"""Pull streaming (reference gpu_stream, LBM.cu:1963-2093).

Reference semantics: f1[x, d] = f2[x - e_d] with fully periodic wrap in all
three directions (modular index math, LBM.cu:1970-1975); the wall kernels
overwrite the unphysical z-wrap rows afterwards (boundary.py).

Here: one `jnp.roll` per direction, fused by XLA.  The GPU kernel
(ekpnp/pallas/push_step.py) instead writes each post-collision population
straight to its destination node.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..lattice import Lattice


def stream(lat: Lattice, pops):
    """pops: (Q, Z, Y, X) post-collision -> streamed (Q, Z, Y, X).

    Pulling from x - e means rolling each direction's volume by +e, with
    axis order (z, y, x) = roll shifts (e_z, e_y, e_x).
    """
    out = [pops[0]]  # rest population does not move
    for d in range(1, lat.Q):
        ex, ey, ez = (int(v) for v in lat.E[d])
        out.append(jnp.roll(pops[d], shift=(ez, ey, ex), axis=(0, 1, 2)))
    return jnp.stack(out)


def stream_many(lat: Lattice, *pops_list):
    """Stream several population arrays (skips None entries)."""
    return tuple(None if p is None else stream(lat, p) for p in pops_list)
