"""Distributed 3D Fourier transform for the Poisson solve.

The reference's single-device `cufftPlan3d` (main.cu:112) becomes a
separable transform with two interchangeable backends:

  - "fft":    `jnp.fft` per axis — exact n log n, used on a single CPU
    device (f64 validation path).
  - "matmul": DFT as einsum against a precomputed (n, n) DFT matrix.
    Each 1D transform is one complex matmul; the op shards cleanly under
    GSPMD (the XLA SPMD partitioner miscompiles partitioned FFT ops with
    c128 operands — a hardcoded c64 scaling constant — so the matmul path
    is also the correctness workaround for distributed runs).

Sharded layouts: 1D transforms only ever run along *unsharded* axes;
`with_sharding_constraint` repartitions between stages make XLA insert the
all-to-all transposes that rotate the sharded axis (the Ulysses-shaped
pattern, SURVEY.md §5):

  slab ("y",):        P(None, y, None)  --T(z), T(x)-->  P(y, None, None)
                      --T(y)-->  back to P(None, y, None)
  pencil ("y", "x"):  P(None, y, x)  --T(z)-->  P(x, y, None)  --T(x)-->
                      P(x, None, y)  --T(y)-->  back to P(None, y, x)
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@lru_cache(maxsize=None)
def _dft_matrix(n: int, inverse: bool, f64: bool):
    """W[j, k] = exp(-+ 2 pi i j k / n) (ifft includes the 1/n)."""
    j = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    sign = 2.0j if inverse else -2.0j
    w = np.exp(sign * np.pi * j * k / n)
    if inverse:
        w /= n
    return w.astype(np.complex128 if f64 else np.complex64)


# Contraction subscripts that keep the output axis order equal to the input's
# with NO transposes: each 1D transform is a single dot_general
# ('zyx,kx->zyk' is A @ H^T, 'ky,zyx->zkx' a z-batched H @ A).
_EINSUM_3D = {0: "kz,zyx->kyx", 1: "ky,zyx->zkx", 2: "zyx,kx->zyk"}


def _contract(mat, a, axis: int):
    """Apply (n, n) `mat` along `axis` of 3D `a`, transpose-free.

    Always HIGHEST: on the GPU a lower precision lets an f32 contraction
    run in TF32, which keeps about three decimal digits."""
    sub = _EINSUM_3D[axis]
    args = (a, mat) if axis == 2 else (mat, a)
    return jnp.einsum(sub, *args, precision=jax.lax.Precision.HIGHEST)


def _apply_dft(a, axis: int, inverse: bool):
    f64 = a.dtype in (jnp.float64, jnp.complex128)
    w = jnp.asarray(_dft_matrix(a.shape[axis], inverse, f64))
    return _contract(w, a, axis)


def _transform(a, axis: int, inverse: bool, method: str):
    if method == "fft":
        return (jnp.fft.ifft if inverse else jnp.fft.fft)(a, axis=axis)
    return _apply_dft(a, axis, inverse)


def default_method(mesh: Optional[Mesh]) -> str:
    multi = mesh is not None and mesh.devices.size > 1
    if multi:
        return "matmul"
    return "fft" if jax.default_backend() == "cpu" else "matmul"


def _cs(a, mesh: Mesh, spec: P):
    return jax.lax.with_sharding_constraint(a, NamedSharding(mesh, spec))


def _check(extent: int, mesh: Mesh, axis: str, what: str):
    n = mesh.shape[axis]
    if extent % n:
        raise ValueError(
            f"{what} extent {extent} must divide mesh '{axis}' size {n} for the "
            f"pencil FFT (choose NZ = 2^k + 1 / power-of-two NX, NY)"
        )


def fft3(a, mesh: Optional[Mesh] = None, inverse: bool = False, method: Optional[str] = None):
    """3D transform of (NE, NY, NX); distributed when a mesh is given."""
    method = method or default_method(mesh)
    if mesh is None or mesh.devices.size == 1:
        if method == "fft":
            return (jnp.fft.ifftn if inverse else jnp.fft.fftn)(a, axes=(0, 1, 2))
        for ax in (0, 1, 2):
            a = _transform(a, ax, inverse, method)
        return a

    ne, ny, nx = a.shape
    pencil = "x" in mesh.axis_names
    _check(ne, mesh, "y", "extended z")
    if pencil:
        _check(ne, mesh, "x", "extended z")
        _check(nx, mesh, "y", "x")

    if not pencil:
        # slab: z and x are local
        a = _cs(a, mesh, P(None, "y", None))
        a = _transform(a, 0, inverse, method)
        a = _transform(a, 2, inverse, method)
        a = _cs(a, mesh, P("y", None, None))   # all-to-all: y -> z
        a = _transform(a, 1, inverse, method)
        return _cs(a, mesh, P(None, "y", None))

    a = _cs(a, mesh, P(None, "y", "x"))
    a = _transform(a, 0, inverse, method)       # z local
    a = _cs(a, mesh, P("x", "y", None))         # all-to-all: x -> z
    a = _transform(a, 2, inverse, method)       # x local
    a = _cs(a, mesh, P("x", None, "y"))         # all-to-all: y -> x
    a = _transform(a, 1, inverse, method)       # y local
    return _cs(a, mesh, P(None, "y", "x"))


# ---------------------------------------------------------------------------
# DST-I z-transform + 2D x,y Hartley: the reduced form of the odd-extension solve
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _dst1_matrix(n: int, f64: bool):
    """DST-I matrix B[m-1, z-1] = sin(pi m z / (n+1)), m,z = 1..n.
    Self-inverse up to a factor (n+1)/2."""
    mz = np.arange(1, n + 1)
    B = np.sin(np.pi * mz[:, None] * mz[None, :] / (n + 1))
    return B.astype(np.float64 if f64 else np.float32)


def dst_z(a):
    """Apply DST-I along axis 0 of (NZI, NY, NX) real data — one real
    matmul (the reduced form of the reference's odd-extension FFT in z,
    poisson.cu:114-158 + cufft z-transform)."""
    f64 = a.dtype == jnp.float64
    B = jnp.asarray(_dst1_matrix(a.shape[0], f64))
    return _contract(B, a, 0)


def dst_z_padded(a):
    """Inverse-stage DST-I along axis 0 whose output carries one zero row at
    each end — the wall planes z=0 and z=NZ-1 the caller overwrites with the
    Dirichlet plate values (odd_extract, poisson.cu:191-204).  Emitting them
    from the same matmul avoids a full-volume concatenate pass."""
    f64 = a.dtype == jnp.float64
    n = a.shape[0]
    B = np.zeros((n + 2, n), dtype=np.float64 if f64 else np.float32)
    B[1:-1] = np.asarray(_dst1_matrix(n, f64))
    return _contract(jnp.asarray(B), a, 0)


@lru_cache(maxsize=None)
def _hartley_matrix(n: int, f64: bool):
    """H[k, j] = cas(2 pi j k / n) = cos + sin.  Real, symmetric,
    H @ H = n I.  For any spectral symbol even in the frequency index
    (mu[k] == mu[n-k]) — true of kx^2, ky^2 here — diagonal multiplication
    in Hartley space gives exactly the DFT result, at 1/4 the matmul work
    of a complex DFT."""
    jk = np.outer(np.arange(n), np.arange(n)) * (2.0 * np.pi / n)
    H = np.cos(jk) + np.sin(jk)
    return H.astype(np.float64 if f64 else np.float32)


def _apply_hartley(a, axis: int):
    f64 = a.dtype == jnp.float64
    H = jnp.asarray(_hartley_matrix(a.shape[axis], f64))
    return _contract(H, a, axis)


def hartley2_xy(a, mesh: Optional[Mesh] = None):
    """Unnormalized real Hartley transform along (y, x) of real (NZI, NY, NX).
    Self-inverse up to 1/(NY*NX) (the caller folds the normalization into
    its overall scale)."""
    if mesh is None or mesh.devices.size == 1:
        for ax in (1, 2):
            a = _apply_hartley(a, ax)
        return a

    pencil = "x" in mesh.axis_names
    if not pencil:
        a = _cs(a, mesh, P(None, "y", None))
        a = _apply_hartley(a, 2)                 # x local
        a = _cs(a, mesh, P(None, None, "y"))     # all-to-all: y -> x
        a = _apply_hartley(a, 1)                 # y local
        return _cs(a, mesh, P(None, "y", None))

    a = _cs(a, mesh, P(None, ("y", "x"), None))  # gather x onto y-dim
    a = _apply_hartley(a, 2)                     # x local
    a = _cs(a, mesh, P(None, None, ("y", "x")))  # swap: y -> x-dim
    a = _apply_hartley(a, 1)                     # y local
    return _cs(a, mesh, P(None, "y", "x"))
