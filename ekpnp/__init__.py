"""ekpnp — a JAX 3D electrokinetic (EK-PNP) microchannel solver.

Brand-new JAX/XLA/Pallas implementation of the capabilities of the reference
CUDA solver gyf135/EK-PNP-3D: four coupled D3Q27 lattice-Boltzmann
populations (fluid momentum, two ion species, temperature), a spectral
Poisson solver for the electric potential, Poisson-Boltzmann double-layer
initialization, and multi-chip domain decomposition over a
`jax.sharding.Mesh`.
"""
from .config import Config, GridConfig, PhysicsConfig, RunConfig, preset
from .lattice import D3Q19, D3Q27, get_lattice
from .state import Macro, State

__version__ = "0.1.0"
__all__ = [
    "Config",
    "GridConfig",
    "PhysicsConfig",
    "RunConfig",
    "preset",
    "D3Q19",
    "D3Q27",
    "get_lattice",
    "State",
    "Macro",
]
