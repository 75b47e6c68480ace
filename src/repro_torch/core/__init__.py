"""repro_torch.core — p-spectral clustering on the Grassmann manifold,
with the GraphBLAS-style algebra of ``repro_torch.grblas`` underneath.

Submodules are imported by name (``from repro_torch.core import psc``);
the package itself imports nothing, so ``grblas`` can import
``core.phi`` without a cycle."""
