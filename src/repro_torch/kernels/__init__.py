"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin (the port of the reference kernel's ``ref.py`` oracle).

  sellcs_spmm/   SELL-C-σ reals SpMM, p-Laplacian apply and HVP
                 (torch.utils.cpp_extension.load)
  bsr_spmm/      BSR reals SpMM              (nvcc + ctypes, ``nvcc.py``)
  plap_edge/     BSR p-Laplacian apply and HVP  (nvcc + ctypes)
"""
import time


def build_all() -> float:
    """Build every kernel of the port from its sources into
    ``build/torch_ext/``: the nvcc libraries compile in the background
    while the SELL-C-σ extension builds.  Seconds taken."""
    from repro_torch.kernels import bsr_spmm, plap_edge, sellcs_spmm

    t0 = time.perf_counter()
    bsr_spmm.start_build()
    plap_edge.start_build()
    sellcs_spmm.build()
    bsr_spmm.build()
    plap_edge.build()
    return time.perf_counter() - t0
