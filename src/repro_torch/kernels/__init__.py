"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin (the port of the reference kernel's ``ref.py`` oracle).

  sellcs_spmm/   SELL-C-σ reals SpMM, p-Laplacian apply and HVP
                 (torch.utils.cpp_extension.load)
  bsr_spmm/      BSR reals SpMM              (nvcc + ctypes, ``nvcc.py``)
  plap_edge/     BSR p-Laplacian apply and HVP  (nvcc + ctypes)
  kmeans_assign/ fused kmeans distance + argmin  (nvcc + ctypes)
  flash_attention/  causal / sliding-window GQA attention forward
                 (nvcc + ctypes)
"""
import time


def build_all() -> float:
    """Build every kernel of the port from its sources into
    ``build/torch_ext/``: the four nvcc libraries compile in the
    background, all at once, while the SELL-C-σ extension builds.
    Seconds taken."""
    from repro_torch.kernels import (bsr_spmm, flash_attention,
                                     kmeans_assign, plap_edge, sellcs_spmm)

    t0 = time.perf_counter()
    libraries = (bsr_spmm, plap_edge, kmeans_assign, flash_attention)
    for lib in libraries:
        lib.start_build()
    sellcs_spmm.build()
    for lib in libraries:
        lib.build()
    return time.perf_counter() - t0
