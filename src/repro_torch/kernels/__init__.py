"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin (the port of the reference kernel's ``ref.py`` oracle), all built
with nvcc and opened with ctypes (``nvcc.py``).

  sellcs_spmm/   SELL-C-σ reals SpMM, p-Laplacian apply and HVP
  bsr_spmm/      BSR reals SpMM
  plap_edge/     BSR p-Laplacian apply and HVP
  kmeans_assign/ fused kmeans distance + argmin (narrow and tiled variants)
  flash_attention/  causal / sliding-window GQA attention forward
  segment_sum/   fixed-order segmented sum of the COO backend and
                 ``row_sums`` (a helper, not the port of a TPU kernel)
"""
import time


def build_all() -> float:
    """Build every kernel of the port from its sources into
    ``build/torch_ext/``: the six nvcc libraries compile in the
    background, all at once.  Seconds taken."""
    from repro_torch.kernels import (bsr_spmm, flash_attention,
                                     kmeans_assign, plap_edge, segment_sum,
                                     sellcs_spmm)

    t0 = time.perf_counter()
    libraries = (sellcs_spmm, bsr_spmm, plap_edge, kmeans_assign,
                 flash_attention, segment_sum)
    for lib in libraries:
        lib.start_build()
    for lib in libraries:
        lib.build()
    return time.perf_counter() - t0
