"""The port stands alone: it never imports JAX or the reference package,
and its entry points do not quietly fall back to the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch


SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(SRC)))
def test_port_module_imports_no_jax_or_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_import_repro_torch_loads_no_jax_or_reference():
    code = ("import sys, repro_torch, repro_torch.convert\n"
            "from repro_torch.core import psc, plap, lobpcg, grassmann, "
            "kmeans, metrics\n"
            "from repro_torch.graphs import delaunay_graph\n"
            "from repro_torch.kernels import sellcs_spmm, bsr_spmm, "
            "plap_edge\n"
            "from repro_torch.graphs import reorder\n"
            "from repro_torch.multilevel import multilevel_cluster\n"
            "from repro_torch.kernels import kmeans_assign, "
            "flash_attention\n"
            "from repro_torch.configs import get_config\n"
            "from repro_torch.models import model, attention, layers\n"
            "from repro_torch.serve import ServeEngine\n"
            "from repro_torch.launch import serve\n"
            "from repro_torch import obs, testing\n"
            "from repro_torch.obs import trace, metrics\n"
            "from repro_torch.testing import faultinject\n"
            "from repro_torch.graphs import validate, mmio, partition\n"
            "from repro_torch.core.solvers import scf, inverse_power, "
            "guard\n"
            "from repro_torch.serve import psc_engine, bucketing, "
            "warm_cache, churn, ClusterServeEngine\n"
            "from repro_torch.obs import retrace, RetraceDetector\n"
            "from repro_torch.multilevel import patch_hierarchy, "
            "refine_cluster\n"
            "from repro_torch.core.lobpcg import lobpcg_fixed\n"
            "from repro_torch.core.grassmann import rtr_minimize_batched\n"
            "from repro_torch.testing import serve_batch_fault, "
            "serve_churn_fault\n"
            "from repro_torch.grblas import dist, device_mesh, "
            "make_row_partition, shard_mxm\n"
            "from repro_torch.graphs import partition_for_mesh\n"
            "from repro_torch.testing import halo_corruption\n"
            "import repro_torch.analysis, repro_torch.analysis.rules\n"
            "from repro_torch.analysis import __main__, profile, scopes\n"
            "from repro_torch.train import checkpoint, fault_tolerance, "
            "loop, optimizer, CheckpointManager\n"
            "from repro_torch.data import SyntheticTokens, tokens\n"
            "from repro_torch.launch import train\n"
            "import repro_torch.dist, repro_torch.launch.mesh\n"
            "from repro_torch.dist import sharding, compression, "
            "resolve_spec, compressed_psum_tree\n"
            "from repro_torch.launch.mesh import Mesh, make_host_mesh, "
            "make_production_mesh, make_dry_mesh\n"
            "from repro_torch.launch import dryrun, shapes, roofline, "
            "op_count\n"
            "from repro_torch.launch.dryrun import trace_cell, run_cell\n"
            "from repro_torch.models.model import param_shapes, "
            "cache_abstract\n"
            "from repro_torch.models.layers import shape_tree, "
            "count_params\n"
            "from repro_torch.models.attention import gqa_cache_abstract, "
            "mla_cache_abstract\n"
            "from repro_torch.models.mamba2 import mamba_cache_abstract\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


@pytest.mark.parametrize("first", ["repro_torch.core", "repro_torch.grblas"])
def test_core_exports_load_lazily_without_a_cycle(first):
    """``repro_torch.core`` exports the reference's names through a lazy
    module ``__getattr__``: importing the package imports none of its
    submodules, and either package imported first leaves no cycle."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({first!r})\n"
            "import repro_torch.core as core\n"
            f"if {first!r} == 'repro_torch.core':\n"
            "    assert 'repro_torch.core.psc' not in sys.modules\n"
            "from repro_torch.core import (PSCConfig, PSCResult, "
            "p_spectral_cluster, spectral_cluster, plap, metrics, kmeans, "
            "lobpcg, grassmann, phi, solvers)\n"
            "from repro_torch.core import psc\n"
            "assert PSCConfig is psc.PSCConfig and PSCResult is psc.PSCResult\n"
            "assert p_spectral_cluster is psc.p_spectral_cluster\n"
            "assert spectral_cluster is psc.spectral_cluster\n"
            "assert solvers.__name__ == 'repro_torch.core.solvers'\n"
            "assert sorted(core.__all__) == sorted(['PSCConfig', "
            "'PSCResult', 'p_spectral_cluster', 'spectral_cluster', 'plap', "
            "'metrics', 'kmeans', 'lobpcg', 'grassmann', 'phi', "
            "'solvers'])\n"
            "assert set(core.__all__) <= set(dir(core))\n"
            "try:\n"
            "    core.no_such_name\n"
            "except AttributeError:\n"
            "    pass\n"
            "else:\n"
            "    raise SystemExit('no AttributeError')\n"
            "import repro_torch.grblas\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _kernel_module():
    import importlib

    return importlib.import_module(
        "repro_torch.kernels.sellcs_spmm.sellcs_spmm")


def test_import_builds_no_extension():
    K = _kernel_module()

    assert K.LIBRARY._lib is None and K.LIBRARY._proc is None


@pytest.mark.parametrize("name", ["bsr_spmm", "plap_edge", "kmeans_assign",
                                  "flash_attention", "sellcs_spmm",
                                  "segment_sum"])
def test_import_builds_no_nvcc_library(name):
    import importlib

    lib = importlib.import_module(f"repro_torch.kernels.{name}.{name}").LIBRARY
    assert lib._lib is None and lib._proc is None
    assert lib.path.name.startswith(f"{name}-") and lib.path.suffix == ".so"


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.graphs import ring_of_cliques
    from repro_torch.grblas import SparseMatrix

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ring_of_cliques(3, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SparseMatrix.from_coo([0, 1], [1, 0], [1.0, 1.0], (2, 2))
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_take_the_twin_only_for_cpu_tensors():
    """A multivector off the CPU goes to the kernel (CUDA) or raises; the
    plain twins serve CPU tensors only."""
    from repro_torch.graphs import ring_of_cliques

    K = _kernel_module()
    W, _ = ring_of_cliques(3, 4, device="cpu", build_sellcs=True, sell_c=4)
    X = torch.zeros((W.n_rows, 2), dtype=W.vals.dtype)
    assert K._check(W, X) is False
    meta = X.to("meta")
    with pytest.raises(ValueError):
        K._check(W, meta)


def test_bsr_wrappers_take_the_twin_only_for_cpu_tensors():
    from repro_torch.graphs import ring_of_cliques
    from repro_torch.kernels.bsr_spmm.bsr_spmm import check_operands

    W, _ = ring_of_cliques(3, 4, device="cpu", build_bsr=True, block_size=4)
    X = torch.zeros((W.n_rows, 2), dtype=W.vals.dtype)
    assert check_operands(W, X) is False
    with pytest.raises(ValueError):
        check_operands(W, X.to("meta"))


class _OtherDevice(torch.Tensor):
    """A CPU tensor that reports a device with no kernel and no plain
    route."""

    @property
    def device(self):
        return torch.device("xpu")


def test_dense_ops_take_the_plain_version_only_for_cpu_tensors():
    """flash_attention and kmeans_assign run their plain versions for CPU
    tensors and raise for a device that has no kernel; flash_attention's
    meta route (the dry run's) only makes its output's shape."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.kmeans_assign import kmeans_assign

    q = torch.zeros((1, 2, 4, 8))
    assert flash_attention(q, q, q).device.type == "cpu"
    X = torch.zeros((5, 2))
    assert kmeans_assign(X, X[:2])[0].device.type == "cpu"
    out = flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    assert out.is_meta and out.shape == q.shape
    other = torch.Tensor._make_subclass(_OtherDevice, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(other, other, other)
    with pytest.raises(ValueError, match="CUDA"):
        kmeans_assign(X.to("meta"), X[:2].to("meta"))


def test_lm_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model as M

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(get_reduced_config("gemma-2b"))
