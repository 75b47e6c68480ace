"""pscheck for the port — AST invariant analysis of ``src/repro_torch``.

A pure-AST tool: it parses the files it checks and never imports or
runs them, so it needs no device, and it imports nothing of JAX or of
the reference package (``core.py`` keeps its own copy of the
reference's machinery).

Library::

    from repro_torch import analysis
    findings = analysis.run(["src/repro_torch"])        # every rule
    analysis.assert_clean(paths, rules=["host-sync"])   # pytest facing

CLI::

    python -m repro_torch.analysis src/repro_torch --baseline pscheck_torch_baseline.json

Exit status 0 clean, 1 unbaselined findings or stale baseline entries,
2 usage errors; ``--json`` prints the findings.  The suppression
directive (``# pscheck: disable=<rule> (reason)``, reason required),
the meta-rules (``suppression-reason``, ``unused-suppression``,
``parse-error``) and the shrink-only baseline keyed on (rule, module
path, symbol, message) are the reference's, unchanged.  Module paths
resolve under the directory ``repro_torch`` (``core.module_rel``).

The reference's 11 rules rest on JAX premises (traced scopes of
``jit``/``scan``/``pallas_call``, retraces on static arguments).  What
each means for eager torch:

* ``host-sync`` — **kept, new scope.**  The reference looks inside
  traced scopes; eager torch has none on its path, and a host sync
  costs most where it runs once an iteration.  The scope is the test
  and body of every loop of the hot modules (``profile.HOST_SYNC_SCOPE``
  = the scipy-ban list) and of what they call in the same module
  (``scopes.py``).  It flags ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``
  and ``float()``/``int()``/``bool()`` of a non-literal; how it tells
  a tensor from a Python number (it errs towards flagging) is in
  ``rules/hostsync.py``.
* ``traced-branch`` — **folded into host-sync.**  A Python ``if``/
  ``while``/``assert`` on a tensor is an implicit ``bool(tensor)``,
  the same device sync, so host-sync flags it over the same scope
  rather than a second id reporting the same line twice.
* ``retrace-static`` — **dropped.**  Eager torch keeps no trace cache
  keyed on arguments: a config object passed to a torch function is
  neither hashed nor retraced.
* ``retrace-loop-jit`` — **changed to its torch analogue:** nothing in
  a ``for``/``while`` body builds a kernel or compiles
  (``NvccLibrary(...)`` of ``kernels/nvcc.py``, which builds once per
  library object and so once per process for the module-level ones,
  ``torch.utils.cpp_extension.load*``, ``torch.compile``,
  ``torch.jit.script``/``trace``), unless under ``registry.memoized``.
* ``retrace-mutable-default`` — **kept**, over every def of the hot
  modules (``profile.MUTABLE_DEFAULT_SCOPE``; the reference's traced
  defs have no eager counterpart), with its fixer (a ``{}``/``[]``
  default becomes ``None`` plus a guard): the hazard and the rewrite are
  framework-agnostic.
* ``hot-purity`` — **kept, both bans:** scipy over ``SCIPY_BAN``, numpy
  over ``NUMPY_BAN`` (torch only there).  Its third check, numpy/scipy
  in a traced scope anywhere, is dropped: the port traces nothing (no
  ``torch.compile``, ``torch.vmap`` or ``torch.jit`` on its path).  The
  np→jnp fixer is **dropped** too: np→torch is not mechanical, because
  torch's dtype defaults and device placement differ from numpy's.
* ``dense-matmul`` — **kept** over ``multilevel/``: no ``@``, no
  ``torch.matmul``/``mm``/``bmm``/``einsum``/``tensordot`` (or the
  numpy ones) and no ``.to_dense()``/``.toarray()``.
* ``api-boundary`` — **kept, with torch's reductions:** outside
  ``grblas/`` and ``kernels/`` no raw ``index_add_``/``scatter_add_``/
  ``scatter_reduce`` and no direct use of ``kernels/segment_sum`` (the
  reference's raw ``segment_sum``); the sparse kernel packages
  (``sellcs_spmm``, ``bsr_spmm``, ``plap_edge``) are imported only from
  ``grblas/`` and ``kernels/``; the backend registry's privates stay
  inside ``grblas/``.
* ``pad-fold`` — **kept** over the padded-layout modules
  (``grblas/backends.py``, ``grblas/dist.py``, ``grblas/semiring.py``
  and the three sparse kernel packages); it reads torch's ``dim=`` as
  well as ``axis=``, and a kernel package imported as a module claims
  the attributes the dispatch module reads off it.
* ``dtype-hygiene`` — **kept, with torch names:** ``torch.float64``/
  ``double``/``int64``/``long`` (and ``.double()``/``.long()``)
  hardcoded in the device modules, and every tensor constructor in
  ``containers.py``'s ``_build_*`` builders pins its dtype.
* ``registry-span`` — **kept** over ``grblas/backends.py``'s
  ``register_backend`` and ``core/solvers/``'s ``register_solver``;
  ``grblas/api.py``'s ``grblas.mxm``/``grblas.spgemm`` spans and
  ``registry.py``'s ``solver.level`` span hold the coverage.

Per-rule invariants live on the Rule objects
(``registered_rules()[id].invariant``); the scope tables are in
``profile.py``.
"""
from repro_torch.analysis.core import (  # noqa: F401
    Finding,
    ModuleContext,
    ProjectContext,
    Rule,
    apply_baseline,
    apply_fixes,
    assert_clean,
    collect_files,
    load_baseline,
    module_rel,
    register_rule,
    registered_rules,
    resolve_rules,
    run,
    write_baseline,
)
