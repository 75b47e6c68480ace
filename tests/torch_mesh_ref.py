"""Reference side of the port's sharding tests (``test_torch_mesh.py``).

Run as a script in a subprocess with four host devices (the device
count is fixed before JAX starts, as ``tests/test_moe_dispatch.py``
does): ``python tests/torch_mesh_ref.py IN.pkl OUT.pkl``.  IN holds the
cases; for each it runs the reference's meshed ``moe_block`` (jitted
under a ``(data, model)`` mesh, as its own test runs it) on the given
numpy parameters and input, and the reference's int8 compressed train
step on two devices (per step also what its quantizer divided by the
scale, the scale and the reduced gradient); OUT holds the results as
numpy arrays.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import pickle  # noqa: E402

import numpy as np  # noqa: E402


def moe_case(case):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced_config
    from repro.models import moe as MOE

    cfg = get_reduced_config(case["arch"])
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, **case["moe"]))
    params = jax.tree.map(jnp.asarray, case["params"])
    mesh = jax.make_mesh(case["mesh"], ("data", "model"))
    x = jnp.asarray(case["x"])
    with mesh:
        y, aux = jax.jit(lambda p, v: MOE.moe_block(cfg, p, v, mesh=mesh))(
            params, x)
    return dict(y=np.array(y), aux=float(aux))


def int8_steps(case):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import get_reduced_config
    from repro.train import (TrainConfig, init_compression_state,
                             make_optimizer, make_train_step)

    import repro.dist.compression as C

    # The step calls compressed_psum_tree by its module's name; a
    # wrapper that runs it unchanged also returns, inside the jitted
    # step, what it quantized divided by its scale ("pre"), the scale
    # broadcast to the leaf ("quantum") and the reduced gradient
    # ("red"), riding in the residual's place.
    psum = C.compressed_psum_tree

    def traced_psum(grads, err, mesh, axis="data"):
        red, new_err = psum(grads, err["err"], mesh, axis)
        comp = jax.tree.map(lambda g, e: g.astype(jnp.float32) + e,
                            grads, err["err"])
        quantum = jax.tree.map(lambda c: jnp.broadcast_to(
            C.quantize_int8(c)[1], c.shape), comp)
        pre = jax.tree.map(jnp.divide, comp, quantum)
        return red, dict(err=new_err, pre=pre, quantum=quantum, red=red)

    C.compressed_psum_tree = traced_psum
    cfg = get_reduced_config(case["arch"])
    params = jax.tree.map(jnp.asarray, case["params"])
    mesh = Mesh(np.array(jax.devices()[:case["ranks"]]), ("data",))
    tc = TrainConfig(**case["tc"])
    opt = make_optimizer(tc)
    step = jax.jit(make_train_step(cfg, tc, mesh=mesh, opt=opt))
    state = opt.init(params)
    zeros = init_compression_state(params)
    err = dict(err=zeros, pre=zeros, quantum=zeros, red=zeros)
    out = dict(loss=[], grad_norm=[], lr=[], err=[], pre=[], quantum=[],
               red=[])
    for b in case["batches"]:
        batch = {k: jnp.asarray(v) for k, v in b.items()}
        params, state, err, m = step(params, state, err, batch)
        for k in ("loss", "grad_norm", "lr"):
            out[k].append(float(m[k]))
        for k in ("err", "pre", "quantum", "red"):
            out[k].append(jax.tree.map(np.array, err[k]))
    out["params"] = jax.tree.map(np.array, params)
    return out


def main(src, dst):
    with open(src, "rb") as f:
        spec = pickle.load(f)
    out = {"moe": {name: moe_case(c) for name, c in spec["moe"].items()},
           "int8": int8_steps(spec["int8"])}
    with open(dst, "wb") as f:
        pickle.dump(out, f)
    print("MESH_REF_OK")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
