"""The reference's side of ``tests/test_torch_mesh_train.py``, run in a
process of its own on a forced 4-device CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/torch_mesh_train_reference.py OUT.npz [CASE ...]

For each case named (every case of ``mesh_cases.TRAIN_CASES`` when none
is): the seeded parameters, then
``mesh_cases.TRAIN_STEPS`` steps, each ``jax.value_and_grad(loss_fn)``
and ``make_train_step`` jitted together with ``in_shardings`` from
``param_pspecs`` / ``opt_pspecs`` / ``batch_spec`` under
``logical_sharding``.  Writes the losses and grad norms, and every
distinct addressable shard of the gradients and of the updated
parameters, ``m`` and ``v`` after each step, keyed by its place in the
global array (``mesh_cases.shard_key``).
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

import mesh_cases as mc  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.tensor_codec import flatten_pytree  # noqa: E402
from repro.launch.shardings import (  # noqa: E402
    batch_spec,
    opt_pspecs,
    param_pspecs,
    to_named,
)
from repro.launch.steps import make_train_step  # noqa: E402
from repro.models import init_params, loss_fn  # noqa: E402
from repro.models.sharding import logical_sharding, single_pod_rules  # noqa: E402
from repro.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402


def mesh(data, model):
    return jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def leaves(tree) -> dict:
    """{"/"-joined path: array} of a pytree of placed jax arrays."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v for path, v in flat}


def put_shards(out, tag, arr):
    """Every distinct addressable shard of ``arr`` under its place."""
    for sh in arr.addressable_shards:
        key = mc.shard_key(
            (sl.start or 0, n if sl.stop is None else sl.stop)
            for sl, n in zip(sh.index, arr.shape))
        out.setdefault(f"{tag}/{key}", np.asarray(sh.data))


def train_case(out, name):
    regime, shape, b, _, remat = mc.TRAIN_CASES[name]
    cfg = mc.train_config(get_config, name)
    params = init_params(cfg, jax.random.PRNGKey(mc.TRAIN_SEED))
    for k, v in flatten_pytree(jax.tree.map(np.asarray, params)).items():
        out[f"{name}/init/{k}"] = v
    opt = init_opt_state(params)
    opt_cfg = AdamWConfig(**mc.TRAIN_OPT)
    m = mesh(*shape)
    with logical_sharding(m, single_pod_rules()):
        p_sh = to_named(m, param_pspecs(cfg, m))
        o_sh = to_named(m, opt_pspecs(cfg, m))
        b_sh = {"tokens": NamedSharding(m, batch_spec(m, b, 2)),
                "labels": NamedSharding(m, batch_spec(m, b, 2))}
        if cfg.frontend is not None:
            b_sh["frontend_embeds"] = NamedSharding(m, batch_spec(m, b, 3))
        step = make_train_step(cfg, opt_cfg, remat=remat)

        def both(p, o, batch):
            def lf(q):
                return loss_fn(cfg, q, batch["tokens"], batch["labels"],
                               batch.get("frontend_embeds"),
                               aux_weight=0.01, remat=remat)

            loss, grads = jax.value_and_grad(lf)(p)
            p, o, met = step(p, o, batch)
            return loss, grads, p, o, met

        f = jax.jit(both, in_shardings=(p_sh, o_sh, b_sh))
        for i in range(mc.TRAIN_STEPS):
            batch = mc.train_batch(cfg, name, i)
            loss, grads, params, opt, met = f(params, opt, batch)
            params, opt = jax.device_put((params, opt), (p_sh, o_sh))
            out[f"{name}/loss/{i}"] = np.asarray(loss)
            out[f"{name}/step_loss/{i}"] = np.asarray(met["loss"])
            out[f"{name}/grad_norm/{i}"] = np.asarray(met["grad_norm"])
            for kind, tree in (("g", jax.device_put(grads, p_sh)),
                               ("p", params), ("m", opt["m"]),
                               ("v", opt["v"])):
                for k, v in leaves(tree).items():
                    put_shards(out, f"{name}/{kind}/{i}/{k}", v)


def main():
    path, names = sys.argv[1], sys.argv[2:] or list(mc.TRAIN_CASES)
    assert jax.device_count() == 4, jax.devices()
    out = {}
    for name in names:
        train_case(out, name)
    np.savez(path, **out)


if __name__ == "__main__":
    main()
