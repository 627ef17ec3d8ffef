"""The reference's side of ``tests/test_torch_mesh_train.py``, run in a
process of its own on a forced 4-device CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/torch_mesh_train_reference.py OUT.npz [CASE ...]

For each case named (of ``mesh_cases.TRAIN_CASES``,
``TRAIN_COMP_CASES`` or ``TRAIN_FAMILY_CASES``; every case of
``TRAIN_CASES`` when none is): the
seeded parameters (the RWKV6 family cases' decay leaves drawn,
``mesh_cases.rwkv6_draws``), then
``mesh_cases.TRAIN_STEPS`` steps, each ``jax.value_and_grad(loss_fn)``
and ``make_train_step`` (for a family case its body: ``adamw_update`` of
those gradients) jitted together with ``in_shardings`` from
``param_pspecs`` / ``opt_pspecs`` / ``batch_spec`` under
``logical_sharding``.  Writes the losses and grad norms, and every
distinct addressable shard of the gradients and of the updated
parameters, ``m`` and ``v`` after each step, keyed by its place in the
global array (``mesh_cases.shard_key``).  A case of
``mesh_cases.TRAIN_FAMILY_MTP`` also writes ``mtp_loss``'s value and
gradient shards at the seeded parameters.  A case of
``TRAIN_COMP_CASES`` steps with gradient compression, its error feedback
placed like the parameters, and writes its shards after each step too.

A case of ``mesh_cases.COMP_CASES`` is the compressor alone:
``compress_gradients`` jitted with ``in_shardings`` = ``param_pspecs``
on the case's mesh, called twice on ``mesh_cases.comp_grads``' draws for
kv4's leaves (the second call on the first's error feedback); it writes
the draws, the decoded gradients' and the error feedback's shards and
each leaf's lo and hi.
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
from repro.models import init_params, loss_fn, mtp_loss  # noqa: E402
from repro.models.sharding import logical_sharding, single_pod_rules  # noqa: E402
from repro.optim.adamw import (  # noqa: E402
    AdamWConfig,
    adamw_update,
    init_opt_state,
)
from repro.optim.compression import (  # noqa: E402
    GradCompressionConfig,
    compress_gradients,
    init_error_feedback,
)


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


def mtp_case(out, name, cfg, params, p_sh, b_sh):
    """``value_and_grad`` of ``mtp_loss`` at ``params``, jitted with the
    same shardings: its loss and its gradient's shards."""
    batch = dict(mc.train_batch(cfg, name, 0, mc.TRAIN_FAMILY_CASES),
                 labels_next2=mc.mtp_labels(cfg, name))
    b_sh = dict(b_sh, labels_next2=b_sh["labels"])

    def f(p, batch):
        return jax.value_and_grad(lambda q: mtp_loss(
            cfg, q, batch["tokens"], batch["labels"],
            batch["labels_next2"]))(p)

    loss, grads = jax.jit(f, in_shardings=(p_sh, b_sh))(params, batch)
    out[f"{name}/mtp/loss"] = np.asarray(loss)
    for k, v in leaves(jax.device_put(grads, p_sh)).items():
        put_shards(out, f"{name}/mtp/g/{k}", v)


def train_case(out, name):
    cases = mc.train_cases(name)
    regime, shape, b, _, remat = cases[name]
    cfg = mc.train_config(get_config, name, cases)
    # one compiled program, not an eager dispatch a leaf
    params = jax.jit(lambda k: init_params(cfg, k))(
        jax.random.PRNGKey(mc.TRAIN_SEED))
    if cfg.attn_type == "rwkv6" and cases is mc.TRAIN_FAMILY_CASES:
        attn = params["layers"]["attn"]
        draws = mc.rwkv6_draws({k: attn[k].shape for k in attn})
        attn = dict(attn, **{k: jax.numpy.asarray(v, attn[k].dtype)
                             for k, v in draws.items()})
        params = dict(params, layers=dict(params["layers"], attn=attn))
    for k, v in flatten_pytree(jax.tree.map(np.asarray, params)).items():
        out[f"{name}/init/{k}"] = v
    opt = jax.jit(init_opt_state)(params)
    opt_cfg = AdamWConfig(**mc.TRAIN_OPT)
    grad_comp = None
    if cases is mc.TRAIN_COMP_CASES:
        grad_comp = GradCompressionConfig(bits=mc.TRAIN_COMP_BITS)
        opt["ef"] = jax.jit(init_error_feedback)(params)
    m = mesh(*shape)
    with logical_sharding(m, single_pod_rules()):
        pspecs = param_pspecs(cfg, m)
        p_sh = to_named(m, pspecs)
        o_sh = to_named(m, opt_pspecs(cfg, m, pspecs))
        if grad_comp is not None:
            o_sh["ef"] = p_sh
        b_sh = {"tokens": NamedSharding(m, batch_spec(m, b, 2)),
                "labels": NamedSharding(m, batch_spec(m, b, 2))}
        if cfg.frontend is not None:
            b_sh["frontend_embeds"] = NamedSharding(m, batch_spec(m, b, 3))
        step = make_train_step(cfg, opt_cfg, remat=remat,
                               grad_comp=grad_comp)

        def both(p, o, batch):
            def lf(q):
                return loss_fn(cfg, q, batch["tokens"], batch["labels"],
                               batch.get("frontend_embeds"),
                               aux_weight=0.01, remat=remat)

            loss, grads = jax.value_and_grad(lf)(p)
            if cases is mc.TRAIN_FAMILY_CASES:
                # make_train_step's body without compression, the same
                # gradients going into the update: half the program
                p, o, met = adamw_update(opt_cfg, p, grads, o)
                return loss, grads, p, o, dict(met, loss=loss)
            p, o, met = step(p, o, batch)
            return loss, grads, p, o, met

        if name in mc.TRAIN_FAMILY_MTP:
            mtp_case(out, name, cfg, params, p_sh, b_sh)
        f = jax.jit(both, in_shardings=(p_sh, o_sh, b_sh))
        for i in range(mc.TRAIN_STEPS):
            batch = mc.train_batch(cfg, name, i, cases)
            loss, grads, params, opt, met = f(params, opt, batch)
            params, opt = jax.device_put((params, opt), (p_sh, o_sh))
            out[f"{name}/loss/{i}"] = np.asarray(loss)
            out[f"{name}/step_loss/{i}"] = np.asarray(met["loss"])
            out[f"{name}/grad_norm/{i}"] = np.asarray(met["grad_norm"])
            kinds = [("g", jax.device_put(grads, p_sh)), ("p", params),
                     ("m", opt["m"]), ("v", opt["v"])]
            if grad_comp is not None:
                kinds.append(("ef", opt["ef"]))
            for kind, tree in kinds:
                for k, v in leaves(tree).items():
                    put_shards(out, f"{name}/{kind}/{i}/{k}", v)


def comp_case(out, name):
    """``compress_gradients`` of kv4's leaves jitted with ``in_shardings``
    = ``param_pspecs`` on the case's mesh, twice: the draws, the decoded
    gradients' and the new error feedback's shards, and each leaf's lo
    and hi (the min and max of its whole corrected gradient)."""
    cfg = mc.tp_config(get_config, "kv4")
    shapes = jax.eval_shape(lambda k: init_params(cfg, k),
                            jax.random.PRNGKey(0))
    paths = {k: v.shape for k, v in leaves(shapes).items()}
    comp = GradCompressionConfig(bits=mc.TRAIN_COMP_BITS)
    m = mesh(*mc.COMP_CASES[name])
    with logical_sharding(m, single_pod_rules()):
        p_sh = to_named(m, param_pspecs(cfg, m))
        f = jax.jit(lambda g, e: compress_gradients(comp, g, e),
                    in_shardings=(p_sh, p_sh))
        ef = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        for call in range(mc.COMP_CALLS):
            draws = mc.comp_grads(paths, call)
            grads = jax.tree.unflatten(
                jax.tree.structure(shapes),
                [draws[k] for k in leaves(shapes)])
            for k, v in draws.items():
                out[f"{name}/in/{call}/{k}"] = v
            for k, v in leaves(ef).items():
                corrected = draws[k] + np.asarray(v)
                out[f"{name}/lohi/{call}/{k}"] = np.array(
                    [corrected.min(), corrected.max()], np.float32)
            dec, ef = f(grads, ef)
            for kind, tree in (("dec", dec), ("ef", ef)):
                for k, v in leaves(tree).items():
                    put_shards(out, f"{name}/{kind}/{call}/{k}", v)


def main():
    path, names = sys.argv[1], sys.argv[2:] or list(mc.TRAIN_CASES)
    assert jax.device_count() == 4, jax.devices()
    out = {}
    for name in names:
        (comp_case if name in mc.COMP_CASES else train_case)(out, name)
    np.savez(path, **out)


if __name__ == "__main__":
    main()
