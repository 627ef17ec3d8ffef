"""The reference's side of ``tests/test_torch_mesh_spmd.py``, run in a
process of its own on a forced 4-device CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/torch_mesh_reference.py OUT.npz CKPT_DIR

Every input is made with numpy from a seed (``mesh_cases``, shared with
the port's ranks).  Writes one ``.npz`` of every reference output the
test needs, and a reference checkpoint into ``CKPT_DIR``.  With
``--mla OUT.npz`` it runs ``mesh_cases.TP_MLA_CASES`` alone, for
``tests/test_torch_mesh_mla.py``.
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from functools import partial  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import mesh_cases as mc  # noqa: E402
from repro.checkpoint import save_checkpoint  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.tensor_codec import flatten_pytree  # noqa: E402
from repro.launch.shardings import (  # noqa: E402
    batch_spec,
    cache_pspecs,
    param_pspecs,
    to_named,
)
from repro.launch.steps import make_wire_train_step  # noqa: E402
from repro.launch.train import build_state  # noqa: E402
from repro.models import decode_step, init_params, prefill  # noqa: E402
from repro.models.attention import attention_train, init_attention  # noqa: E402
from repro.models.moe import init_moe, moe_apply  # noqa: E402
from repro.models.sharding import logical_sharding, single_pod_rules  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim.compression import wire_quantized_psum  # noqa: E402


def mesh(data, model):
    return jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def moe_cases(out):
    """``moe_apply`` (the EP path) per case; the dropped (token, slot)
    set from the body's routing, replayed per shard with the reference's
    arithmetic (the local one-hot cumsum)."""
    for name, (data, model, n_experts) in mc.MOE_CASES.items():
        cfg = mc.moe_config(get_config, n_experts)
        p = init_moe(jax.random.PRNGKey(mc.MOE_SEED), cfg, jnp.float32)
        x = mc.moe_input()
        m = mesh(data, model)
        with logical_sharding(m, single_pod_rules()):
            y, aux = jax.jit(lambda p, x: moe_apply(p, cfg, x))(p, x)
        out[f"moe/{name}/out"] = np.asarray(y)
        out[f"moe/{name}/aux"] = np.asarray(aux)
        for k, v in np_tree(p).items():
            out[f"moe/{name}/p/{k}"] = v
        out[f"moe/{name}/dropped"] = dropped_set(cfg, p, x, data, model)


def dropped_set(cfg, p, x, data, model):
    """Sorted flat (token * k + slot) ids of the assignments the EP body
    drops, over every (data, model) shard."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_pad = -(-e // model) * model
    e_loc = e_pad // model
    bl = b // data
    cap_loc = max(int(bl * s * k / e * cfg.capacity_factor), 1)
    router = jnp.pad(p["router"], [(0, 0), (0, e_pad - e)])
    out = []
    for di in range(data):
        xf = jnp.asarray(x[di * bl:(di + 1) * bl]).reshape(bl * s, d)
        logits = jnp.einsum("nd,de->ne", xf.astype(jnp.float32), router)
        logits = jnp.where(jnp.arange(e_pad) < e, logits, -jnp.inf)
        probs = jax.nn.softmax(logits, axis=-1)
        _, top_ids = jax.lax.top_k(probs, k)
        ids = np.asarray(top_ids).reshape(-1)
        for r in range(model):
            lo = r * e_loc
            mine = (ids >= lo) & (ids < lo + e_loc)
            le = np.where(mine, ids - lo, 0)
            oh = np.eye(e_loc, dtype=np.int64)[le] * mine[:, None]
            pos = (np.cumsum(oh, 0) - oh)[np.arange(ids.size), le]
            drop = np.nonzero(mine & (pos >= cap_loc))[0]
            out.append(drop + di * bl * s * k)
    return np.sort(np.concatenate(out)).astype(np.int64)


def wire_cases(out):
    """``wire_quantized_psum`` on (4, 1): decoded sums without a key and
    with one, the draws behind the key, and the codes by the reference's
    formula."""
    m = mesh(4, 1)
    grads = mc.wire_grads()
    names = sorted(grads)
    for bits in mc.WIRE_BITS:
        for keyed in (False, True):
            @partial(jax.shard_map, mesh=m, in_specs=(P("data"),),
                     out_specs=(P("data"), P("data"), P("data")),
                     check_vma=False)
            def body(g):
                g = {n: v[0] for n, v in g.items()}
                key = None
                if keyed:
                    key = jax.random.fold_in(jax.random.PRNGKey(mc.WIRE_KEY),
                                             jax.lax.axis_index("data"))
                dec = wire_quantized_psum(g, "data", bits=bits, key=key)
                qmax = (1 << (bits - 1)) - 1
                keys = (jax.random.split(key, len(names)) if keyed
                        else [None] * len(names))
                draws, codes = {}, {}
                for n, kk in zip(names, keys):
                    gf = g[n].astype(jnp.float32)
                    scale = jnp.maximum(
                        jax.lax.pmax(jnp.abs(gf).max(), "data"), 1e-30)
                    dith = (jax.random.uniform(kk, gf.shape, minval=-0.5,
                                               maxval=0.5)
                            if kk is not None else jnp.zeros_like(gf))
                    draws[n] = dith
                    codes[n] = jnp.clip(jnp.round(gf / scale * qmax + dith),
                                        -qmax, qmax)
                return ({n: v[None] for n, v in dec.items()},
                        {n: v[None] for n, v in draws.items()},
                        {n: v[None] for n, v in codes.items()})

            dec, draws, codes = jax.jit(body)(grads)
            tag = f"wire/{bits}/{'key' if keyed else 'none'}"
            for n in names:
                out[f"{tag}/dec/{n}"] = np.asarray(dec[n])
                out[f"{tag}/codes/{n}"] = np.asarray(codes[n])
                if keyed:
                    out[f"{tag}/draws/{n}"] = np.asarray(draws[n])


def wire_step_case(out):
    """``make_wire_train_step`` on (4, 1): qwen3-4b smoke float32, remat
    None, ``mc.STEP_STEPS`` steps; the losses, grad norms, final
    parameters, and every step's and rank's dither draws."""
    cfg = mc.step_config(get_config)
    opt_cfg = ref_adamw.AdamWConfig(**mc.STEP_OPT)
    m = mesh(4, 1)
    state = build_state(cfg, opt_cfg, seed=mc.STEP_SEED)
    params, opt = state["params"], state["opt"]
    for k, v in flatten_pytree(np_tree(params)).items():
        out[f"step/init/{k}"] = v
    pspecs = param_pspecs(cfg, m)
    step = jax.jit(make_wire_train_step(cfg, opt_cfg, m, pspecs, bits=mc.STEP_BITS,
                                        remat=None,
                                        rules=single_pod_rules()))
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    paths = ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in leaves]
    for i in range(mc.STEP_STEPS):
        batch = mc.step_batch(cfg, i)
        for r in range(4):
            key = jax.random.fold_in(jax.random.PRNGKey(0), i * 4 + r)
            keys = jax.random.split(key, len(leaves))
            for path, kk, (_, leaf) in zip(paths, keys, leaves):
                out[f"step/draws/{i}/{r}/{path}"] = np.asarray(
                    jax.random.uniform(kk, leaf.shape, minval=-0.5,
                                       maxval=0.5))
        params, opt, met = step(params, opt, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
        out[f"step/loss/{i}"] = np.asarray(met["loss"])
        out[f"step/grad_norm/{i}"] = np.asarray(met["grad_norm"])
    for k, v in flatten_pytree(np_tree(params)).items():
        out[f"step/final/{k}"] = v


def attention_case(out):
    """Hymba-like attention (25 / 5 heads) under a (1, 4) mesh, heads
    padded to 6 x 6, and without a mesh."""
    cfg = mc.attn_config(get_config)
    p = init_attention(jax.random.PRNGKey(mc.ATTN_SEED), cfg, jnp.float32)
    x = mc.attn_input()
    pos = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])
    f = jax.jit(lambda p, x: attention_train(p, cfg, x, pos))
    with logical_sharding(mesh(1, 4), single_pod_rules()):
        out["attn/padded"] = np.asarray(f(p, x))
    out["attn/plain"] = np.asarray(jax.jit(
        lambda p, x: attention_train(p, cfg, x, pos))(p, x))
    for k, v in np_tree(p).items():
        out[f"attn/p/{k}"] = v


def jax_leaves(tree) -> dict:
    """{"/"-joined path: array} of a pytree of jax arrays (the keys of
    ``flatten_pytree``), the arrays left placed."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v for path, v in leaves}


def shards_by_coordinate(m, arr) -> dict:
    """{(data index, model index): this device's shard} of a placed array."""
    out = {}
    for sh in arr.addressable_shards:
        di, mi = (int(i) for i in np.argwhere(m.devices == sh.device)[0])
        out[(di, mi)] = np.asarray(sh.data)
    return out


def tp_cases(out, cases=mc.TP_CASES):
    """Each regime of ``cases`` on (1, 4) and (2, 2): ``prefill`` and
    ``decode_step`` jitted with ``in_shardings`` from ``param_pspecs`` /
    ``cache_pspecs`` under ``logical_sharding``; the logits of the prefill
    and of each decode step (fed the case's tokens), and every parameter
    and prefill-cache leaf's shard at each device's mesh coordinate."""
    for name, (_, _, b, s, t) in cases.items():
        cfg = mc.tp_config(get_config, name)
        params = np_tree(init_params(cfg, jax.random.PRNGKey(mc.TP_SEED)))
        for k, v in flatten_pytree(params).items():
            out[f"tp/{name}/p/{k}"] = v
        tok, fe = mc.tp_inputs(cfg, name)
        for shape in mc.TP_MESHES:
            m = mesh(*shape)
            tag = f"tp/{name}/{shape[0]}x{shape[1]}"
            with logical_sharding(m, single_pod_rules()):
                p_sh = to_named(m, param_pspecs(cfg, m))
                c_sh = to_named(m, cache_pspecs(cfg, m, b, t))
                tok_sh = NamedSharding(m, batch_spec(m, b, 2))
                args = (params, tok[:, :s])
                shard = (p_sh, tok_sh)
                if fe is not None:
                    args += (fe,)
                    shard += (NamedSharding(m, batch_spec(m, b, 3)),)
                pf = jax.jit(lambda p, x, *f: prefill(
                    cfg, p, x, f[0] if f else None, max_len=t),
                    in_shardings=shard)
                logits, cache = pf(*args)
                cache = jax.device_put(cache, c_sh)
                out[f"{tag}/logits/prefill"] = np.asarray(logits)
                placed = jax.device_put(params, p_sh)
                for kind, tree in (("p", placed), ("c", cache)):
                    for k, v in jax_leaves(tree).items():
                        for (di, mi), a in shards_by_coordinate(m, v).items():
                            out[f"{tag}/{kind}shard/{k}/{di}{mi}"] = a
                dec = jax.jit(lambda p, x, c: decode_step(cfg, p, x, c),
                              in_shardings=(p_sh, NamedSharding(
                                  m, batch_spec(m, b, 1)), c_sh))
                for i in range(mc.TP_DECODE_STEPS):
                    logits, cache = dec(params, tok[:, s + i], cache)
                    cache = jax.device_put(cache, c_sh)
                    out[f"{tag}/logits/decode{i}"] = np.asarray(logits)


def main():
    assert jax.device_count() == 4, jax.devices()
    out = {}
    if sys.argv[1] == "--mla":
        tp_cases(out, mc.TP_MLA_CASES)
        np.savez(sys.argv[2], **out)
        return
    path, ckpt_dir = sys.argv[1], sys.argv[2]
    moe_cases(out)
    wire_cases(out)
    wire_step_case(out)
    attention_case(out)
    tp_cases(out)
    cfg = mc.step_config(get_config)
    state = build_state(cfg, ref_adamw.AdamWConfig(), seed=mc.CKPT_SEED)
    save_checkpoint(ckpt_dir, 3, state)
    np.savez(path, **out)


if __name__ == "__main__":
    main()
