"""The port's side of ``tests/test_torch_mesh_spmd.py`` (``run``) and of
``tests/test_torch_mesh_mla.py`` (``run_mla``): one function run by each
of 4 CPU ranks (``torch.multiprocessing.spawn``, gloo through a
``file://`` rendezvous).  Each rank runs every case and writes what it
got to ``rank<r>.npz``; the test asserts.  Imports no JAX."""
import os

import numpy as np
import torch
import torch.distributed as dist

import mesh_cases as mc
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_arrays, lm_shards_from_arrays
from repro_torch.core.tensor_codec import unflatten_pytree
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.shardings import (
    init_cache_shards,
    local_shard,
    opt_pspecs,
    param_pspecs,
    reference_pspecs,
    to_named,
)
from repro_torch.launch.train import build_state
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import reference_path
from repro_torch.models.sharding import (
    PartitionSpec,
    all_gather,
    collective_timing,
    logical_sharding,
    pmax,
    single_pod_rules,
)
from repro_torch.optim import compression
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

CPU = torch.device("cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def moe_cases(ref, out, rank):
    """Each case's EP output and aux on this rank, and the (token, slot)
    ids this rank drops.  Each rank gets its data shard's rows and the
    expert weights ``param_pspecs`` gives it (its experts where they
    divide the model axis, else all of them); the output is gathered
    back over ``data``."""
    x = _t(mc.moe_input())
    for name, (data, model, n_experts) in mc.MOE_CASES.items():
        cfg = mc.moe_config(get_config, n_experts)
        mesh = make_host_mesh(data, model, device="cpu")
        specs = param_pspecs(cfg, mesh)
        p = moe_mod.MoE(cfg, torch.float32, CPU)
        for k in ("router", "w1", "w3", "w2"):
            whole = _t(ref[f"moe/{name}/p/{k}"])
            spec = specs[f"layers.0.mlp.{k}"]
            # the expert dim only: ``_moe_apply_ep`` takes whole d_model
            # rows (the block gathers a d_model cut over data before it)
            spec = PartitionSpec(spec[0], *[None] * (len(spec) - 1))
            setattr(p, k, torch.nn.Parameter(
                local_shard(whole, spec, mesh).clone(), requires_grad=False))
        b, s, d = x.shape
        di = mesh.get_local_rank("data")
        bl = b // data
        xb = x[di * bl:(di + 1) * bl]
        with logical_sharding(mesh, single_pod_rules()):
            y, aux = moe_mod._moe_apply_ep(p, cfg, xb, mesh)
            y = all_gather(y, "data", dim=0, mesh=mesh)
            e_pad, e_loc, cap = moe_mod._ep_layout(cfg, bl, s, mesh)
            mi = mesh.get_local_rank("model")
            router = torch.nn.functional.pad(p.router,
                                             (0, e_pad - cfg.n_experts))
            _, _, mine, keep, _ = moe_mod._ep_route(
                cfg, xb.reshape(-1, d), router, e_pad, mi * e_loc, e_loc,
                cap)
            # the whole activation and whole experts on every rank
            whole = moe_mod.MoE(cfg, torch.float32, CPU)
            for k in ("router", "w1", "w3", "w2"):
                getattr(whole, k).copy_(_t(ref[f"moe/{name}/p/{k}"]))
            yw, auxw = moe_mod.moe_apply(whole, cfg, x)
        drop = torch.nonzero(mine & ~keep)[:, 0].numpy() + di * bl * s * cfg.top_k
        out[f"moe/{name}/whole"] = yw.numpy()
        out[f"moe/{name}/whole_aux"] = auxw.numpy()
        out[f"moe/{name}/out"] = y.numpy()
        out[f"moe/{name}/aux"] = aux.numpy()
        out[f"moe/{name}/dropped"] = drop.astype(np.int64)


def wire_cases(ref, out, rank):
    """``wire_quantized_psum`` on (4, 1): without a key, with the
    reference's draws, and the mean of ``WIRE_GEN_DRAWS`` Generator-dithered
    sums; the codes by ``_wire_codes``."""
    mesh = make_host_mesh(4, 1, device="cpu")
    grads = {n: _t(g[rank]) for n, g in mc.wire_grads().items()}
    for bits in mc.WIRE_BITS:
        qmax = (1 << (bits - 1)) - 1
        for keyed in (False, True):
            tag = f"wire/{bits}/{'key' if keyed else 'none'}"
            draws = ({n: _t(ref[f"{tag}/draws/{n}"][rank]) for n in grads}
                     if keyed else None)
            dec = compression.wire_quantized_psum(
                grads, "data", bits=bits, dither=draws, mesh=mesh)
            for n, g in grads.items():
                out[f"{tag}/dec/{n}"] = dec[n].numpy()
                scale = torch.clamp(pmax(g.abs().max(), "data", mesh),
                                    min=1e-30)
                d = draws[n] if keyed else None
                out[f"{tag}/codes/{n}"] = compression._wire_codes(
                    g, scale, qmax, torch.int16, d).numpy()
        acc = {n: torch.zeros_like(g, dtype=torch.float64)
               for n, g in grads.items()}
        for i in range(mc.WIRE_GEN_DRAWS):
            gen = torch.Generator().manual_seed(1000 * i + rank)
            dec = compression.wire_quantized_psum(grads, "data", bits=bits,
                                                  key=gen, mesh=mesh)
            for n in acc:
                acc[n] += dec[n].double()
        for n, a in acc.items():
            out[f"wire/{bits}/gen_mean/{n}"] = (a / mc.WIRE_GEN_DRAWS).numpy()


def _unstack(flat_ref: dict, prefix: str, names) -> dict:
    """{port name: its slice of the reference's flat leaf under prefix}."""
    out = {}
    for n in names:
        path, index = reference_path(n)
        a = flat_ref[f"{prefix}{path}"]
        out[n] = _t(a if index is None else a[index])
    return out


def wire_step_case(ref, out, rank):
    """``make_wire_train_step`` on (4, 1) from the reference's initial
    parameters with its dither draws; the near-boundary code count
    (``margins``) of every step, the losses, grad norms and this rank's
    final shards gathered back."""
    cfg = mc.step_config(get_config)
    mesh = make_host_mesh(4, 1, device="cpu")
    init = {k.removeprefix("step/init/"): ref[k] for k in ref.files
            if k.startswith("step/init/")}
    lm = lm_params_from_arrays(cfg, unflatten_pytree(init), device="cpu")
    names = [n for n, _ in lm.named_parameters()]
    pspecs = param_pspecs(cfg, mesh)
    dims = {}
    for n, spec in pspecs.items():
        dims[n] = next((i for i, a in enumerate(spec) if a == "data"), None)
    shards = {}
    for n, p in lm.named_parameters():
        dim = dims[n]
        if dim is None:
            shards[n] = p.detach().clone()
        else:
            k = p.shape[dim] // 4
            shards[n] = p.detach().narrow(dim, rank * k, k).clone()
    opt = init_opt_state(shards)
    flat = {k: ref[k] for k in ref.files if k.startswith("step/draws/")}

    def dither(step, r):
        return _unstack(flat, f"step/draws/{step}/{r}/", names)

    margins = []
    orig = compression.wire_quantized_psum

    def counting(grads, axis, bits=4, key=None, n_ranks=None, *, dither=None,
                 mesh=None):
        """Counts the codes of non-zero gradients whose pre-round value
        lies within 1e-5 * qmax (a gradient gap of 1e-5 of the scale) of a
        rounding boundary.  An exact zero is zero in both packages."""
        qmax = (1 << (bits - 1)) - 1
        near = 0
        for members in compression._groups(grads).values():
            local = torch.stack([grads[m].abs().max() for m in members]).max()
            scale = torch.clamp(pmax(local, axis, mesh), min=1e-30)
            for m in members:
                t = grads[m] / scale * qmax + dither[m]
                edge = (t - t.floor() - 0.5).abs() < 1e-5 * qmax
                near += int((edge & (grads[m] != 0)).sum())
        margins.append(near)
        return orig(grads, axis, bits, key, n_ranks, dither=dither, mesh=mesh)

    compression.wire_quantized_psum = counting
    try:
        step = steps.make_wire_train_step(
            cfg, AdamWConfig(**mc.STEP_OPT), mesh, pspecs, bits=mc.STEP_BITS,
            remat=None, rules=single_pod_rules(), dither=dither)
    finally:
        compression.wire_quantized_psum = orig
    for i in range(mc.STEP_STEPS):
        batch = mc.step_batch(cfg, i)
        local = {k: _t(v[rank:rank + 1]) for k, v in batch.items()}
        shards, opt, met = step(shards, opt, local)
        out[f"step/loss/{i}"] = met["loss"].numpy()
        out[f"step/grad_norm/{i}"] = met["grad_norm"].numpy()
    out["step/margins"] = np.array(margins)
    for n, t in shards.items():
        out[f"step/shard/{n}"] = t.numpy()
        out[f"step/dim/{n}"] = np.array(-1 if dims[n] is None else dims[n])


def attention_case(ref, out, rank):
    """Hymba-like attention (25 / 5 heads) from the reference's weights,
    under the (1, 4) mesh (padded to 6 x 6) and without a mesh."""
    cfg = mc.attn_config(get_config)
    p = attn_mod.Attention(cfg, torch.float32, CPU)
    for k in ("wq", "wk", "wv", "wo"):
        getattr(p, k).copy_(_t(ref[f"attn/p/{k}"]))
    x = _t(mc.attn_input())
    pos = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
    mesh = make_host_mesh(1, 4, device="cpu")
    with logical_sharding(mesh, single_pod_rules()):
        out["attn/pads"] = np.array(attn_mod._head_padding(cfg))
        out["attn/padded"] = attn_mod.attention_train(p, cfg, x, pos).numpy()
    out["attn/plain"] = attn_mod.attention_train(p, cfg, x, pos).numpy()


def tp_cases(ref, out, rank, cases=mc.TP_CASES):
    """Each regime of ``cases`` on (1, 4) and (2, 2) from the reference's
    weights: this rank's parameter shards (``lm_shards_from_arrays``), the
    prefill and decode steps through ``make_prefill_step`` /
    ``make_decode_step`` (logits gathered whole), and the prefill cache's
    local leaves (``layers`` and ``layers_dense``)."""
    for name, (_, _, b, s, t) in cases.items():
        cfg = mc.tp_config(get_config, name)
        pre = f"tp/{name}/p/"
        tree = unflatten_pytree({k.removeprefix(pre): ref[k]
                                 for k in ref.files if k.startswith(pre)})
        tok, fe = mc.tp_inputs(cfg, name)
        prefill = steps.make_prefill_step(cfg)
        decode = steps.make_decode_step(cfg)
        for shape in mc.TP_MESHES:
            tag = f"tp/{name}/{shape[0]}x{shape[1]}"
            mesh = make_host_mesh(*shape, device="cpu")
            out[f"{tag}/coord"] = np.array([mesh.get_local_rank("data"),
                                            mesh.get_local_rank("model")])
            params = lm_shards_from_arrays(cfg, tree, mesh, device="cpu")
            for n, p in params.named_parameters():
                out[f"{tag}/local/{n}"] = p.numpy()
            zeros = init_cache_shards(cfg, b, t, mesh, device="cpu")
            out[f"{tag}/zeros/pos"] = np.array(zeros["pos"].shape)
            for key, i, k, v in cache_leaves(zeros):
                out[f"{tag}/zeros/{key}/{i}/{k}"] = np.array(v.shape)
            with logical_sharding(mesh, single_pod_rules()):
                with collective_timing() as times:
                    logits, cache = prefill(params, tok[:, :s], fe,
                                            max_len=t)
                for kind, row in times.items():
                    out[f"{tag}/coll/{kind}"] = np.array(
                        [row["calls"], row["bytes"], row["s"] > 0])
                out[f"{tag}/logits/prefill"] = steps.whole_logits(
                    cfg, logits, b).numpy()
                out[f"{tag}/cache/pos"] = cache["pos"].numpy()
                for key, i, k, v in cache_leaves(cache):
                    out[f"{tag}/cache/{key}/{i}/{k}"] = v.numpy().copy()
                for i in range(mc.TP_DECODE_STEPS):
                    logits, cache = decode(params, tok[:, s + i], cache)
                    out[f"{tag}/logits/decode{i}"] = steps.whole_logits(
                        cfg, logits, b).numpy()


def cache_leaves(cache):
    """(key, layer, leaf path, tensor) of every leaf of a decode cache's
    ``layers`` and ``layers_dense``."""
    for key in ("layers", "layers_dense"):
        for i, layer in enumerate(cache.get(key, [])):
            for k, v in flatten_pytree_dt(layer).items():
                yield key, i, k, v


@torch.no_grad()
def mla_alone_case(out, rank):
    """dsv3's MLA alone on (1, 4) and (2, 2), from seeded whole weights,
    with its latent cache cut along time and whole (``mc.MLA_CACHES``):
    this rank's ``mla_prefill_tp`` on its rows' sequence slice and its
    ``mla_decode_tp`` steps at positions S, S + 1, S + 2, each partial
    summed over ``model``, beside the one-process ``mla_prefill`` /
    ``mla_decode`` of the same rows; its cache slice after the prefill and
    after each step, the slots of its slice each step changed, and its
    slice's first slot."""
    from repro_torch.models import mla
    from repro_torch.models.sharding import logical_sizes, psum
    from repro_torch.models.tensor_parallel import tp_layout

    cfg = mc.tp_config(get_config, "dsv3")
    gen = torch.Generator().manual_seed(mc.MLA_SEED)
    whole = mla.init_mla(mla.MLA(cfg, torch.float32, CPU), cfg, gen)
    rng = np.random.default_rng(mc.MLA_SEED)
    x = _t(rng.normal(size=mc.MLA_X_SHAPE).astype(np.float32))
    b, s, _ = x.shape
    steps_ = [_t(rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32))
              for _ in range(mc.TP_DECODE_STEPS)]
    pos = torch.arange(s)[None].expand(b, -1)
    for shape in mc.TP_MESHES:
        mesh = make_host_mesh(*shape, device="cpu")
        specs = param_pspecs(cfg, mesh)
        local = mla.MLA(cfg, torch.float32, CPU)
        for k, p in whole.named_parameters():
            # the model axis only: the block gathers a d_model cut over
            # data before its attention
            spec = specs[f"layers_dense.0.attn.{k}"]
            spec = PartitionSpec(*[a if a == "model" else None for a in spec])
            setattr(local, k, torch.nn.Parameter(
                local_shard(p.detach(), spec, mesh).clone(),
                requires_grad=False))
        for kind, max_len in mc.MLA_CACHES.items():
            tag = f"mla/{shape[0]}x{shape[1]}/{kind}"
            L = tp_layout(cfg, mesh, b, s)
            rows = x[L.rows]
            with logical_sharding(mesh, single_pod_rules()), \
                    logical_sizes(L.sizes(cfg)):
                part, cache = mla.mla_prefill_tp(
                    local, cfg, L, rows[:, L.s_lo:L.s_lo + L.s_loc],
                    pos[L.rows], max_len)
                out[f"{tag}/prefill/sum"] = psum(part, "model",
                                                 mesh=mesh).numpy()
            want, one = mla.mla_prefill(whole, cfg, rows, pos[L.rows],
                                        max_len)
            out[f"{tag}/prefill/want"] = want.numpy()
            lo, t = mla._time_cut(L, max_len)
            out[f"{tag}/lo"] = np.array(lo)
            out[f"{tag}/one/prefill"] = one["c_kv"].numpy().copy()
            out[f"{tag}/cache/prefill"] = cache["c_kv"].numpy().copy()
            Ld = tp_layout(cfg, mesh, b, 1)
            for i, xd in enumerate(steps_):
                position = torch.full((Ld.rows.stop - Ld.rows.start,), s + i,
                                      dtype=torch.int32)
                before = cache["c_kv"].clone()
                with logical_sharding(mesh, single_pod_rules()), \
                        logical_sizes(Ld.sizes(cfg)):
                    part, cache = mla.mla_decode_tp(local, cfg, Ld,
                                                    xd[Ld.rows], cache,
                                                    position, max_len)
                    out[f"{tag}/decode{i}/sum"] = psum(part, "model",
                                                       mesh=mesh).numpy()
                want, one = mla.mla_decode(whole, cfg, xd[Ld.rows], one,
                                           position)
                out[f"{tag}/decode{i}/want"] = want.numpy()
                changed = (cache["c_kv"] != before).any(-1).any(0)
                out[f"{tag}/decode{i}/changed"] = torch.nonzero(
                    changed)[:, 0].numpy()
                out[f"{tag}/one/decode{i}"] = one["c_kv"].numpy().copy()
                out[f"{tag}/cache/decode{i}"] = cache["c_kv"].numpy().copy()


def straddle_case(out, rank):
    """hymba_padded's attention alone on (1, 4) and (2, 2), from seeded
    whole weights: this rank's padded heads over the KV heads they read
    (straddling groups; plain route) and its float32 partial summed over
    ``model``, each way of redistributing ``wq`` / ``wo`` (the weights,
    the products), beside the one-process padded attention under the
    same mesh (its heads' slice, its output)."""
    import dataclasses

    from repro_torch.models.sharding import psum
    from repro_torch.models.tensor_parallel import tp_layout

    cfg = mc.tp_config(get_config, mc.STRADDLE_CASE)
    gen = torch.Generator().manual_seed(mc.ATTN_SEED)
    whole = attn_mod.Attention(cfg, torch.float32, CPU)
    attn_mod.init_attention(whole, cfg, gen)
    x = torch.from_numpy(np.random.default_rng(mc.ATTN_SEED).normal(
        size=mc.STRADDLE_X_SHAPE).astype(np.float32))
    b, s, _ = x.shape
    pos = torch.arange(s)[None].expand(b, -1)
    for shape in mc.TP_MESHES:
        mesh = make_host_mesh(*shape, device="cpu")
        specs = param_pspecs(cfg, mesh)
        local = attn_mod.Attention(cfg, torch.float32, CPU)
        for k in ("wq", "wk", "wv", "wo"):
            spec = specs[f"layers.0.attn.{k}"]
            # the model axis only: the block gathers a d_model cut over
            # data before its attention
            spec = PartitionSpec(*[a if a == "model" else None for a in spec])
            setattr(local, k, torch.nn.Parameter(
                local_shard(getattr(whole, k), spec, mesh).clone(),
                requires_grad=False))
        tag = f"straddle/{shape[0]}x{shape[1]}"
        with logical_sharding(mesh, single_pod_rules()):
            q, k, v = attn_mod._project_qkv(whole, cfg, x, pos)
            q, k, v, pads = attn_mod._shard_qkv(cfg, q, k, v)
            heads = attn_mod._attend_full(q, k, v, cfg, False)
            out[f"{tag}/one/out"] = attn_mod.attention_train(
                whole, cfg, x, pos).numpy()
            L = tp_layout(cfg, mesh, b, s)
            out[f"{tag}/one/heads"] = heads[:, :, L.h_lo:L.h_lo
                                            + L.h_loc].numpy()
            out[f"{tag}/pads"] = np.array(pads)
            for mode in (True, False):
                Lm = dataclasses.replace(L, move_weights=mode)
                q, k, v = attn_mod._project_qkv_padded(local, cfg, Lm, x,
                                                       pos)
                kq, rep = attn_mod._local_kv(cfg, Lm, k)
                vq, _ = attn_mod._local_kv(cfg, Lm, v)
                got = attn_mod._attend_full(q, kq, vq, cfg, False)
                name = "weights" if mode else "products"
                out[f"{tag}/{name}/heads"] = got.numpy()
                out[f"{tag}/{name}/n_rep"] = np.array(rep)
                out[f"{tag}/{name}/out"] = psum(
                    attn_mod._padded_out(local, cfg, Lm, got), "model",
                    mesh=mesh).numpy()


def _specs_tree(cfg, mesh):
    """The shardings of a train state's checkpoint tree."""
    pspecs = param_pspecs(cfg, mesh)
    opt = opt_pspecs(cfg, mesh, pspecs)
    return to_named(mesh, {
        "params": reference_pspecs(pspecs),
        "opt": {"m": reference_pspecs(opt["m"]),
                "v": reference_pspecs(opt["v"]), "step": PartitionSpec()},
    })


def checkpoint_cases(out, rank, port_dir, ref_dir):
    """The port's own checkpoint and the reference's, each loaded onto
    (4, 1) by ``load_checkpoint(shardings=...)``: every leaf's local shard
    shape, and its full tensor."""
    cfg = mc.step_config(get_config)
    mesh = make_host_mesh(4, 1, device="cpu")
    if rank == 0:
        state = build_state(cfg, AdamWConfig(), mc.CKPT_SEED, device="cpu")
        save_checkpoint(port_dir, 2, state, device="cpu")
    dist.barrier()
    shardings = _specs_tree(cfg, mesh)
    for tag, d in (("port", port_dir), ("ref", ref_dir)):
        state, step = load_checkpoint(d, shardings=shardings, device="cpu")
        out[f"ckpt/{tag}/step"] = np.array(step)
        flat = flatten_pytree_dt(state)
        for k, t in flat.items():
            out[f"ckpt/{tag}/local/{k}"] = np.array(t.to_local().shape)
            full = t.full_tensor()
            if full.dtype == torch.bfloat16:
                full = full.view(torch.int16)
            out[f"ckpt/{tag}/full/{k}"] = full.numpy()


def flatten_pytree_dt(tree, prefix=""):
    """{path: leaf} of a nested dict (of DTensors, or tensors)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_pytree_dt(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def run_mla(rank, init_file, ref_path, out_dir):
    """``test_torch_mesh_mla.py``'s rank: ``mc.TP_MLA_CASES`` against the
    reference's ``--mla`` outputs, then MLA alone."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=4)
    try:
        out = {}
        tp_cases(np.load(ref_path), out, rank, mc.TP_MLA_CASES)
        mla_alone_case(out, rank)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run(rank, init_file, ref_path, out_dir, ckpt_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=4)
    try:
        ref = np.load(ref_path)
        out = {}
        moe_cases(ref, out, rank)
        wire_cases(ref, out, rank)
        wire_step_case(ref, out, rank)
        attention_case(ref, out, rank)
        tp_cases(ref, out, rank)
        straddle_case(out, rank)
        checkpoint_cases(out, rank, os.path.join(out_dir, "port_ckpt"),
                         ckpt_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
