"""The port's side of ``tests/test_torch_mesh_spmd.py``: one function run
by each of 4 CPU ranks (``torch.multiprocessing.spawn``, gloo through a
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


def tp_cases(ref, out, rank):
    """Each regime of ``mc.TP_CASES`` on (1, 4) and (2, 2) from the
    reference's weights: this rank's parameter shards
    (``lm_shards_from_arrays``), the prefill and decode steps through
    ``make_prefill_step`` / ``make_decode_step`` (logits gathered whole),
    and the prefill cache's local leaves."""
    for name, (_, _, b, s, t) in mc.TP_CASES.items():
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
            for i, layer in enumerate(zeros["layers"]):
                for k, v in layer.items():
                    out[f"{tag}/zeros/layers/{i}/{k}"] = np.array(v.shape)
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
                for i, layer in enumerate(cache["layers"]):
                    for k, v in layer.items():
                        out[f"{tag}/cache/layers/{i}/{k}"] = v.numpy().copy()
                for i in range(mc.TP_DECODE_STEPS):
                    logits, cache = decode(params, tok[:, s + i], cache)
                    out[f"{tag}/logits/decode{i}"] = steps.whole_logits(
                        cfg, logits, b).numpy()


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
    """{path: DTensor} of a nested dict of DTensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_pytree_dt(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


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
        checkpoint_cases(out, rank, os.path.join(out_dir, "port_ckpt"),
                         ckpt_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
