"""The port's side of ``tests/test_torch_mesh_train.py`` and
``tests/test_torch_mesh_train_families.py``: one function run by each of
4 CPU ranks (``torch.multiprocessing.spawn``, gloo through a ``file://``
rendezvous, each collective under a timeout).  Each rank runs every case
of its suite (``"base"``: ``mesh_cases.TRAIN_CASES``; ``"families"``:
``TRAIN_FAMILY_CASES``) and writes what it got to ``rank<r>.npz``; the
test asserts.  Imports no JAX."""
import contextlib
import dataclasses
import datetime
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

import mesh_cases as mc
from repro_torch.checkpoint import (
    CheckpointConfig,
    CheckpointManager,
    load_checkpoint,
)
from repro_torch.configs import get_config
from repro_torch.convert import (
    lm_params_from_arrays,
    lm_shards_from_arrays,
    train_state_shards_from_arrays,
)
from repro_torch.core.tensor_codec import flatten_pytree, unflatten_pytree
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.shardings import (
    gather_whole,
    local_shard,
    opt_pspecs,
    param_pspecs,
    reference_pspecs,
    shard_train_state,
    to_named,
)
from repro_torch.models import (
    TransformerLM,
    forward,
    init_leaves,
    init_params,
    loss_fn,
)
from repro_torch.models.model import reference_path
from repro_torch.models.sharding import (
    PartitionSpec,
    all_gather,
    axis_index,
    collective_timing,
    logical_sharding,
    psum,
    psum_grad,
    psum_scatter,
    single_pod_rules,
)
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime.fault_tolerance import PreemptionSchedule, TrainLoop

#: a rank stuck in a collective (ranks issuing different collectives)
#: raises after this long, so the test fails instead of hanging
TIMEOUT_S = 240


def _bounds(shape, spec, mesh) -> list[tuple[int, int]]:
    """Per dim (lo, hi) of this rank's shard of a ``shape`` leaf."""
    out = []
    for n, axis in zip(shape, spec):
        if axis is None:
            out.append((0, n))
            continue
        k = n // mesh.size(mesh.mesh_dim_names.index(axis))
        i = axis_index(axis, mesh)
        out.append((i * k, (i + 1) * k))
    return out


def _one_process(cfg, init, name, remat):
    """The port's own one-process first step of the case: (its loss and
    grad norm, its gradients, the parameters and the moments after it),
    whole."""
    lm = lm_params_from_arrays(cfg, init, device="cpu")
    batch = mc.train_batch(cfg, name, 0, mc.train_cases(name))
    _, grads = steps.loss_and_grads(cfg, lm, batch, remat=remat)
    step = steps.make_train_step(cfg, AdamWConfig(**mc.TRAIN_OPT),
                                 remat=remat)
    lm, opt, met = step(lm, init_opt_state(lm), batch)
    return (float(met["loss"]), float(met["grad_norm"]), grads,
            dict(lm.named_parameters()), opt["m"], opt["v"])


@contextlib.contextmanager
def float64_arithmetic():
    """The port's float32 arithmetic carried out in float64 inside:
    ``torch.float32`` and ``Tensor.float`` name float64, so the explicit
    float32 casts of the WKV, the norms and the products widen instead.
    What a float32 computation of the same step rounds: the witness of
    the float32 gaps (``mesh_cases.TRAIN_FAMILY_F32_GAPS``), not a route
    of the port."""
    f32, flt = torch.float32, torch.Tensor.float
    torch.float32, torch.Tensor.float = torch.float64, torch.Tensor.double
    try:
        yield
    finally:
        torch.float32, torch.Tensor.float = f32, flt


def _witness(cfg, name, i, params, opt, mesh, cases, remat, out):
    """Step ``i`` of the case in float64 on one process
    (``float64_arithmetic``) from the state this rank's shards hold before
    it (the reference's, ``_anchor``), gathered whole: its loss and grad
    norm, and this rank's slices of its gradients and moments, under
    ``{name}/f64/``."""
    specs = params.pspecs
    whole = {n: gather_whole(p.detach(), specs[n], mesh)
             for n, p in params.named_parameters()}
    mv = {k: {n: gather_whole(opt[k][n], specs[n], mesh) for n in whole}
          for k in ("m", "v")}
    with float64_arithmetic():
        wide = dataclasses.replace(cfg, dtype="float64")
        lm = TransformerLM(wide, "cpu")
        with torch.no_grad():
            for n, p in lm.named_parameters():
                p.copy_(whole[n])
        state = {k: {n: t.double() for n, t in mv[k].items()}
                 for k in ("m", "v")}
        state["step"] = torch.tensor(i, dtype=torch.int32)
        batch = mc.train_batch(cfg, name, i, cases)
        _, grads = steps.loss_and_grads(wide, lm, batch, remat=remat)
        step = steps.make_train_step(wide, AdamWConfig(**mc.TRAIN_OPT),
                                     remat=remat)
        _, state, met = step(lm, state, batch)
    out[f"{name}/f64/loss/{i}"] = met["loss"].numpy()
    out[f"{name}/f64/grad_norm/{i}"] = met["grad_norm"].numpy()
    for n, g in grads.items():
        for kind, t in (("g", g), ("m", state["m"][n]),
                        ("v", state["v"][n])):
            out[f"{name}/f64/{kind}/{i}/{n}"] = local_shard(
                t, specs[n], mesh).numpy()


@torch.no_grad()
def _anchor(ref, index, name, i, params, opt, mesh):
    """This rank's state set to the reference's after step ``i``: each
    parameter, ``m`` and ``v`` shard from its shard at the same place, so
    the next step is held from the same state (Adam's normalized first
    step amplifies the last bits of a near-zero gradient; compounded over
    steps they would spread through the whole model)."""
    for n, p in params.named_parameters():
        path, block = reference_path(n)
        key = mc.shard_key(_bounds(_whole_shape(params.cfg, n),
                                   params.pspecs[n], mesh))
        for kind, t in (("p", p), ("m", opt["m"][n]), ("v", opt["v"][n])):
            a = mc.ref_shard(ref, index, f"{name}/{kind}/{i}", path, block,
                             key)
            if kind != "p" and t.dtype != torch.float32:
                opt[kind][n] = t = torch.empty(a.shape, dtype=torch.float32)
            t.copy_(torch.from_numpy(np.asarray(a)))


def train_case(ref, index, out, name, one_process):
    """The case's steps on this rank from the reference's seeded
    parameters: each step's
    ``loss_and_grads`` then ``make_train_step``, a step after the first
    starting from the reference's state after the one before
    (``_anchor``); the losses, grad norms, every gradient shard, the
    parameter / m / v shards after each step and each leaf's place.  With
    ``one_process``, this rank's slices of the port's one-process first
    step.  A case of ``mesh_cases.TRAIN_FAMILY_MTP`` first takes
    ``mtp_loss``'s value and gradient shards at the seeded shards; one
    of ``TRAIN_FAMILY_F32_GAPS`` each step's float64 witness
    (``_witness``)."""
    cases = mc.train_cases(name)
    regime, shape, b, s, remat = cases[name]
    cfg = mc.train_config(get_config, name, cases)
    mesh = make_host_mesh(*shape, device="cpu")
    pre = f"{name}/init/"
    init = unflatten_pytree({k.removeprefix(pre): ref[k]
                             for k in ref.files if k.startswith(pre)})
    params = lm_shards_from_arrays(cfg, init, mesh, device="cpu")
    opt = init_opt_state(params)
    step = steps.make_train_step(cfg, AdamWConfig(**mc.TRAIN_OPT),
                                 remat=remat)
    out[f"{name}/coord"] = np.array([mesh.get_local_rank("data"),
                                     mesh.get_local_rank("model")])
    with logical_sharding(mesh, single_pod_rules()):
        if name in mc.TRAIN_FAMILY_MTP:
            batch = dict(mc.train_batch(cfg, name, 0, cases),
                         labels_next2=mc.mtp_labels(cfg, name))
            loss, grads = steps.mtp_loss_and_grads(cfg, params, batch)
            out[f"{name}/mtp/loss"] = loss.detach().numpy()
            for n, g in grads.items():
                out[f"{name}/mtp/g/{n}"] = g.numpy()
        for i in range(mc.TRAIN_STEPS):
            if i:
                _anchor(ref, index, name, i - 1, params, opt, mesh)
            if name in mc.TRAIN_FAMILY_F32_GAPS:
                _witness(cfg, name, i, params, opt, mesh, cases, remat, out)
            batch = mc.train_batch(cfg, name, i, cases)
            loss, grads = steps.loss_and_grads(cfg, params, batch,
                                               remat=remat)
            out[f"{name}/loss/{i}"] = loss.detach().numpy()
            for n, g in grads.items():
                out[f"{name}/g/{i}/{n}"] = g.numpy()
            params, opt, met = step(params, opt, batch)
            out[f"{name}/step_loss/{i}"] = met["loss"].numpy()
            out[f"{name}/grad_norm/{i}"] = met["grad_norm"].numpy()
            out[f"{name}/lr/{i}"] = met["lr"].numpy()
            for n, p in params.named_parameters():
                out[f"{name}/p/{i}/{n}"] = p.numpy().copy()
                out[f"{name}/m/{i}/{n}"] = opt["m"][n].numpy().copy()
                out[f"{name}/v/{i}/{n}"] = opt["v"][n].numpy().copy()
    for n, p in params.named_parameters():
        out[f"{name}/key/{n}"] = np.array(mc.shard_key(
            _bounds(_whole_shape(cfg, n), params.pspecs[n], mesh)))
    if one_process:
        loss, norm, grads, final, m, v = _one_process(cfg, init, name,
                                                      remat)
        out[f"{name}/onep/loss"] = np.array(loss)
        out[f"{name}/onep/grad_norm"] = np.array(norm)
        for n, g in grads.items():
            for kind, t in (("g", g), ("p", final[n]), ("m", m[n]),
                            ("v", v[n])):
                out[f"{name}/onep/{kind}/{n}"] = local_shard(
                    t, params.pspecs[n], mesh).numpy()


_META: dict = {}


def _whole_shape(cfg, name) -> tuple[int, ...]:
    if cfg not in _META:
        _META[cfg] = {n: tuple(p.shape) for n, p in
                      TransformerLM(cfg, "meta").named_parameters()}
    return _META[cfg][name]


def collective_grads(out, rank):
    """The collectives' transposes on (1, 4): each rank's gradient of
    ``sum(c_r * f(x_r))`` for ``all_gather`` (``grad="sum"`` and
    ``"slice"``), ``psum_scatter``, ``psum`` and ``psum_grad``, with
    ``x_r`` and ``c_r`` drawn from the rank's seed."""
    mesh = make_host_mesh(1, 4, device="cpu")
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn(2, 3, generator=gen)
    c8 = torch.randn(8, 3, generator=gen)
    c2 = torch.randn(2, 3, generator=gen)
    out["coll/x"], out["coll/c8"], out["coll/c2"] = (
        x.numpy(), c8.numpy(), c2.numpy())
    big = torch.randn(8, 3, generator=gen)
    out["coll/big"] = big.numpy()
    cases = {
        "all_gather": (x, lambda t: all_gather(t, "model", 0, mesh=mesh),
                       c8),
        "all_gather_slice": (x, lambda t: all_gather(
            t, "model", 0, mesh=mesh, grad="slice"), c8),
        "psum_scatter": (big, lambda t: psum_scatter(t, "model", 0,
                                                     mesh=mesh), c2),
        "psum": (x, lambda t: psum(t, "model", mesh), c2),
        "psum_grad": (x, lambda t: psum_grad(t, "model", mesh), c2),
    }
    for name, (t, f, c) in cases.items():
        t = t.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((f(t) * c).sum(), t)
        out[f"coll/{name}"] = g.numpy()


def threaded_backward(out):
    """kv4 on (2, 2) under remat "full" inside ``collective_timing``, its
    backward run on another thread (as the card's autograd engine runs
    it): the gradients equal the same call's on this thread, and the
    backward's collectives (and the recompute's) are timed in the
    forward's table."""
    cfg = mc.tp_config(get_config, "kv4")
    mesh = make_host_mesh(2, 2, device="cpu")
    params = lm_shards_from_arrays(cfg, unflatten_pytree(flatten_pytree(
        init_params(cfg, mc.TRAIN_SEED, "cpu"))), mesh, device="cpu")
    batch = mc.train_batch(cfg, "kv4_2x2", 0)
    names, plist = zip(*params.named_parameters())
    res = {}
    for where in ("here", "thread"):
        params.requires_grad_(True)
        with logical_sharding(mesh, single_pod_rules()), \
                collective_timing() as times:
            loss = loss_fn(cfg, params, batch["tokens"],
                                 batch["labels"], remat="full")
            if where == "here":
                grads = torch.autograd.grad(loss, plist)
            else:
                box = {}
                th = threading.Thread(target=lambda: box.update(
                    g=torch.autograd.grad(loss, plist)))
                th.start()
                th.join()
                grads = box["g"]
        params.requires_grad_(False)
        res[where] = grads
        for kind, row in times.items():
            out[f"thread/{where}/{kind}"] = np.array([row["calls"],
                                                      row["bytes"]])
    out["thread/equal"] = np.array(all(
        torch.equal(a, b) for a, b in zip(res["here"], res["thread"])))


def flash_case(out):
    """``use_flash`` on sharded parameters (kv4 on (1, 4)): without grad,
    ``forward`` takes K7's wrapper (on the CPU its plain version) once a
    layer, its logits against the plain attention's; under autograd
    ``loss_and_grads`` raises ``KernelGradientError``, as it does on whole
    parameters."""
    from repro_torch.kernels import KernelGradientError
    from repro_torch.kernels.flash_attention import ops

    cfg = mc.tp_config(get_config, "kv4")
    mesh = make_host_mesh(1, 4, device="cpu")
    params = lm_shards_from_arrays(cfg, unflatten_pytree(flatten_pytree(
        init_params(cfg, mc.TRAIN_SEED, "cpu"))), mesh, device="cpu")
    batch = mc.train_batch(cfg, "kv4_2x2", 0)
    real, calls = ops.flash_attention, []

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    ops.flash_attention = spy
    try:
        with logical_sharding(mesh, single_pod_rules()), torch.no_grad():
            plain, _ = forward(cfg, params, batch["tokens"])
            n_plain = len(calls)
            flash, _ = forward(cfg, params, batch["tokens"], use_flash=True)
        out["flash/calls"] = np.array([n_plain, len(calls) - n_plain])
        out["flash/max_abs"] = np.array(float((flash - plain).abs().max()))
        try:
            with logical_sharding(mesh, single_pod_rules()):
                steps.loss_and_grads(cfg, params, batch, use_flash=True)
            out["flash/refused"] = np.array(False)
        except KernelGradientError:
            out["flash/refused"] = np.array(True)
    finally:
        ops.flash_attention = real


def family_flash_case(out):
    """``use_flash`` on the shards of the new families on (1, 4): RWKV6
    (K8 on each rank's heads, ``rwkv6_1x4``'s 64 tokens) and Hymba's
    padded heads (K7 with the window, ``hymba_padded``).  Without grad
    ``forward`` calls the kernel's wrapper once a layer (its CPU version
    here), against the plain route's logits; under autograd
    ``loss_and_grads`` raises ``KernelGradientError``."""
    from repro_torch.kernels import KernelGradientError
    from repro_torch.kernels.flash_attention import ops as k7
    from repro_torch.models import rwkv6

    mesh = make_host_mesh(1, 4, device="cpu")
    for name, owner, attr in (("rwkv6_1x4", rwkv6, "wkv6"),
                              ("hymba_padded", k7, "flash_attention")):
        cases = mc.train_cases(name)
        cfg = mc.train_config(get_config, name, cases)
        params = lm_shards_from_arrays(cfg, unflatten_pytree(flatten_pytree(
            init_params(cfg, mc.TRAIN_SEED, "cpu"))), mesh, device="cpu")
        batch = mc.train_batch(cfg, name, 0, cases)
        real, calls = getattr(owner, attr), []

        def spy(*a, real=real, **k):
            calls.append(1)
            return real(*a, **k)

        setattr(owner, attr, spy)
        try:
            with logical_sharding(mesh, single_pod_rules()), \
                    torch.no_grad():
                plain, _ = forward(cfg, params, batch["tokens"])
                n_plain = len(calls)
                flash, _ = forward(cfg, params, batch["tokens"],
                                   use_flash=True)
            out[f"fflash/{name}/calls"] = np.array(
                [n_plain, len(calls) - n_plain, cfg.n_layers])
            out[f"fflash/{name}/max_abs"] = np.array(
                float((flash - plain).abs().max()))
            try:
                with logical_sharding(mesh, single_pod_rules()):
                    steps.loss_and_grads(cfg, params, batch, use_flash=True)
                refused = False
            except KernelGradientError:
                refused = True
            out[f"fflash/{name}/refused"] = np.array(refused)
        finally:
            setattr(owner, attr, real)


def _specs_tree(cfg, mesh):
    """The shardings of a train state's checkpoint tree."""
    pspecs = param_pspecs(cfg, mesh)
    opt = opt_pspecs(cfg, mesh, pspecs)
    return to_named(mesh, {
        "params": reference_pspecs(pspecs),
        "opt": {"m": reference_pspecs(opt["m"]),
                "v": reference_pspecs(opt["v"]), "step": PartitionSpec()},
    })


def resume_case(out, root, t=mc.TRAIN_RESUME):
    """``TrainLoop`` over a train state of shards on (2, 2) (``t``: the
    regime and the schedule), a checkpoint every 2 steps: uninterrupted,
    and preempted at step 3 then resumed from the step-2 checkpoint
    (restored onto the mesh as DTensors and cut into shards again).
    Whether the final shards are bit-equal, the metrics of the two runs,
    and whether the last checkpoint's leaves equal the final shards
    gathered whole."""
    cfg = mc.tp_config(get_config, t["regime"])
    mesh = make_host_mesh(*t["mesh"], device="cpu")
    step = steps.make_train_step(cfg, AdamWConfig(**mc.TRAIN_OPT),
                                 remat="full")
    cases = {"resume": (t["regime"], t["mesh"], t["batch"], t["seq"], "full")}

    def step_fn(state, i):
        if not isinstance(state["params"], TransformerLM):
            state = train_state_shards_from_arrays(cfg, state, mesh,
                                                   device="cpu")
        batch = mc.train_batch(cfg, "resume", i, cases)
        with logical_sharding(mesh, single_pod_rules()):
            params, opt, met = step(state["params"], state["opt"], batch)
        return ({"params": params, "opt": opt},
                {k: float(v) for k, v in met.items()})

    runs = {}
    for tag, fail in (("whole", ()), ("preempted", (t["fail_at"],))):
        d = os.path.join(root, f"resume_{tag}")
        loop = TrainLoop(step_fn, CheckpointManager(
            CheckpointConfig(d, keep=3), device="cpu"),
            save_every=t["save_every"],
            preemption=PreemptionSchedule(fail_at=fail))
        state = shard_train_state(cfg, init_leaves(cfg, mc.TRAIN_SEED, "cpu"),
                                  mesh, device="cpu")
        state = loop.run(state, t["steps"], shardings=_specs_tree(cfg, mesh))
        runs[tag] = (state, loop)
        out[f"resume/{tag}/restarts"] = np.array(loop.restarts)
        out[f"resume/{tag}/loss"] = np.array(
            [m["loss"] for m in loop.metrics_log])
        out[f"resume/{tag}/steps"] = np.array(
            [m["step"] for m in loop.metrics_log])
    a, b = runs["whole"][0], runs["preempted"][0]
    pairs = [(x, y) for (_, x), (_, y) in zip(
        a["params"].named_parameters(), b["params"].named_parameters())]
    for key in ("m", "v"):
        pairs += [(a["opt"][key][n], b["opt"][key][n]) for n in a["opt"][key]]
    out["resume/bit_equal"] = np.array(all(torch.equal(x, y)
                                           for x, y in pairs))
    ckpt, saved_step = load_checkpoint(os.path.join(root, "resume_preempted"),
                                       device="cpu")
    flat = flatten_pytree(ckpt)
    specs = b["params"].pspecs
    whole = {"params": {}, "opt": {"m": {}, "v": {}, "step": b["opt"]["step"]}}
    for n, p in b["params"].named_parameters():
        whole["params"][n] = gather_whole(p, specs[n], mesh)
        for key in ("m", "v"):
            whole["opt"][key][n] = gather_whole(b["opt"][key][n], specs[n],
                                                mesh)
    want = flatten_pytree(whole)
    out["resume/ckpt_step"] = np.array(saved_step)
    out["resume/ckpt_equal"] = np.array(
        set(flat) == set(want)
        and all(torch.equal(flat[k], want[k]) for k in flat))


def run(rank, init_file, ref_paths, out_dir, suite="base"):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        ref = mc.NpzFiles(ref_paths)
        index = mc.shard_index(ref.files)
        out = {}
        if suite == "families":
            for name in mc.TRAIN_FAMILY_CASES:
                train_case(ref, index, out, name, one_process=(
                    name in mc.TRAIN_FAMILY_ONE_PROCESS))
            family_flash_case(out)
            resume_case(out, out_dir, mc.TRAIN_FAMILY_RESUME)
        else:
            collective_grads(out, rank)
            for name in mc.TRAIN_CASES:
                train_case(ref, index, out, name,
                           one_process=name in mc.TRAIN_ONE_PROCESS)
            flash_case(out)
            threaded_backward(out)
            resume_case(out, out_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
