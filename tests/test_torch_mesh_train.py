"""The port's tensor-parallel training on process groups, held against the
reference's sharded ``jit`` on a forced 4-device CPU mesh: the
collectives' transposes, ``loss_and_grads`` and ``make_train_step`` on a
sharded ``TransformerLM`` (vocab-parallel cross entropy, ZeRO-3
gradients, the shard-aware clip, AdamW on shards), a tensor-parallel
run preempted and resumed from a checkpoint, and the families that stay
refused.

Both sides run once per module.  The reference runs in a process of its
own (``torch_mesh_train_reference.py``, JAX with
``--xla_force_host_platform_device_count=4``); the port as 4 CPU ranks
spawned together (``torch_mesh_train_ranks.py``; gloo through a
``file://`` rendezvous, each collective under a timeout, so a hang fails
the test).  Inputs are made with numpy from seeds (``mesh_cases.py``);
every rank writes what it got and the tests below assert.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.multiprocessing as mp

import mesh_cases as mc

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
RANKS = 4
ONE_PROCESS = sorted(mc.TRAIN_ONE_PROCESS)
#: Adam's denominator sqrt(v^) within this many eps of zero on both sides
#: makes an element ``near`` (``_check_update``)
NEAR_EPS = 300
#: at most this share of a case's elements is ``near`` at a step
NEAR_SHARE = 0.05


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs and its shard index, each rank's
    outputs).  The reference's cases run in three processes side by
    side."""
    root = tmp_path_factory.mktemp("mesh_train")
    ref_paths = [str(root / f"ref{i}.npz")
                 for i in range(len(mc.TRAIN_REFERENCE_SPLIT))]
    # one thread each: the reference's time is its (single-threaded)
    # compiles, and the test shares the host with other test files
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               PYTHONPATH=os.pathsep.join([SRC, HERE]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_train_reference.py"),
         path, *cases], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
        for path, cases in zip(ref_paths, mc.TRAIN_REFERENCE_SPLIT)]
    try:
        errs = [proc.communicate(timeout=600)[1] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err.decode()[-3000:]
    import torch_mesh_train_ranks

    mp.spawn(torch_mesh_train_ranks.run,
             args=(str(root / "rendezvous"), ref_paths, str(root)),
             nprocs=RANKS, join=True)
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(RANKS)]
    ref = mc.NpzFiles(ref_paths)
    return (ref, mc.shard_index(ref.files)), ranks


def _ref_shard(ref, head: str, name: str, key: str) -> np.ndarray:
    """The reference's shard of the port's leaf ``name`` at the rank's
    place ``key`` (``mesh_cases.ref_shard``)."""
    from repro_torch.models.model import reference_path

    return mc.ref_shard(*ref, head, *reference_path(name), key)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _names(out, case: str) -> list[str]:
    pre = f"{case}/key/"
    return [k.removeprefix(pre) for k in out if k.startswith(pre)]


def _check_update(got, want, v_pair, step: int, what) -> tuple[int, int]:
    """An AdamW step's updated parameters against another computation of
    the same step from the same state; returns (elements ``near``,
    elements off), which the caller bounds over the whole case.

    The parameter moves by lr times the normalized step m^ / (sqrt(v^) +
    eps).  Where Adam's denominator sqrt(v^) lies within a few eps of
    zero (on the first step, sqrt(v^) is the clipped gradient's
    magnitude), the last bits of the gradient (summed in another order,
    by other ranks) move that step by up to a whole lr, a sign flip
    included.  So an element is ``near`` when sqrt(v^) is within
    ``NEAR_EPS`` eps of zero on both sides (``v_pair``: ``got``'s v, then
    ``want``'s), and not zero on both; every other element of the leaf is
    held to 1e-5 relative L2.  An element is off when its gap passes
    1e-6 relative plus 1e-7 (as the wire step's test counts them)."""
    cfg = mc.TRAIN_OPT_CFG
    c2 = 1 - cfg["beta2"] ** step
    denom = np.maximum(*(np.sqrt(np.asarray(v, np.float64) / c2)
                         for v in v_pair))
    near = (denom > 0) & (denom <= NEAR_EPS * cfg["eps"])
    gap = np.abs(got.astype(np.float64) - want)
    off = gap > 1e-6 * np.abs(want) + 1e-7
    rest = _rel(got[~near], want[~near])
    assert rest <= 1e-5, (what, rest)
    return int(near.sum()), int(off.sum())


def _bound_flips(near: int, off: int, size: int, what) -> None:
    """The elements off at most as many as those ``near`` (each flip needs
    one), and those at most ``NEAR_SHARE`` of the case's."""
    assert off <= near, (what, off, near)
    assert near <= NEAR_SHARE * size, (what, near, size)


@pytest.mark.parametrize("name", ["all_gather", "all_gather_slice",
                                  "psum_scatter", "psum", "psum_grad"])
def test_collective_transposes(runs, name):
    """Each rank's gradient of the ranks' summed ``sum(c_r * f(x_r))`` is
    the JAX transpose: ``all_gather`` -> ``psum_scatter`` of the
    cotangents (``grad="slice"``: this rank's block of its own),
    ``psum_scatter`` -> ``all_gather``, ``psum`` -> identity, ``psum_grad``
    -> ``psum``; exact up to float32 sums in another order."""
    _, ranks = runs
    c8 = [o["coll/c8"] for o in ranks]
    c2 = [o["coll/c2"] for o in ranks]
    for r, out in enumerate(ranks):
        want = {
            "all_gather": sum(c[2 * r:2 * r + 2] for c in c8),
            "all_gather_slice": c8[r][2 * r:2 * r + 2],
            "psum_scatter": np.concatenate(c2),
            "psum": c2[r],
            "psum_grad": sum(c2),
        }[name]
        np.testing.assert_allclose(out[f"coll/{name}"], want, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("case", sorted(mc.TRAIN_CASES))
def test_tp_loss_and_grad_norm_match_the_reference(runs, case):
    """Every rank's loss (``loss_and_grads`` and the step's) and the
    step's grad norm (the global arrays' norm, from the shards) within
    1e-5 relative of the reference's sharded ``jit`` at each step (a step
    after the first from the reference's state before it)."""
    (ref, _), ranks = runs
    for out in ranks:
        for i in range(mc.TRAIN_STEPS):
            for key in ("loss", "step_loss", "grad_norm"):
                np.testing.assert_allclose(out[f"{case}/{key}/{i}"],
                                           ref[f"{case}/{key}/{i}"],
                                           rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("case", sorted(mc.TRAIN_CASES))
def test_tp_gradient_shards_match_the_reference(runs, case):
    """Every rank's gradient shard of every leaf, at each step, within
    1e-4 relative L2 of the reference's gradient's addressable shard at
    the same place of the mesh (ZeRO-3's reduce-scattered shards; the
    replicated leaves summed over the axes that cut the batch and the
    sequence)."""
    ref, ranks = runs
    for out in ranks:
        for n in _names(out, case):
            key = str(out[f"{case}/key/{n}"])
            for i in range(mc.TRAIN_STEPS):
                got = out[f"{case}/g/{i}/{n}"]
                want = _ref_shard(ref, f"{case}/g/{i}", n, key)
                assert got.shape == want.shape, (n, got.shape, want.shape)
                assert _rel(got, want) <= 1e-4, (n, i, _rel(got, want))


@pytest.mark.parametrize("case", sorted(mc.TRAIN_CASES))
def test_tp_updated_shards_match_the_reference(runs, case):
    """After each step (from the reference's state before it), every
    rank's ``m`` and ``v`` shard within 1e-5 relative L2 of the
    reference's updated state's shard at the same place, and its
    parameter shard too, but for the elements whose Adam denominator
    lies within a few eps of zero on both sides; over the case those
    bound the elements off, and are a small share (``_check_update``,
    ``_bound_flips``)."""
    ref, ranks = runs
    for i in range(mc.TRAIN_STEPS):
        near = off = size = 0
        for out in ranks:
            for n in _names(out, case):
                key = str(out[f"{case}/key/{n}"])
                for kind in ("p", "m", "v"):
                    got = out[f"{case}/{kind}/{i}/{n}"]
                    want = _ref_shard(ref, f"{case}/{kind}/{i}", n, key)
                    assert got.dtype == want.dtype, (n, kind)
                    if kind == "p":
                        a, b = _check_update(got, want, [
                            out[f"{case}/v/{i}/{n}"],
                            _ref_shard(ref, f"{case}/v/{i}", n, key)],
                            i + 1, (n, i))
                        near, off, size = near + a, off + b, size + got.size
                    else:
                        assert _rel(got, want) <= 1e-5, (n, kind, i,
                                                         _rel(got, want))
        _bound_flips(near, off, size, (case, i))


@pytest.mark.parametrize("case", sorted(mc.TRAIN_CASES))
def test_tp_replicated_leaves_stay_bit_equal(runs, case):
    """The ranks that hold the same shard of a leaf (every rank, for a
    replicated one) hold bit-equal parameters and moments after the
    step, and the case has such leaves."""
    _, ranks = runs
    shared = 0
    for n in _names(ranks[0], case):
        by_key: dict = {}
        for out in ranks:
            by_key.setdefault(str(out[f"{case}/key/{n}"]), []).append(out)
        for group in by_key.values():
            shared += len(group) > 1
            for out in group[1:]:
                for k in out:
                    if k.startswith((f"{case}/p/", f"{case}/m/",
                                     f"{case}/v/")) and k.endswith(f"/{n}"):
                        np.testing.assert_array_equal(out[k], group[0][k],
                                                      err_msg=k)
    assert shared > 0


@pytest.mark.parametrize("case", ONE_PROCESS)
def test_tp_step_matches_the_ports_one_process_step(runs, case):
    """The port's tensor-parallel first step against its own one-process
    step on the same weights and batch: the loss and grad norm within
    1e-5 relative, the gradient shards within 1e-4 relative L2 of the
    whole gradients' slices, the moments within 1e-5 and the updated
    parameter shards as ``_check_update`` and ``_bound_flips`` hold
    them."""
    _, ranks = runs
    near = off = size = 0
    for out in ranks:
        np.testing.assert_allclose(out[f"{case}/step_loss/0"],
                                   out[f"{case}/onep/loss"], rtol=1e-5)
        np.testing.assert_allclose(out[f"{case}/grad_norm/0"],
                                   out[f"{case}/onep/grad_norm"], rtol=1e-5)
        for n in _names(out, case):
            want = out[f"{case}/onep/g/{n}"]
            assert _rel(out[f"{case}/g/0/{n}"], want) <= 1e-4, n
            for kind in ("m", "v"):
                assert _rel(out[f"{case}/{kind}/0/{n}"],
                            out[f"{case}/onep/{kind}/{n}"]) <= 1e-5, (n, kind)
            a, b = _check_update(out[f"{case}/p/0/{n}"],
                                 out[f"{case}/onep/p/{n}"],
                                 [out[f"{case}/v/0/{n}"],
                                  out[f"{case}/onep/v/{n}"]], 1, n)
            near, off, size = near + a, off + b, size + out[
                f"{case}/p/0/{n}"].size
    _bound_flips(near, off, size, case)


def test_backward_on_another_thread_is_timed_and_equal(runs):
    """The tensor-parallel loss's backward (remat "full", ZeRO-3 on
    (2, 2)) run on a thread of its own, as the card's autograd engine
    runs it: gradients bit-equal to the calling thread's, and the
    backward's collectives (`` bwd`` kinds) and the recompute's timed
    into the forward's ``collective_timing`` table, as many as on the
    calling thread."""
    _, ranks = runs
    for out in ranks:
        assert bool(out["thread/equal"])
        here = {k.removeprefix("thread/here/"): v for k, v in out.items()
                if k.startswith("thread/here/")}
        there = {k.removeprefix("thread/thread/"): v for k, v in out.items()
                 if k.startswith("thread/thread/")}
        assert set(here) == set(there), (here, there)
        assert any(k.endswith(" bwd") for k in here), here
        for k in here:
            np.testing.assert_array_equal(here[k], there[k], err_msg=k)


def test_use_flash_on_shards_takes_k7_or_refuses_autograd(runs):
    """``use_flash`` on sharded parameters is not dropped: without grad
    ``forward`` calls K7's wrapper once a layer (its CPU version here),
    within 1e-5 of the plain attention's logits, and under autograd
    ``loss_and_grads`` raises ``KernelGradientError``, as on whole
    parameters (K7 has no backward)."""
    from repro_torch.configs import get_config

    layers = mc.tp_config(get_config, "kv4").n_layers
    _, ranks = runs
    for out in ranks:
        assert out["flash/calls"].tolist() == [0, layers]
        assert float(out["flash/max_abs"]) <= 1e-5
        assert bool(out["flash/refused"])


def test_tp_run_preempted_and_resumed_is_bit_equal(runs):
    """``TrainLoop`` over a train state of shards on (2, 2), a checkpoint
    every 2 steps, preempted at step 3 and resumed from the step-2
    checkpoint (gathered whole and written by rank 0, restored onto the
    mesh as DTensors, cut into shards again): the final shards bit-equal
    to an uninterrupted run's, its losses the same, and the last
    checkpoint's leaves equal to the final shards gathered whole."""
    _, ranks = runs
    t = mc.TRAIN_RESUME
    for out in ranks:
        assert int(out["resume/whole/restarts"]) == 0
        assert int(out["resume/preempted/restarts"]) == 1
        assert bool(out["resume/bit_equal"])
        whole = dict(zip(out["resume/whole/steps"].tolist(),
                         out["resume/whole/loss"].tolist()))
        again = dict(zip(out["resume/preempted/steps"].tolist(),
                         out["resume/preempted/loss"].tolist()))
        assert whole == again and len(whole) == t["steps"]
        assert int(out["resume/ckpt_step"]) == t["steps"]
        assert bool(out["resume/ckpt_equal"])


@pytest.mark.parametrize("arch,reason", [
    ("hymba-1.5b", "SSM branch"),
    ("rwkv6-1.6b", "RWKV6"),
    ("deepseek-v3-671b", "MLA"),
])
def test_sharded_families_not_cut_yet_are_refused(arch, reason):
    """``hidden_states``, ``forward``, ``loss_fn`` and ``loss_and_grads``
    on a sharded Hymba, RWKV6 or MLA model raise ``NotImplementedError``
    naming what is not cut, before any collective."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.model import (
        TransformerLM,
        forward,
        hidden_states,
        loss_fn,
    )
    from repro_torch.models.sharding import logical_sharding, single_pod_rules

    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    params = TransformerLM(cfg, "cpu")
    params.mesh = AbstractMesh((2, 2), ("data", "model"))
    tok = np.zeros((2, 8), np.int64)
    with logical_sharding(params.mesh, single_pod_rules()):
        for call in (lambda: hidden_states(cfg, params, tok),
                     lambda: forward(cfg, params, tok),
                     lambda: loss_fn(cfg, params, tok, tok),
                     lambda: loss_and_grads(cfg, params, {"tokens": tok,
                                                          "labels": tok})):
            with pytest.raises(NotImplementedError, match=reason):
                call()


def test_shared_expert_and_compression_refused_under_a_mesh():
    """A shared expert is not cut (the reason says so), and gradient
    compression on sharded parameters is refused for the wire step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import TransformerLM, loss_fn
    from repro_torch.models.sharding import logical_sharding, single_pod_rules
    from repro_torch.models.tensor_parallel import check_cut
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import GradCompressionConfig

    mesh = AbstractMesh((1, 4), ("data", "model"))
    shared = dataclasses.replace(get_config("granite-moe-3b-a800m").smoke(),
                                 n_shared_experts=1)
    with pytest.raises(NotImplementedError, match="shared expert"):
        check_cut(shared, mesh)
    cfg = dataclasses.replace(get_config("qwen3-4b").smoke(), dtype="float32")
    params = TransformerLM(cfg, "cpu")
    params.mesh = mesh
    step = make_train_step(cfg, AdamWConfig(),
                           grad_comp=GradCompressionConfig(enabled=True))
    tok = np.zeros((2, 8), np.int64)
    with logical_sharding(mesh, single_pod_rules()):
        with pytest.raises(NotImplementedError, match="make_wire_train_step"):
            step(params, {}, {"tokens": tok, "labels": tok})
    with pytest.raises(RuntimeError, match="logical_sharding"):
        loss_fn(cfg, params, tok, tok)
