"""The port's tensor-parallel training on process groups, held against the
reference's sharded ``jit`` on a forced 4-device CPU mesh: the
collectives' transposes, ``loss_and_grads`` and ``make_train_step`` on a
sharded ``TransformerLM`` (vocab-parallel cross entropy, ZeRO-3
gradients, the shard-aware clip, AdamW on shards), a tensor-parallel
run preempted and resumed from a checkpoint, and gradient compression
on shards (the compressor alone, bit-equal to the reference's sharded
``jit``; the compressed step; its error feedback through a checkpoint).
The recurrent families, MLA and a shared expert are
``test_torch_mesh_train_families.py``'s.

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


def test_shared_expert_cut_and_sharded_loss_needs_logical_sharding():
    """A shared expert is cut for training as for serving (its cases are
    ``test_torch_mesh_train_families.py``'s), and the loss of sharded
    parameters outside ``logical_sharding`` raises."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import TransformerLM, loss_fn
    from repro_torch.models.tensor_parallel import check_cut

    mesh = AbstractMesh((1, 4), ("data", "model"))
    shared = dataclasses.replace(get_config("granite-moe-3b-a800m").smoke(),
                                 n_shared_experts=1)
    check_cut(shared, mesh)
    cfg = dataclasses.replace(get_config("qwen3-4b").smoke(), dtype="float32")
    params = TransformerLM(cfg, "cpu")
    params.mesh = mesh
    tok = np.zeros((2, 8), np.int64)
    with pytest.raises(RuntimeError, match="logical_sharding"):
        loss_fn(cfg, params, tok, tok)


@pytest.mark.parametrize("case", sorted(mc.COMP_CASES))
def test_sharded_compressor_is_bit_equal_to_the_reference(runs, case):
    """``compress_gradients`` on each rank's shards under the mesh, twice
    (the second call on the first's error feedback), against the
    reference's ``compress_gradients`` jitted with ``in_shardings`` =
    ``param_pspecs``: every leaf's decoded gradient and new error
    feedback bit-equal to the reference's shard at the same place, and
    each leaf's lo and hi (one ``pmax`` over the mesh) equal to the min
    and max of its whole corrected gradient."""
    ref, ranks = runs
    for out in ranks:
        for n in _names(out, case):
            key = str(out[f"{case}/key/{n}"])
            for call in range(mc.COMP_CALLS):
                for kind in ("dec", "ef"):
                    got = out[f"{case}/{kind}/{call}/{n}"]
                    want = _ref_shard(ref, f"{case}/{kind}/{call}", n, key)
                    assert got.dtype == want.dtype == np.float32
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=str((n, kind, call)))
        lohi = sorted(k for k in out if k.startswith(f"{case}/lohi/"))
        assert lohi and lohi == sorted(
            k for k in ref[0].files if k.startswith(f"{case}/lohi/"))
        for k in lohi:
            np.testing.assert_array_equal(out[k], ref[0][k], err_msg=k)


def _corrected(ref, ranks, case, i):
    """Each rank's corrected gradients of step ``i`` ({name: array}), the
    reference's at the same places, and each reference leaf's (lo, hi)
    on both sides (0: the port's, 1: the reference's): the min and max
    over every rank's shards, which cover the leaf."""
    from repro_torch.models.model import reference_path

    got, want, bounds = [], [], {}
    for out in ranks:
        mine, theirs = {}, {}
        for n in _names(out, case):
            key = str(out[f"{case}/key/{n}"])
            ef = (np.zeros_like(out[f"{case}/g/{i}/{n}"]) if i == 0 else
                  _ref_shard(ref, f"{case}/ef/{i - 1}", n, key))
            mine[n] = out[f"{case}/g/{i}/{n}"] + ef
            theirs[n] = _ref_shard(ref, f"{case}/g/{i}", n, key) + ef
            path = reference_path(n)[0]
            for side, c in ((0, mine[n]), (1, theirs[n])):
                lo, hi = bounds.get((path, side), (np.inf, -np.inf))
                bounds[path, side] = (min(lo, c.min()), max(hi, c.max()))
        got.append(mine)
        want.append(theirs)
    return got, want, bounds


@pytest.mark.parametrize("case", sorted(mc.TRAIN_COMP_CASES))
def test_compressed_step_matches_the_reference(runs, case):
    """``make_train_step`` with gradient compression on sharded parameters
    (a step after the first from the reference's state, its error
    feedback included) against the reference's sharded ``jit`` of the
    same step: the losses and grad norms within 1e-5 relative and the
    gradient shards within 1e-4 relative L2, then the code-flip rule.

    Each side's corrected gradient (its gradient plus the error feedback
    the step starts from) falls in a bin of that side's own lo and hi
    (the min and max over the whole leaf); an element whose two bins
    differ is ``near``.  The port's error feedback after the step is
    bit-equal to its corrected gradient less its bin's midpoint
    (``mesh_cases.comp_decode``: the global bounds, XLA's FMA).  Outside
    ``near`` both sides decode one bin q, and their midpoints differ by
    at most d_dec = |d lo| + (q + 1/2) |d step|, the clipped ones by
    d_clip = s d_dec + |d s| |mid| (s the clip scales, mid the
    reference's midpoint): all from the sides' scalars, none from their
    decoded values.  So outside ``near`` the updated parameters are held
    to 1e-5 relative L2, and ``m``, ``v`` and the error feedback to 1e-5
    relative L2 plus the L2 of (1 - beta1) d_clip, (1 - beta2) d_clip (2
    |s mid| + d_clip) and |d corrected| + d_dec; an element is off when
    its gap passes that much plus 1e-6 relative plus 1e-7, and the
    elements off are bounded as ``_bound_flips`` does, a near element
    counting once for each of the four kinds.  The control: the port's
    ``m`` and error feedback as a decode at each bin's lower edge would
    make them fail the same rule in every leaf.  (The reference's own
    error feedback is not held to the corrected gradient less the
    midpoint bit for bit: inside the jitted step XLA fuses its
    arithmetic otherwise, and it is an ulp of lo off that in a few
    elements.)"""
    from repro_torch.models.model import reference_path

    ref, ranks = runs
    bits = mc.TRAIN_COMP_BITS
    b1, b2 = mc.TRAIN_OPT_CFG["beta1"], mc.TRAIN_OPT_CFG["beta2"]
    for out in ranks:
        for i in range(mc.TRAIN_STEPS):
            for key in ("loss", "step_loss", "grad_norm"):
                np.testing.assert_allclose(out[f"{case}/{key}/{i}"],
                                           ref[0][f"{case}/{key}/{i}"],
                                           rtol=1e-5, err_msg=key)
    for i in range(mc.TRAIN_STEPS):
        got, want, bounds = _corrected(ref, ranks, case, i)
        sa, sb = (min(1.0, 1.0 / max(float(out[f"{case}/grad_norm/{i}"]),
                                     1e-9))
                  for out in (ranks[0], ref[0]))
        near = off = size = 0
        for out, mine, theirs in zip(ranks, got, want):
            for n in _names(out, case):
                key = str(out[f"{case}/key/{n}"])
                path = reference_path(n)[0]
                assert _rel(out[f"{case}/g/{i}/{n}"], _ref_shard(
                    ref, f"{case}/g/{i}", n, key)) <= 1e-4, (n, i)
                ca, cb = mine[n], theirs[n]
                (la, ha), (lb, hb) = bounds[path, 0], bounds[path, 1]
                qa = mc.comp_bins(ca, la, ha, bits)
                qb = mc.comp_bins(cb, lb, hb, bits)
                da = mc.comp_decode(qa, la, ha, bits)
                np.testing.assert_array_equal(out[f"{case}/ef/{i}/{n}"],
                                              ca - da, err_msg=str((n, i)))
                keep = qa == qb
                step_a = np.float64(mc.comp_step(la, ha, bits))
                step_b = np.float64(mc.comp_step(lb, hb, bits))
                half = qb.astype(np.float64) + 0.5
                mid = np.float64(np.float32(lb)) + half * step_b
                d_dec = (abs(np.float64(np.float32(la)) - np.float32(lb))
                         + half * abs(step_a - step_b))
                d_clip = sa * d_dec + abs(sa - sb) * np.abs(mid)
                allowed = {"p": np.zeros_like(d_dec),
                           "m": (1 - b1) * d_clip,
                           "v": (1 - b2) * d_clip * (2 * sb * np.abs(mid)
                                                     + d_clip),
                           "ef": np.abs(ca.astype(np.float64) - cb) + d_dec}
                edge = (-(1 - b1) * 0.5 * step_a * sa, 0.5 * step_a)
                for kind in ("p", "m", "v", "ef"):
                    a = out[f"{case}/{kind}/{i}/{n}"]
                    b = _ref_shard(ref, f"{case}/{kind}/{i}", n, key)
                    assert a.dtype == b.dtype, (n, kind)
                    b64 = b.astype(np.float64)
                    gap = np.abs(a - b64)
                    room = (1e-5 * np.linalg.norm(b64[keep])
                            + np.linalg.norm(allowed[kind][keep]))
                    assert np.linalg.norm(gap[keep]) <= room, (
                        n, kind, i, np.linalg.norm(gap[keep]), room)
                    if kind in ("m", "ef") and keep.any():
                        wrong = a + edge[kind == "ef"]
                        assert np.linalg.norm((wrong - b64)[keep]) > room, (
                            "control", n, kind, i)
                    off += int((gap > 1e-6 * np.abs(b) + 1e-7
                                + allowed[kind]).sum())
                    size += a.size
                near += 4 * int((~keep).sum())
        _bound_flips(near, off, size, (case, i))


def test_ef_shards_survive_a_checkpoint(runs):
    """A (2, 2) train state of shards carrying gradient compression's error
    feedback (``shard_train_state(..., grad_comp=...)``, nonzero after two
    compressed steps) saved through ``CheckpointManager`` and restored
    with ``shardings=``: every shard, the float32 error feedback's
    included, bit-equal after the restore."""
    _, ranks = runs
    for out in ranks:
        assert int(out["efckpt/step"]) == 2
        assert out["efckpt/keys"].tolist() == ["ef", "m", "step", "v"]
        assert out["efckpt/ef_dtypes"].tolist() == ["torch.float32"]
        assert bool(out["efckpt/ef_nonzero"])
        assert bool(out["efckpt/bit_equal"])
