"""Tensor-parallel training of the recurrent families, MLA and a shared
expert, held against the reference's sharded ``jit`` on a forced
4-device CPU mesh as ``test_torch_mesh_train.py`` holds GQA: RWKV6 (its
heads, the channel-mix's FF columns, the chunked WKV and the scan),
Hymba (padded heads through both redistribution routes, the window, the
SSM's d_inner channels), DeepSeek-V3 (MLA's heads and latents, routed
and shared experts, the aux loss, the MTP head under ``loss_fn`` and
``mtp_loss``) and a shared expert on GQA.

The reference runs in processes of its own side by side
(``torch_mesh_train_reference.py``, single-threaded, the cases of
``mesh_cases.TRAIN_FAMILY_CASES``), the port as 4 gloo CPU ranks
(``torch_mesh_train_ranks.run``, suite ``"families"``), apart from
``test_torch_mesh_train.py``'s so that ``--dist loadfile`` gives them
another worker.  The checks are that file's, at its tolerances
(``_check_update``, ``_bound_flips``), but for RWKV6's grad norm and
moments: those are held to the reference's at limits of their own
(``_limit``), and a float64 witness of each step shows that the gap is
float32's rounding, the reference's as much as the port's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.multiprocessing as mp

import mesh_cases as mc
from test_torch_mesh_train import (
    _bound_flips,
    _check_update,
    _names,
    _ref_shard,
    _rel,
)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
RANKS = 4
CASES = sorted(mc.TRAIN_FAMILY_CASES)


def _limit(case: str, what: str) -> float:
    """The relative limit of the case's ``what`` ("grad_norm" or
    "moments") against another float32 computation of the step:
    ``test_torch_mesh_train.py``'s 1e-5, or the case's own
    (``mesh_cases.TRAIN_FAMILY_F32_GAPS``, float32's rounding as the
    float64 witness shows it)."""
    return mc.TRAIN_FAMILY_F32_GAPS.get(case, {}).get(what, 1e-5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs and its shard index, each rank's
    outputs)."""
    root = tmp_path_factory.mktemp("mesh_train_families")
    split = mc.TRAIN_FAMILY_REFERENCE_SPLIT
    ref_paths = [str(root / f"ref{i}.npz") for i in range(len(split))]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               PYTHONPATH=os.pathsep.join([SRC, HERE]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_train_reference.py"),
         path, *cases], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
        for path, cases in zip(ref_paths, split)]
    try:
        errs = [proc.communicate(timeout=600)[1] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err.decode()[-3000:]
    import torch_mesh_train_ranks

    mp.spawn(torch_mesh_train_ranks.run,
             args=(str(root / "rendezvous"), ref_paths, str(root),
                   "families"),
             nprocs=RANKS, join=True)
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(RANKS)]
    ref = mc.NpzFiles(ref_paths)
    return (ref, mc.shard_index(ref.files)), ranks


@pytest.mark.parametrize("case", CASES)
def test_family_loss_and_grad_norm_match_the_reference(runs, case):
    """Every rank's loss (``loss_and_grads`` and the step's) and the
    step's grad norm within 1e-5 relative of the reference's sharded
    ``jit`` at each step (a step after the first from the reference's
    state before it); the grad norm of an RWKV6 case within its own
    limit (``_limit``)."""
    (ref, _), ranks = runs
    for out in ranks:
        for i in range(mc.TRAIN_STEPS):
            for key in ("loss", "step_loss", "grad_norm"):
                rtol = _limit(case, key) if key == "grad_norm" else 1e-5
                np.testing.assert_allclose(out[f"{case}/{key}/{i}"],
                                           ref[f"{case}/{key}/{i}"],
                                           rtol=rtol, err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_family_gradient_shards_match_the_reference(runs, case):
    """Every rank's gradient shard of every leaf at each step within 1e-4
    relative L2 of the reference's at the same place of the mesh: the
    leaves whole over ``model`` that enter a rank's heads or channels
    (RWKV6's mixes, bonus, decay and head norm, the SSM's ``dt_bias`` /
    ``d_skip``, padded heads' whole ``wk`` / ``wv``, the MLA latents'
    projections and norms) summed over ``model``, the weights gathered
    whole reduce-scattered back.  DeepSeek-V3's MTP leaves, which
    ``loss_fn`` does not reach, are zero on both sides."""
    ref, ranks = runs
    for out in ranks:
        for n in _names(out, case):
            key = str(out[f"{case}/key/{n}"])
            for i in range(mc.TRAIN_STEPS):
                got = out[f"{case}/g/{i}/{n}"]
                want = _ref_shard(ref, f"{case}/g/{i}", n, key)
                assert got.shape == want.shape, (n, got.shape, want.shape)
                if not np.any(want):
                    assert not np.any(got), (n, i)
                    continue
                assert _rel(got, want) <= 1e-4, (n, i, _rel(got, want))


@pytest.mark.parametrize("case", CASES)
def test_family_updated_shards_match_the_reference(runs, case):
    """After each step (from the reference's state before it), every
    rank's ``m`` and ``v`` shard within 1e-5 relative L2 of the
    reference's (an RWKV6 case's within its own limit, ``_limit``), its
    parameter shard as ``_check_update`` holds it, the
    near elements bounding the off ones (``_bound_flips``); the MTP
    leaves' zero-gradient step (decay alone) included."""
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
                        continue
                    if np.any(want):
                        assert _rel(got, want) <= _limit(case, "moments"), (
                            n, kind, i, _rel(got, want))
                    else:
                        assert not np.any(got), (n, kind, i)
        _bound_flips(near, off, size, (case, i))


@pytest.mark.parametrize("case", CASES)
def test_family_replicated_leaves_stay_bit_equal(runs, case):
    """The ranks that hold the same shard of a leaf hold bit-equal
    parameters and moments after each step, and the case has such
    leaves."""
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


@pytest.mark.parametrize("case", sorted(mc.TRAIN_FAMILY_ONE_PROCESS))
def test_family_step_matches_the_ports_one_process_step(runs, case):
    """The port's tensor-parallel first step against its own one-process
    step on the same weights and batch: the loss and grad norm within
    1e-5 relative, the gradient shards within 1e-4 relative L2 of the
    whole gradients' slices, the moments within 1e-5 (an RWKV6 case's
    within its own limit, ``_limit``), the updated parameter shards as
    ``_check_update`` and ``_bound_flips`` hold them."""
    _, ranks = runs
    near = off = size = 0
    for out in ranks:
        np.testing.assert_allclose(out[f"{case}/step_loss/0"],
                                   out[f"{case}/onep/loss"], rtol=1e-5)
        np.testing.assert_allclose(out[f"{case}/grad_norm/0"],
                                   out[f"{case}/onep/grad_norm"], rtol=1e-5)
        for n in _names(out, case):
            want = out[f"{case}/onep/g/{n}"]
            if not np.any(want):
                assert not np.any(out[f"{case}/g/0/{n}"]), n
            else:
                assert _rel(out[f"{case}/g/0/{n}"], want) <= 1e-4, n
            for kind in ("m", "v"):
                want = out[f"{case}/onep/{kind}/{n}"]
                got = out[f"{case}/{kind}/0/{n}"]
                assert (_rel(got, want) <= _limit(case, "moments")
                        if np.any(want) else not np.any(got)), (n, kind)
            a, b = _check_update(out[f"{case}/p/0/{n}"],
                                 out[f"{case}/onep/p/{n}"],
                                 [out[f"{case}/v/0/{n}"],
                                  out[f"{case}/onep/v/{n}"]], 1, n)
            near, off, size = near + a, off + b, size + out[
                f"{case}/p/0/{n}"].size
    _bound_flips(near, off, size, case)


@pytest.mark.parametrize("case", sorted(mc.TRAIN_FAMILY_F32_GAPS))
def test_family_float32_gaps_are_rounding(runs, case):
    """The float64 witness of the cases held at limits of their own: each
    step computed in float64 on one process from the same state
    (``torch_mesh_train_ranks._witness``).  The tensor-parallel step's
    loss and grad norm within 1e-5 relative of the float64 values, and
    for the gradients, m and v each the largest distance (relative L2
    over the case's shards) of its shards from the float64 slices at
    most ``F32_WITNESS_FACTOR`` times the reference's own float32
    step's: the cut adds no error beyond float32's rounding of the same
    sums."""
    ref, ranks = runs
    for i in range(mc.TRAIN_STEPS):
        for out in ranks:
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(out[f"{case}/{key}/{i}"],
                                           out[f"{case}/f64/{key}/{i}"],
                                           rtol=1e-5, err_msg=(key, i))
        for kind in ("g", "m", "v"):
            port = own = 0.0
            for out in ranks:
                for n in _names(out, case):
                    exact = out[f"{case}/f64/{kind}/{i}/{n}"]
                    if not np.any(exact):
                        continue
                    key = str(out[f"{case}/key/{n}"])
                    port = max(port, _rel(out[f"{case}/{kind}/{i}/{n}"],
                                          exact))
                    own = max(own, _rel(_ref_shard(
                        ref, f"{case}/{kind}/{i}", n, key), exact))
            assert port <= mc.F32_WITNESS_FACTOR * own, (kind, i, port, own)


@pytest.mark.parametrize("case", sorted(mc.TRAIN_FAMILY_MTP))
def test_mtp_loss_and_gradient_shards_match_the_reference(runs, case):
    """``mtp_loss`` on DeepSeek-V3's shards (the vocab-parallel lookups of
    the tokens and the next tokens, ``mtp.proj`` on the residual slice,
    the MTP block's MLA and dense MLP cut as any block, the vocab-parallel
    cross entropy, ``main + 0.3 mtp + 0.01 aux``): every rank's loss
    within 1e-5 relative of the reference's sharded ``jit`` of
    ``value_and_grad(mtp_loss)``, and every gradient shard, the MTP
    head's included, within 1e-4 relative L2."""
    ref, ranks = runs
    mtp_leaves = 0
    for out in ranks:
        np.testing.assert_allclose(out[f"{case}/mtp/loss"],
                                   ref[0][f"{case}/mtp/loss"], rtol=1e-5)
        for n in _names(out, case):
            key = str(out[f"{case}/key/{n}"])
            got = out[f"{case}/mtp/g/{n}"]
            want = _ref_shard(ref, f"{case}/mtp/g", n, key)
            assert got.shape == want.shape, n
            assert _rel(got, want) <= 1e-4, (n, _rel(got, want))
            mtp_leaves += n.startswith("mtp.") and bool(np.any(want))
    assert mtp_leaves > 0


@pytest.mark.parametrize("case", ["rwkv6_1x4", "hymba_padded"])
def test_use_flash_on_family_shards_takes_the_kernel_or_refuses_autograd(
        runs, case):
    """``use_flash`` on RWKV6's and padded Hymba's shards: without grad
    ``forward`` calls K8's (RWKV6) or K7's (Hymba) wrapper once a layer
    (its CPU version here) and its logits are within 1e-5 of the plain
    route's; under autograd ``loss_and_grads`` raises
    ``KernelGradientError``, as on whole parameters."""
    _, ranks = runs
    for out in ranks:
        plain, flash, layers = out[f"fflash/{case}/calls"].tolist()
        assert (plain, flash) == (0, layers)
        assert float(out[f"fflash/{case}/max_abs"]) <= 1e-5
        assert bool(out[f"fflash/{case}/refused"])


def test_family_run_preempted_and_resumed_is_bit_equal(runs):
    """``TrainLoop`` over RWKV6's train state of shards on (2, 2), a
    checkpoint every 2 steps, preempted at step 3 and resumed from the
    step-2 checkpoint (gathered whole in the reference's layout, restored
    onto the mesh as DTensors, cut into shards again): the final shards
    bit-equal to an uninterrupted run's, its losses the same, and the last
    checkpoint's leaves equal to the final shards gathered whole."""
    _, ranks = runs
    t = mc.TRAIN_FAMILY_RESUME
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


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b",
                                  "deepseek-v3-671b"])
def test_check_cut_admits_the_families_for_training(arch):
    """``check_cut``, which serving and training share, admits RWKV6,
    Hymba and DeepSeek-V3 (MLA, its shared expert) at full width on a 4-
    and a 16-way model axis; MLA whose heads do not divide stays refused,
    the reason naming ``w_uq``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.tensor_parallel import check_cut

    cfg = get_config(arch)
    for m in (4, 16):
        mesh = AbstractMesh((1, m), ("data", "model"))
        check_cut(cfg, mesh)
    if cfg.attn_type == "mla":
        with pytest.raises(NotImplementedError, match="w_uq"):
            check_cut(dataclasses.replace(cfg, n_heads=126), mesh)
