"""Tensor-parallel serving of MLA and a shared expert (DeepSeek-V3's
layers; a shared expert on Granite's GQA block), held against the
reference's sharded ``jit`` on a forced 4-device CPU mesh as
``test_torch_mesh_spmd.py`` holds the other families, and MLA alone on
a rank against its one-process functions.

The reference runs in a process of its own (``torch_mesh_reference.py
--mla``), the port as 4 gloo CPU ranks (``torch_mesh_ranks.run_mla``),
apart from the spmd file's so that ``--dist loadfile`` gives them
another worker.  Cases and inputs in ``mesh_cases.TP_MLA_CASES``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.multiprocessing as mp

import mesh_cases as mc
from test_torch_mesh_spmd import check_tp_logits, check_tp_shards

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
RANKS = 4
MESHES = [f"{d}x{m}" for d, m in mc.TP_MESHES]
TP_KEYS = [(case, mesh) for case in mc.TP_MLA_CASES for mesh in MESHES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, each rank's outputs)."""
    root = tmp_path_factory.mktemp("mesh_mla")
    ref_path = str(root / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([SRC, HERE]))
    subprocess.run([sys.executable, os.path.join(HERE,
                                                 "torch_mesh_reference.py"),
                    "--mla", ref_path], env=env, check=True, timeout=600,
                   capture_output=True)
    import torch_mesh_ranks

    mp.spawn(torch_mesh_ranks.run_mla,
             args=(str(root / "rendezvous"), ref_path, str(root)),
             nprocs=RANKS, join=True)
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(RANKS)]
    return dict(np.load(ref_path)), ranks


@pytest.mark.parametrize("case,mesh", TP_KEYS)
def test_tp_logits_match_the_references_sharded_jit(runs, case, mesh):
    """``make_prefill_step`` and ``make_decode_step`` on sharded DeepSeek-V3
    (each rank its MLA heads, its experts, its shared expert's and dense
    MLP's FF columns, its vocab slice; the latents gathered along the
    sequence; the latent cache cut along time where ``max_len`` divides
    the model axis) and on Granite with a shared expert: the prefill's
    logits and each decode step's, gathered whole on every rank, within
    float32 1e-5 relative L2 of the reference's ``prefill`` /
    ``decode_step`` jitted with ``in_shardings`` on 4 CPU devices.
    dsv3_long's 4,096-token prefill takes the chunked MLA route."""
    ref, ranks = runs
    check_tp_logits(ref, ranks, case, mesh)


@pytest.mark.parametrize("case,mesh", TP_KEYS)
def test_tp_shards_equal_the_references_addressable_shards(runs, case, mesh):
    """Every rank's parameter leaves (MLA's, the shared expert's, the MTP
    head's) equal, in shape and bit for bit, the reference's
    ``addressable_shards`` at the same (data, model) coordinate; its
    prefill cache's leaves (c_kv / k_rope of the dense and the MoE layers,
    Granite's k / v) have the shapes of the reference's shards under
    ``cache_pspecs`` and their values within 1e-5; ``pos`` is equal;
    ``init_cache_shards`` allocates those shapes."""
    ref, ranks = runs
    check_tp_shards(ref, ranks, case, mesh)


@pytest.mark.parametrize("cache", sorted(mc.MLA_CACHES))
@pytest.mark.parametrize("mesh", MESHES)
def test_tp_mla_time_cut_decode_equals_the_one_process_decode(runs, mesh,
                                                              cache):
    """dsv3's MLA alone: each rank's ``mla_prefill_tp`` and
    ``mla_decode_tp`` partials, summed over ``model``, equal the
    one-process ``mla_prefill`` / ``mla_decode`` of its rows within 1e-5,
    with the latent cache cut along time (24 slots: 6 a rank on (1, 4),
    decode's positions 16-18 crossing from rank 2's slice into rank 3's)
    and whole (25 slots); each rank's cache is its slice of the
    one-process cache after the prefill and after every step, and a step
    writes the new latent on the rank whose slice holds its position and
    on no other."""
    _, ranks = runs
    tag = f"mla/{mesh}/{cache}"
    max_len = mc.MLA_CACHES[cache]
    s = mc.MLA_X_SHAPE[1]
    owners = set()
    for out in ranks:
        lo = int(out[f"{tag}/lo"])
        t = out[f"{tag}/cache/prefill"].shape[1]
        assert t == (max_len if cache == "whole" else
                     max_len // int(mesh.split("x")[1]))
        np.testing.assert_allclose(out[f"{tag}/prefill/sum"],
                                   out[f"{tag}/prefill/want"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out[f"{tag}/cache/prefill"],
                                   out[f"{tag}/one/prefill"][:, lo:lo + t],
                                   rtol=1e-5, atol=1e-5)
        for i in range(mc.TP_DECODE_STEPS):
            np.testing.assert_allclose(out[f"{tag}/decode{i}/sum"],
                                       out[f"{tag}/decode{i}/want"],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(
                out[f"{tag}/cache/decode{i}"],
                out[f"{tag}/one/decode{i}"][:, lo:lo + t], rtol=1e-5,
                atol=1e-5)
            mine = lo <= s + i < lo + t
            want = [s + i - lo] if mine else []
            assert list(out[f"{tag}/decode{i}/changed"]) == want, (i, lo)
            if mine:
                owners.add((i, lo))
    steps = {i for i, _ in owners}
    assert steps == set(range(mc.TP_DECODE_STEPS))
    if cache == "cut" and mesh == "1x4":
        # positions 16, 17 on rank 2's slice [12, 18), 18 on rank 3's
        assert sorted(owners) == [(0, 12), (1, 12), (2, 18)]


def test_mla_heads_that_do_not_divide_are_refused():
    """MLA is cut by whole heads: a config whose heads do not divide the
    model axis is refused (serving and training cut alike), the reason
    naming ``w_uq``; MLA and a shared expert are admitted, and
    DeepSeek-V3's 128 heads on a 4- and a 16-way model axis."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.tensor_parallel import check_cut

    cfg = get_config("deepseek-v3-671b")
    for m in (4, 16):
        check_cut(cfg, AbstractMesh((1, m), ("data", "model")))
    mesh = AbstractMesh((1, 4), ("data", "model"))
    with pytest.raises(NotImplementedError, match="w_uq"):
        check_cut(dataclasses.replace(cfg, n_heads=126), mesh)
    check_cut(cfg, mesh)
    granite = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                                  n_shared_experts=1)
    check_cut(granite, mesh)
