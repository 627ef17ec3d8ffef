"""Checkpoints and the restartable train loop in the port on the CPU, held
against the reference: the entropy-coded tensor payload field by field
and across packages, checkpoints each package writes read by the other
(npz and ctz, every array equal), the two-way carry of a train state,
``TrainLoop`` resuming bit-exactly, and the ``launch.train`` driver.

bfloat16 crosses as its bits: the reference holds it as ``ml_dtypes``
arrays, the port as torch tensors.  The reference's lossless codec passes
bfloat16 through unencoded (its numpy kind is "V", not "f"); the port
does the same (ROADMAP R9).
"""
import dataclasses
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import save_checkpoint as ref_save
from repro.configs import get_config as ref_get_config
from repro.core import tensor_codec as ref_tc
from repro.launch.train import build_state as ref_build_state
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro_torch.checkpoint import (
    CheckpointConfig,
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_config
from repro_torch.convert import (
    lm_params_from_arrays,
    lm_params_to_arrays,
    train_state_from_arrays,
    train_state_to_arrays,
)
from repro_torch.core import tensor_codec as tc
from repro_torch.data.tokens import TokenDataConfig, synth_batch
from repro_torch.launch import train as train_driver
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import build_state
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import GradCompressionConfig
from repro_torch.runtime import (
    Preemption,
    PreemptionSchedule,
    StragglerMonitor,
    TrainLoop,
)

CPU = "cpu"


def tiny(cfg):
    """A smoke config cut further (d_model 64, vocab 128, MoE experts of
    32): every leaf of the train state under 64K values, so the codec's
    streams are short and a lossless restore is quick on the CPU."""
    moe = {"moe_d_ff": 32} if cfg.mlp_type == "moe" else {}
    return dataclasses.replace(cfg, d_model=64, head_dim=16, d_ff=128,
                               vocab_size=128, **moe)


def to_np(t) -> np.ndarray:
    """A tensor (or array) as numpy, bfloat16 as ``ml_dtypes``."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.asarray(t)


def bits_of(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.ndim else a.reshape(1).view(np.uint8)


def assert_trees_equal(got: dict, want: dict):
    """Two flat {path: array} dicts: same paths, dtype names, shapes and
    bits (a reference npz bfloat16 leaf is raw ``V2``: its bits count)."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = to_np(got[k]), to_np(want[k])
        assert g.shape == w.shape, k
        if w.dtype.kind != "V":
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        assert np.array_equal(bits_of(g), bits_of(w)), k


def flat_np(tree) -> dict:
    return {k: to_np(v) for k, v in tc.flatten_pytree(tree).items()}


def codec_tree(seed=0) -> dict:
    """One leaf of each kind the codec meets: float32 and float16 (split
    and entropy-coded), bfloat16 (passed through), int32, a scalar and an
    empty array."""
    rng = np.random.default_rng(seed)
    w = rng.normal(scale=0.03, size=(96, 700))
    return {
        "a32": w.astype(np.float32),
        "b16": rng.normal(scale=0.5, size=(64, 300)).astype(np.float16),
        "c_bf16": w[:40].astype(ml_dtypes.bfloat16),
        "d_int": rng.integers(-5, 5, (7, 3)).astype(np.int32),
        "e_scalar": np.int32(11),
        "f_empty": np.zeros((0, 4), np.float32),
        "g_big": rng.standard_normal(70_000).astype(np.float32),
    }


def port_tree(tree) -> dict:
    return {k: tc._host(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the tensor codec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [None, 8, 12])
def test_compressed_tensors_match_reference_field_by_field(bits):
    """Same tree, same payload: mode, bits, every tensor's metadata, the
    cluster codebooks, every stream (blob, length, cluster), the raw
    bytes, the cluster count, and the stats (the reported objective and
    coding loss within 1e-4 of the objective).  The dense Bregman step is
    float32 in both (R2): its sums differ in the last digits, and an
    argmin tie could split the assignments (none does here)."""
    tree = codec_tree()
    if bits is not None:
        tree = {k: v for k, v in tree.items() if k not in ("d_int",
                                                          "e_scalar",
                                                          "f_empty")}
    want = ref_tc.compress_tensors(tree, bits=bits)
    got = tc.compress_tensors(port_tree(tree), bits=bits, device=CPU)
    assert (got.mode, got.bits, got.n_clusters) == (
        want.mode, want.bits, want.n_clusters)
    assert got.tensors == want.tensors
    assert got.cluster_lengths == want.cluster_lengths
    assert got.streams == want.streams
    assert got.raw == want.raw
    assert sorted(got.stats) == sorted(want.stats)
    for k in ("k", "n_chunks"):
        assert got.stats[k] == want.stats[k]
    scale = abs(float(want.stats["objective_bits"]))
    for k in ("objective_bits", "coding_loss_bits"):
        # float32 KL sums in both (R2), of terms the size of the objective
        assert abs(float(got.stats[k]) - float(want.stats[k])) <= 1e-4 * scale
    assert got.nbytes == want.nbytes
    if bits is None:
        assert want.tensors["c_bf16"]["passthrough"]  # R9
        assert got.nbytes < sum(np.asarray(v).nbytes for v in tree.values())


@pytest.mark.parametrize("bits", [None, 8])
def test_codec_payloads_cross_both_ways(bits):
    """The port's bytes decode in the reference (its ``isinstance`` check
    passes: they name the reference's class path) and the reference's
    in the port, each equal to the other's own decode; a layer-on-demand
    decode reads one tensor."""
    tree = codec_tree(1)
    del tree["f_empty"]
    if bits is not None:
        tree = {k: v for k, v in tree.items() if k in ("a32", "g_big")}
    port_blob = tc.compress_tensors(port_tree(tree), bits=bits,
                                    device=CPU).to_bytes()
    ref_blob = ref_tc.compress_tensors(tree, bits=bits).to_bytes()
    assert b"repro.core.tensor_codec" in port_blob[:200]
    assert b"repro_torch" not in port_blob
    in_ref = ref_tc.decompress_tensors(ref_tc.CompressedTensors.from_bytes(
        port_blob))
    in_port = tc.decompress_tensors(tc.CompressedTensors.from_bytes(
        ref_blob))
    own_ref = ref_tc.decompress_tensors(ref_tc.CompressedTensors.from_bytes(
        ref_blob))
    own_port = tc.decompress_tensors(tc.CompressedTensors.from_bytes(
        port_blob))
    assert_trees_equal(in_ref, own_ref)
    assert_trees_equal(in_port, own_ref)
    assert_trees_equal(own_port, own_ref)
    if bits is None:
        assert_trees_equal(own_port, tree)
    part = tc.decompress_tensors(tc.CompressedTensors.from_bytes(ref_blob),
                                 names=["a32"])
    assert list(part) == ["a32"]
    with pytest.raises(TypeError):
        tc.CompressedTensors.from_bytes(
            __import__("pickle").dumps({"not": "a payload"}))


def test_flatten_pytree_stacks_a_train_state_like_the_reference():
    """A port train state flattens to the reference's paths and stacked
    shapes; a nested reference-layout tree flattens as the reference's
    own function flattens it."""
    cfg = get_config("deepseek-v3-671b").smoke()
    ref_cfg = ref_get_config("deepseek-v3-671b").smoke()
    opt_cfg = AdamWConfig()
    state = build_state(cfg, opt_cfg, 0, GradCompressionConfig(),
                        device=CPU)
    ref_state = ref_build_state(ref_cfg, ref_adamw.AdamWConfig(), 0,
                                ref_comp.GradCompressionConfig())
    got = tc.flatten_pytree(state)
    want = ref_tc.flatten_pytree(jax.tree.map(np.asarray, ref_state))
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
    nested = train_state_to_arrays(state)
    assert list(tc.flatten_pytree(nested)) == list(want)


# ---------------------------------------------------------------------------
# the two-way carry of a train state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,dtype", [
    ("qwen3-4b", "bfloat16"), ("deepseek-v3-671b", "float32"),
    ("hymba-1.5b", "float32"), ("rwkv6-1.6b", "bfloat16")])
def test_lm_params_to_arrays_inverts_from_arrays(name, dtype):
    """The reference's parameters into the port and back: every leaf
    equal bit for bit, in its own type (bfloat16 stays bfloat16; the MoE
    router float32), ``layers`` / ``layers_dense`` stacked, ``mtp``
    not."""
    ref_cfg = dataclasses.replace(ref_get_config(name).smoke(), dtype=dtype)
    cfg = dataclasses.replace(get_config(name).smoke(), dtype=dtype)
    from repro.models import init_params as ref_init_params

    ref = jax.tree.map(np.asarray, ref_init_params(ref_cfg,
                                                   jax.random.PRNGKey(0)))
    lm = lm_params_from_arrays(cfg, ref, device=CPU)
    back = lm_params_to_arrays(cfg, lm)
    assert_trees_equal(flat_np(back), ref_tc.flatten_pytree(ref))
    again = lm_params_from_arrays(cfg, back, device=CPU)
    for (n, a), (_, b) in zip(lm.named_parameters(),
                              again.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    with pytest.raises(ValueError):
        lm_params_to_arrays(get_config("qwen2.5-3b").smoke(), lm)


def _trained_port_state(cfg, steps=2, grad_bits=8):
    """A port train state after ``steps`` steps (float32 moments, the
    error feedback, a step count)."""
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    gc = GradCompressionConfig(bits=grad_bits)
    state = build_state(cfg, opt_cfg, 0, gc, device=CPU)
    step = make_train_step(cfg, opt_cfg, remat=None, grad_comp=gc)
    data = TokenDataConfig(cfg.vocab_size, 16, 2)
    for i in range(steps):
        p, o, _ = step(state["params"], state["opt"], synth_batch(data, i))
        state = {"params": p, "opt": o}
    return state


@pytest.mark.parametrize("codec", [None, "lossless"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_reads_in_the_reference(tmp_path, codec, dtype):
    """A port train state (parameters, float32 moments, step, error
    feedback) saved by the port loads in the reference with every array
    equal to the port's own reference-layout arrays, and back in the port
    as the same train state."""
    cfg = dataclasses.replace(tiny(get_config("granite-moe-3b-a800m").smoke()),
                              dtype=dtype)
    state = _trained_port_state(cfg)
    want = flat_np(state)
    save_checkpoint(tmp_path, 7, state, codec=codec, device=CPU)
    ref_state, step = ref_load(tmp_path)
    assert step == 7
    assert_trees_equal(ref_tc.flatten_pytree(ref_state), want)
    back, step = load_checkpoint(tmp_path, device=CPU)
    assert step == 7
    assert_trees_equal(flat_np(back), want)
    again = train_state_from_arrays(cfg, back, device=CPU)
    assert set(again["opt"]) == {"m", "v", "step", "ef"}
    assert_trees_equal(flat_np(again), want)
    assert again["opt"]["step"].dtype == torch.int32


@pytest.mark.parametrize("codec", [None, "lossless"])
def test_reference_checkpoint_reads_in_the_port(tmp_path, codec):
    """A reference train state (bfloat16 parameters, float32 moments, an
    int32 step, the error feedback) saved by the reference loads in the
    port with every array equal, and turns into a train state that steps:
    npz bfloat16 leaves come back as bfloat16 through the manifest's
    type."""
    ref_cfg = dataclasses.replace(tiny(ref_get_config("qwen3-4b").smoke()),
                                  dtype="bfloat16")
    cfg = dataclasses.replace(tiny(get_config("qwen3-4b").smoke()),
                              dtype="bfloat16")
    st = ref_build_state(ref_cfg, ref_adamw.AdamWConfig(), 0,
                         ref_comp.GradCompressionConfig())
    rng = np.random.default_rng(2)
    st = jax.tree.map(np.asarray, st)
    st["opt"]["m"] = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        st["opt"]["m"])
    st["opt"]["step"] = np.int32(4)
    want = ref_tc.flatten_pytree(st)
    ref_save(tmp_path, 4, st, codec=codec)
    got, step = load_checkpoint(tmp_path, device=CPU)
    assert step == 4
    assert_trees_equal(flat_np(got), want)
    assert got["params"]["embed"].dtype == torch.bfloat16
    state = train_state_from_arrays(cfg, got, device=CPU)
    assert_trees_equal(flat_np(state), want)
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=8)
    step_fn = make_train_step(cfg, opt_cfg, remat=None,
                              grad_comp=GradCompressionConfig())
    _, opt, m = step_fn(state["params"], state["opt"],
                        synth_batch(TokenDataConfig(cfg.vocab_size, 8, 2),
                                    0))
    assert int(opt["step"]) == 5 and np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# the reference's checkpoint and fault-tolerance tests, on the port
# ---------------------------------------------------------------------------
def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(
            rng.normal(size=(16, 8)).astype(np.float32))},
        "opt": {"m": torch.from_numpy(
            rng.normal(size=(16, 8)).astype(np.float32)),
            "step": torch.tensor(3, dtype=torch.int32)},
    }


def test_save_load_roundtrip(tmp_path):
    st = _state()
    save_checkpoint(tmp_path, 5, st, device=CPU)
    back, step = load_checkpoint(tmp_path, device=CPU)
    assert step == 5
    assert torch.equal(back["params"]["w"], st["params"]["w"])
    assert back["opt"]["step"].dtype == torch.int32


def test_uncommitted_is_invisible(tmp_path):
    save_checkpoint(tmp_path, 1, _state(), device=CPU)
    d = tmp_path / "step_00000009"
    d.mkdir()
    (d / "manifest.json").write_text("{}")
    assert latest_step(tmp_path) == 1


def test_rolling_gc(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), keep=2),
                            device=CPU)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    os.makedirs(tmp_path / ".tmp_ckpt_crashed")
    mgr.save(5, _state(5))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_00000004", "step_00000005"]


def test_entropy_coded_checkpoint_bit_exact(tmp_path):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(scale=0.03, size=(64, 64)).astype(
        np.float16))
    for codec in ("lossless", "q12"):
        save_checkpoint(tmp_path / codec, 2, {"w": w}, codec=codec,
                        device=CPU)
        back, _ = load_checkpoint(tmp_path / codec, device=CPU)
        assert back["w"].dtype == torch.float16
        if codec == "lossless":
            assert torch.equal(back["w"], w)
        else:  # §7's bound: half a step of range / 2**12
            step = float(w.max() - w.min()) / 4096
            assert float((back["w"].float() - w.float()).abs().max()) <= (
                step / 2 + 1e-3)


def test_resharding_and_missing_checkpoints_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "none", device=CPU)
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path / "none")),
                            device=CPU)
    assert mgr.restore_or_none() == (None, None)


def _loop(tmp_path, fail_at=(), save_every=4):
    def step_fn(state, step):
        # deterministic "training" on tensors
        g = torch.from_numpy(np.random.default_rng(step).normal(
            size=tuple(state["w"].shape)))
        return ({"w": state["w"] - 0.1 * g},
                {"gnorm": float(g.abs().sum())})

    mgr = CheckpointManager(CheckpointConfig(str(tmp_path)), device=CPU)
    return TrainLoop(step_fn, mgr, save_every=save_every,
                     preemption=PreemptionSchedule(fail_at=tuple(fail_at)))


def test_preemption_recovery_is_bit_exact(tmp_path):
    init = {"w": torch.zeros((8, 8), dtype=torch.float64)}
    ref = _loop(tmp_path / "a").run(dict(init), 20)
    out = _loop(tmp_path / "b", fail_at=(3, 11, 17)).run(dict(init), 20)
    assert torch.equal(ref["w"], out["w"])


def test_restart_counter_and_too_many_preemptions(tmp_path):
    loop = _loop(tmp_path / "a", fail_at=(5,))
    loop.run({"w": torch.zeros(4)}, 10)
    assert loop.restarts == 1
    loop = _loop(tmp_path / "b", fail_at=(1,), save_every=100)
    loop.max_restarts = 0
    with pytest.raises(Preemption):
        loop.run({"w": torch.zeros(2)}, 5)


def test_straggler_monitor():
    mon = StragglerMonitor(window=16, threshold=3.0)
    for _ in range(16):
        mon.observe(0, 1.0)
    assert not mon.should_skip(16, 0, 1.2)
    assert mon.should_skip(17, 1, 10.0)
    assert mon.skipped == [(17, 1)]


# ---------------------------------------------------------------------------
# training resumed from checkpoints, bit for bit
# ---------------------------------------------------------------------------
def run_train_loop(cfg, root, fail_at, steps=12, save_every=4,
                   codec="lossless", device=CPU, seq=32, batch=2):
    """``TrainLoop`` over ``make_train_step`` (remat "full"), the batch of
    step k ``synth_batch(k)``; returns (final state, loop)."""
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    data = TokenDataConfig(cfg.vocab_size, seq, batch, seed=0)
    raw = make_train_step(cfg, opt_cfg, remat="full")

    def step_fn(state, step):
        state = train_state_from_arrays(cfg, state, device)
        p, o, m = raw(state["params"], state["opt"], synth_batch(data, step))
        return {"params": p, "opt": o}, {k: float(v) for k, v in m.items()}

    mgr = CheckpointManager(CheckpointConfig(str(root), codec=codec),
                            device=device)
    loop = TrainLoop(step_fn, mgr, save_every=save_every,
                     preemption=PreemptionSchedule(fail_at=tuple(fail_at)))
    state = loop.run(build_state(cfg, opt_cfg, 0, device=device), steps)
    return state, loop


@pytest.mark.parametrize("name", ["qwen3-4b", "granite-moe-3b-a800m"])
def test_train_loop_restart_is_bit_exact(tmp_path, name):
    """12 steps, a lossless checkpoint every 4, preempted at steps 5 and
    9 (the smoke config cut by ``tiny``): the final parameters and optimizer state equal an uninterrupted
    run's bit for bit (the batches are stateless in (seed, step), the step
    deterministic), and so does every logged loss."""
    cfg = tiny(get_config(name).smoke())
    want, loop_a = run_train_loop(cfg, tmp_path / "a", ())
    got, loop_b = run_train_loop(cfg, tmp_path / "b", (5, 9))
    assert loop_b.restarts == 2
    assert_trees_equal(flat_np(got), flat_np(want))
    losses_a = {m["step"]: m["loss"] for m in loop_a.metrics_log}
    losses_b = {m["step"]: m["loss"] for m in loop_b.metrics_log}
    assert losses_a == losses_b
    assert latest_step(tmp_path / "b") == 12


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
class _NeverSkips:
    """A ``StragglerMonitor`` whose deadline never passes: the driver's
    timing of the prefetch does not decide which steps run."""

    def __init__(self, *args, **kwargs):
        self.skipped = []

    def should_skip(self, step, host, seconds):
        return False


class _SkipsStep1(_NeverSkips):
    """A monitor that finds step 1's fetch late, whatever it took."""

    def should_skip(self, step, host, seconds):
        if step == 1:
            self.skipped.append((step, host))
            return True
        return False


_DRIVER_ARGV = ["--arch", "qwen3-4b", "--smoke", "--steps", "6", "--batch",
                "2", "--seq", "16", "--ckpt-every", "3", "--ckpt-codec",
                "lossless", "--log-every", "1", "--device", "cpu"]


def test_train_driver_runs_and_resumes(tmp_path, capsys, monkeypatch):
    """``launch.train`` in process on the CPU: 6 steps with a lossless
    checkpoint every 3, then again from the same directory, which resumes
    at step 6 and runs none.  The straggler monitor never skips here (a
    loaded host can make a prefetch late), so every step has a loss."""
    monkeypatch.setattr(train_driver, "StragglerMonitor", _NeverSkips)
    argv = _DRIVER_ARGV + ["--ckpt-dir", str(tmp_path)]
    log = train_driver.main(argv)
    out = capsys.readouterr().out
    assert "arch=qwen3-4b" in out and "final loss" in out
    assert [m["step"] for m in log] == list(range(6))
    assert all(np.isfinite(m["loss"]) for m in log)
    assert latest_step(tmp_path) == 6
    assert train_driver.main(argv) == []
    with pytest.raises(SystemExit):
        train_driver.main(["--arch", "qwen3-4b", "--ckpt-codec", "zip"])


def test_train_driver_logs_a_skipped_step_and_still_resumes(
        tmp_path, capsys, monkeypatch):
    """A straggler skip at step 1: that step is logged as ``{"skipped":
    1.0}`` with no loss, the other steps have finite losses, the run
    checkpoints at 3 and 6 and a second run resumes at 6 and runs none."""
    monkeypatch.setattr(train_driver, "StragglerMonitor", _SkipsStep1)
    argv = _DRIVER_ARGV + ["--ckpt-dir", str(tmp_path)]
    log = train_driver.main(argv)
    assert "final loss" in capsys.readouterr().out
    assert [m["step"] for m in log] == list(range(6))
    skipped = {k: v for k, v in log[1].items() if k != "wall_s"}
    assert skipped == {"skipped": 1.0, "step": 1}
    assert all(np.isfinite(m["loss"]) for i, m in enumerate(log) if i != 1)
    assert latest_step(tmp_path) == 6
    assert train_driver.main(argv) == []


def test_training_entries_default_to_cuda_and_raise_without_a_card(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = get_config("qwen3-4b").smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_state(cfg, AdamWConfig(), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_driver.main(["--arch", "qwen3-4b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        CheckpointManager(CheckpointConfig(str(tmp_path)))
    save_checkpoint(tmp_path, 1, _state(), device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(tmp_path)
