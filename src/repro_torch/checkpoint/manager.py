"""Checkpoint manager: atomic save, auto-resume, entropy-coded payloads
(core.tensor_codec) — the port of ``repro.checkpoint.manager``.

Layout:   <dir>/step_<k>/          one directory per step
            manifest.json          pytree structure + dtypes
            state.npz | state.ctz  raw npz or entropy-coded payload
            COMMIT                 written LAST -> crash-safe marker

The layout is the reference's, so either package reads what the other
writes.  A port train state (``{"params": TransformerLM, "opt": {"m",
"v", "step"[, "ef"]}}``, moments by parameter name) is written under the
reference's paths, its blocks stacked on a leading L axis
(``core.tensor_codec.flatten_pytree``).  A bfloat16 leaf is named
``"bfloat16"`` in the manifest and stored in the npz as raw 2-byte
records (numpy ``V2``), which is how numpy stores the reference's
``ml_dtypes`` bfloat16 too; the manifest's type turns them back into
bfloat16 on load.

``load_checkpoint`` returns the reference's pytree (nested dicts) with
torch tensors on ``device``; ``convert.train_state_from_arrays`` turns
that into a train state.  ``shardings`` is the reference's elastic
re-shard: a tree shaped like the state whose leaves are
``launch.shardings.NamedSharding``s (``to_named(mesh,
reference_pspecs(...))``); each leaf becomes a DTensor on that mesh,
every rank cutting its own shard from the leaf it read (each rank reads
the checkpoint, so nothing is sent), its full tensor the saved leaf.

A train state of shards (its ``"params"`` a ``TransformerLM`` cut by
``launch.shardings.shard_params``, its moments the matching shards) is
saved in the same layout: each leaf is gathered whole over the axes its
spec cuts it over, one leaf at a time, and rank 0 alone writes the
checkpoint while the others wait at a barrier (and only rank 0 removes
old steps).  Restoring it onto a mesh is ``load_checkpoint(shardings=
...)``, then ``convert.train_state_shards_from_arrays``.

Guarantees exercised by tests:
  * a save interrupted anywhere leaves no COMMIT -> restore picks the
    previous step (atomicity),
  * entropy-coded checkpoints round-trip bit-exactly (lossless mode).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..core.tensor_codec import (
    CompressedTensors,
    _dtype_name,
    _from_bytes,
    _numpy,
    compress_tensors,
    decompress_tensors,
    flatten_pytree,
    unflatten_pytree,
)
from ..device import resolve_device

__all__ = [
    "CheckpointConfig",
    "CheckpointManager",
    "latest_step",
    "load_checkpoint",
    "save_checkpoint",
]


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep: int = 3
    codec: str | None = None  # None | "lossless" | "q8" .. "q12"


def _codec_bits(codec: str | None) -> int | None:
    if codec is None or codec == "lossless":
        return None
    assert codec.startswith("q"), codec
    return int(codec[1:])


def _npz_array(t: torch.Tensor) -> np.ndarray:
    """What the npz holds for a leaf: its numbers, bfloat16 as ``V2``."""
    a = _numpy(t)
    return a.view(np.dtype("V2")) if t.dtype == torch.bfloat16 else a


def _sharded(state) -> bool:
    """Whether ``state`` is a train state of a rank's shards."""
    params = state.get("params") if isinstance(state, dict) else None
    return getattr(params, "mesh", None) is not None


def _writer(state) -> bool:
    """Whether this process writes ``state``'s checkpoint: always, but for
    a state of shards only on rank 0."""
    if not _sharded(state):
        return True
    import torch.distributed as dist

    return dist.get_rank() == 0


def _gathered_state(state):
    """A train state of shards as the whole one (``{"params": {name:
    tensor}, "opt": {"m", "v", "step"[, "ef"]}}``, CPU tensors) on rank
    0, None on the other ranks: each leaf all-gathered over its spec's
    axes, one at a time (the error feedback is cut like the
    parameters)."""
    from ..launch.shardings import gather_whole

    params = state["params"]
    mesh, specs = params.mesh, params.pspecs
    keep = _writer(state)
    if set(state["opt"]) - {"m", "v", "step", "ef"}:
        raise ValueError("a state of shards carries m, v, step and ef only")

    def whole(named):
        out = {}
        for name, t in named.items():
            w = gather_whole(t, specs[name], mesh)
            if keep:
                out[name] = w.cpu()
            del w
        return out

    opt = {k: whole(t) for k, t in state["opt"].items() if k != "step"}
    out = {"params": whole(dict(params.named_parameters())),
           "opt": dict(opt, step=state["opt"]["step"].cpu())}
    return out if keep else None


def save_checkpoint(directory, step: int, state, codec: str | None = None,
                    device="cuda"):
    """Atomic: write to tmp dir, fsync payload, COMMIT marker, rename.
    ``device`` is where the codec's clustering runs.  A state of shards is
    gathered whole and written by rank 0; every rank returns after the
    commit."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    if _sharded(state):
        import torch.distributed as dist

        whole = _gathered_state(state)
        try:
            if whole is not None:
                save_checkpoint(directory, step, whole, codec, device)
        finally:
            dist.barrier()
        return final
    directory.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=directory))
    try:
        flat = flatten_pytree(state)
        manifest = {
            "step": step,
            "codec": codec,
            "leaves": {k: [list(v.shape), _dtype_name(v)]
                       for k, v in flat.items()},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if codec is None:
            np.savez(tmp / "state.npz",
                     **{k: _npz_array(v) for k, v in flat.items()})
        else:
            comp = compress_tensors(flat, bits=_codec_bits(codec),
                                    device=resolve_device(device))
            (tmp / "state.ctz").write_bytes(comp.to_bytes())
        with open(tmp / "COMMIT", "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(directory) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.iterdir():
        if p.name.startswith("step_") and (p / "COMMIT").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _npz_leaf(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return _from_bytes(a.tobytes(), dtype, a.shape)
    return torch.from_numpy(a)


def load_checkpoint(directory, step: int | None = None, shardings=None,
                    device="cuda"):
    """Load (state pytree, step): the reference's nested dicts, every leaf
    a torch tensor on ``device``.  ``shardings``: optional tree of
    ``NamedSharding``s (or ``None`` leaves, kept whole) to place the
    leaves onto a mesh as DTensors (elastic re-shard path)."""
    dev = resolve_device(device)
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if manifest["codec"] is None:
        with np.load(d / "state.npz") as z:
            flat = {k: _npz_leaf(z[k], manifest["leaves"][k][1])
                    for k in z.files}
    else:
        comp = CompressedTensors.from_bytes((d / "state.ctz").read_bytes())
        flat = decompress_tensors(comp)
    state = unflatten_pytree({k: v.to(dev) for k, v in flat.items()})
    if shardings is not None:
        state = _place(state, shardings)
    return state, step


def _place(state, shardings):
    """``state``'s leaves as DTensors under ``shardings`` (same tree)."""
    if isinstance(state, dict):
        if not isinstance(shardings, dict) or set(state) != set(shardings):
            raise ValueError("shardings must have the state's structure")
        return {k: _place(v, shardings[k]) for k, v in state.items()}
    if shardings is None:
        return state
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(state, shardings.mesh, shardings.placements,
                             src_data_rank=None)


class CheckpointManager:
    """Rolling checkpoints + auto-resume, on ``device``."""

    def __init__(self, cfg: CheckpointConfig, device="cuda"):
        self.cfg = cfg
        self.dir = Path(cfg.directory)
        self.device = resolve_device(device)

    def save(self, step: int, state):
        path = save_checkpoint(self.dir, step, state, self.cfg.codec,
                               self.device)
        if _writer(state):
            self._gc()
        return path

    def restore_or_none(self, shardings=None):
        step = latest_step(self.dir)
        if step is None:
            return None, None
        return load_checkpoint(self.dir, step, shardings, self.device)

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.dir.iterdir()
            if p.name.startswith("step_") and (p / "COMMIT").exists()
        )
        for s in steps[: -self.cfg.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
        # drop orphaned tmp dirs from crashed saves
        for p in self.dir.glob(".tmp_ckpt_*"):
            shutil.rmtree(p, ignore_errors=True)
