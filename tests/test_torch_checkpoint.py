"""The port's checkpoints (``repro_torch.checkpoint``) on the reference's
checkpoint cases — roundtrip, a crash mid-save skipped, corruption caught
by the checksum, a structure mismatch refused, keep-k with async saves —
and against the reference's layout: the same directory and file names,
manifest keys, codec and per-leaf sha256 of the same bytes.  The elastic
restore onto another mesh (``shardings=``) is held on a 4-rank gloo group
in ``tests/test_torch_partition_serve.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as ref_save
from repro_torch.checkpoint import (
    CheckpointManager,
    flatten,
    have_zstd,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

import _torch_reference  # noqa: F401,E402  (one torch thread per test process)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
        "nested": {"b": torch.from_numpy(rng.integers(0, 5, (3,)).astype(np.int32))},
        "scalar": torch.tensor(7, dtype=torch.int32),
    }


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    target = _zeros_like(t)
    restored = restore_checkpoint(str(tmp_path), 3, target)
    assert restored is target  # written in place
    for (ka, a), (kb, b) in zip(flatten(t).items(), flatten(restored).items()):
        assert ka == kb
        assert torch.equal(a, b)


def test_roundtrip_keeps_bfloat16_bits(tmp_path):
    """bfloat16 leaves (the full-width params), which numpy cannot hold,
    come back bit for bit; so do float32 state leaves beside them."""
    g = torch.Generator().manual_seed(1)
    t = {"params": {"w": torch.randn(5, 3, generator=g).to(torch.bfloat16)},
         "opt": {"m": {"w": torch.randn(5, 3, generator=g)}},
         "step": torch.tensor(2, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 2, t)
    manifest = json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())
    assert [m["name"] for m in manifest["leaves"]] == ["opt/m/w", "params/w", "step"]
    assert [m["dtype"] for m in manifest["leaves"]] == ["float32", "bfloat16", "int32"]
    target = _zeros_like(t)
    restore_checkpoint(str(tmp_path), 2, target)
    for a, b in zip(flatten(t).values(), flatten(target).values()):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8) if a.dim() else a,
                                                  b.view(torch.uint8) if b.dim() else b)


def test_latest_skips_uncommitted(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    save_checkpoint(str(tmp_path), 2, t)
    # simulate a crash mid-save: step 3 exists without COMMITTED
    d = tmp_path / "step_00000003"
    shutil.copytree(tmp_path / "step_00000002", d)
    os.remove(d / "COMMITTED")
    assert latest_step(str(tmp_path)) == 2
    assert latest_step(str(tmp_path / "missing")) is None


def test_checksum_detects_corruption_any_codec(tmp_path):
    """Flip one byte of a leaf payload (re-compressing when the codec is
    zstd) and expect a checksum error."""
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    d = tmp_path / "step_00000001"
    target = sorted(p for p in os.listdir(d) if p.startswith("leaf_"))[0]
    with open(d / target, "rb") as f:
        payload = f.read()
    if target.endswith(".zst"):
        import zstandard

        data = bytearray(zstandard.ZstdDecompressor().decompress(payload))
        data[0] ^= 0xFF
        payload = zstandard.ZstdCompressor().compress(bytes(data))
    else:
        data = bytearray(payload)
        data[0] ^= 0xFF
        payload = bytes(data)
    with open(d / target, "wb") as f:
        f.write(payload)
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(str(tmp_path), 1, _zeros_like(t))


def test_structure_mismatch_rejected(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(4, 8)})
    renamed = _zeros_like(t)
    renamed["c"] = renamed.pop("a")
    with pytest.raises(ValueError, match="named"):
        restore_checkpoint(str(tmp_path), 1, renamed)
    reshaped = _zeros_like(t)
    reshaped["a"] = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), 1, reshaped)
    retyped = _zeros_like(t)
    retyped["a"] = torch.zeros(4, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), 1, retyped)


def test_manager_keep_k_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    mgr.wait()
    mgr._gc()
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(tmp_path) if n.startswith("step_")
    )
    assert steps == [3, 4]
    restored = mgr.restore(_zeros_like(t))
    assert torch.equal(restored["a"], t["a"])
    mgr.close()


def test_async_save_snapshots_the_tree_at_save_time(tmp_path):
    """The async save copies the tree to the host when ``save`` returns:
    writing into the tensors afterwards (the next step's in-place update)
    does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    t = _tree()
    want = t["a"].clone()
    mgr.save(1, t)
    t["a"].add_(1.0)
    mgr.wait()
    restored = mgr.restore(_zeros_like(t), step=1)
    assert torch.equal(restored["a"], want)
    assert mgr.restore(_zeros_like(t), step=None) is not None
    mgr.close()
    assert CheckpointManager(str(tmp_path / "empty")).restore(_zeros_like(t)) is None


def test_layout_is_the_references(tmp_path):
    """The same tree saved by both packages: the same directory and leaf
    file names, manifest codec and step, shapes, dtypes and sha256 of every
    leaf (the reference's leaves in its sorted-key order, which the port's
    sorted names follow)."""
    t = _tree(3)
    save_checkpoint(str(tmp_path / "port"), 5, t)
    ref_tree = {"a": jnp.asarray(t["a"].numpy()),
                "nested": {"b": jnp.asarray(t["nested"]["b"].numpy())},
                "scalar": jnp.asarray(7, jnp.int32)}
    ref_save(str(tmp_path / "ref"), 5, ref_tree)
    got_dir, want_dir = tmp_path / "port" / "step_00000005", tmp_path / "ref" / "step_00000005"
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    got = json.loads((got_dir / "manifest.json").read_text())
    want = json.loads((want_dir / "manifest.json").read_text())
    assert got["codec"] == want["codec"] == ("zstd" if have_zstd() else "raw")
    assert got["step"] == want["step"] == 5
    for g, w in zip(got["leaves"], want["leaves"]):
        assert (g["file"], g["shape"], g["dtype"], g["sha256"]) == \
            (w["file"], w["shape"], w["dtype"], w["sha256"])
    raw = (got_dir / got["leaves"][0]["file"]).read_bytes()
    if got["codec"] == "raw":
        assert hashlib.sha256(raw).hexdigest() == got["leaves"][0]["sha256"]


def test_flatten_refuses_what_is_not_a_tree():
    with pytest.raises(TypeError, match="dicts and tensors"):
        flatten({"a": [torch.zeros(1)]})
