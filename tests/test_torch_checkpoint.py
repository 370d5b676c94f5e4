"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint.ckpt``): the same layout, digests over the
same bytes, files that either package writes restored by the other, bf16
leaves carried bit for bit, and the twins of the reference's tests.
Everything is compared exactly."""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as R
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    tree_leaves,
)
from repro_torch.configs import get_arch
from repro_torch.launch.steps import init_train_state
from repro_torch.models import init_params


def _numpy_tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(0, 1, 10).astype(np.float32),
            "b": {"c": rng.integers(-9, 9, (3, 4)).astype(np.int32),
                  "d": rng.normal(0, 1, (2, 2)).astype(np.float32)},
            "step": np.int32(7)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _manifest(step_dir) -> dict:
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        return json.load(f)


# --------------------------------------------------------------------------- #
# twins of the reference's tests
# --------------------------------------------------------------------------- #
def test_checkpoint_roundtrip_and_digest(tmp_path):
    tree = _torch_tree(_numpy_tree())
    step_dir = save_checkpoint(str(tmp_path), 7, tree)
    assert os.path.basename(step_dir) == "step_000007"
    assert sorted(os.listdir(step_dir)) == ["COMMIT", "MANIFEST.json",
                                            "shard_000.npz"]
    like = _zeros_like(tree)
    out, step = restore_checkpoint(str(tmp_path), like)
    assert step == 7 and out is like  # written in place
    _equal(out, _numpy_tree())


def test_corrupt_leaf_is_refused(tmp_path):
    tree = _torch_tree(_numpy_tree())
    step_dir = save_checkpoint(str(tmp_path), 3, tree, shards=2)
    shard = os.path.join(step_dir, "shard_001.npz")
    with np.load(shard) as z:
        payload = {k: z[k].copy() for k in z.files}
    name = sorted(payload)[0]
    payload[name] = payload[name] + 1
    np.savez(shard, **payload)
    with pytest.raises(ValueError, match="corruption"):
        restore_checkpoint(str(tmp_path), _zeros_like(tree))


def test_torn_checkpoint_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 10, {"a": torch.zeros(4)})
    torn = tmp_path / "step_000020"
    torn.mkdir()
    (torn / "MANIFEST.json").write_text("{}")
    (tmp_path / "step_000030.tmp").mkdir()
    assert latest_step(str(tmp_path)) == 10
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "missing"), {"a": torch.zeros(4)})


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (5, 10, 15):
        ck.save(s, {"x": torch.full((3,), s)})
    ck.wait()
    assert latest_step(str(tmp_path)) == 15
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [10, 15]  # gc kept the last 2


def test_async_snapshot_precedes_an_in_place_update(tmp_path):
    """``save`` copies the leaves before it returns: an in-place update
    right after it does not reach the file."""
    x = torch.arange(1 << 16, dtype=torch.float32)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"x": x})
    x.mul_(-1)
    ck.wait()
    like = {"x": torch.zeros_like(x)}
    restore_checkpoint(str(tmp_path), like)
    np.testing.assert_array_equal(like["x"].numpy(),
                                  np.arange(1 << 16, dtype=np.float32))


def test_restore_refuses_another_shape_or_dtype(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(5)})
    with pytest.raises(ValueError, match="float32"):
        restore_checkpoint(str(tmp_path),
                           {"a": torch.zeros(4, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(4),
                                           "b": torch.zeros(1)})


# --------------------------------------------------------------------------- #
# across the packages
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shards", [1, 3])
def test_reference_files_restore_in_the_port(tmp_path, shards):
    tree = _numpy_tree(1)
    step_dir = R.save_checkpoint(str(tmp_path), 12, tree, shards=shards)
    like = _zeros_like(_torch_tree(tree))
    out, step = restore_checkpoint(str(tmp_path), like)
    assert step == 12
    _equal(out, tree)
    # the same digests over the same leaves, in the same order
    port_dir = save_checkpoint(str(tmp_path / "port"), 12,
                               _torch_tree(tree), shards=shards)
    assert _manifest(port_dir)["digests"] == _manifest(step_dir)["digests"]


@pytest.mark.parametrize("shards", [1, 2])
def test_port_files_restore_in_the_reference(tmp_path, shards):
    tree = _numpy_tree(2)
    save_checkpoint(str(tmp_path), 4, _torch_tree(tree), shards=shards)
    assert R.latest_step(str(tmp_path)) == 4
    out, step = R.restore_checkpoint(str(tmp_path), tree)
    assert step == 4
    for k in ("a", "step"):
        np.testing.assert_array_equal(out[k], tree[k])
        assert out[k].dtype == tree[k].dtype
    for k in ("c", "d"):
        np.testing.assert_array_equal(out["b"][k], tree["b"][k])
        assert out["b"][k].dtype == tree["b"][k].dtype


def test_reference_bf16_files_restore_bit_for_bit(tmp_path):
    rng = np.random.default_rng(3)
    ref = {"w": jnp.asarray(rng.normal(0, 1, (5, 7)), dtype=jnp.bfloat16),
           "v": jnp.asarray(rng.normal(0, 1, 9), dtype=jnp.bfloat16),
           "m": jnp.asarray(rng.normal(0, 1, 3), dtype=jnp.float32)}
    step_dir = R.save_checkpoint(str(tmp_path), 2,
                                 {k: np.asarray(v) for k, v in ref.items()})
    like = {"w": torch.zeros((5, 7), dtype=torch.bfloat16),
            "v": torch.zeros(9, dtype=torch.bfloat16),
            "m": torch.zeros(3)}
    restore_checkpoint(str(tmp_path), like)
    for k in ("w", "v"):
        assert like[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            like[k].view(torch.int16).numpy().view(np.uint16),
            np.asarray(ref[k]).view(np.uint16))
    np.testing.assert_array_equal(like["m"].numpy(), np.asarray(ref["m"]))
    # the port writes the same bits, hashes them to the same digests and
    # records the dtype
    port_dir = save_checkpoint(str(tmp_path / "port"), 2, like)
    manifest = _manifest(port_dir)
    assert manifest["digests"] == _manifest(step_dir)["digests"]
    assert manifest["dtypes"] == {"leaf_00000": "float32",
                                  "leaf_00001": "bfloat16",
                                  "leaf_00002": "bfloat16"}
    back = {k: torch.zeros_like(v) for k, v in like.items()}
    restore_checkpoint(str(tmp_path / "port"), back)
    for k in like:
        assert torch.equal(back[k], like[k])


def test_train_state_round_trip(tmp_path):
    """A bf16 model's train state (the module's parameters by name, the
    AdamW moments, the counters) restores into a fresh state exactly."""
    cfg = dataclasses.replace(get_arch("qwen2.5-3b").reduced(),
                              dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    state = init_train_state(cfg, init_params(cfg, g, device="cpu"))
    with torch.no_grad():
        for t in state["opt"]["m"].values():
            t.normal_(generator=g)
        state["opt"]["count"].fill_(9)
        state["step"].fill_(9)
    save_checkpoint(str(tmp_path), 9, state)
    fresh = init_train_state(cfg, init_params(
        cfg, torch.Generator().manual_seed(1), device="cpu"))
    restore_checkpoint(str(tmp_path), fresh)
    got, want = tree_leaves(fresh), tree_leaves(state)
    assert len(got) == len(want) == 3 * len(list(
        state["params"].parameters())) + 2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_tree_leaves_order():
    """Dict keys sorted, lists in order, a module as its named
    parameters."""
    a, b, c = torch.zeros(1), torch.ones(1), torch.full((1,), 2.0)
    assert [float(t) for t in tree_leaves({"z": a, "b": [b, c]})] == \
        [1.0, 2.0, 0.0]
    with pytest.raises(TypeError):
        tree_leaves({"a": 1.0})


# --------------------------------------------------------------------------- #
# train states across the packages: the reference's layout
# --------------------------------------------------------------------------- #
CROSS = [("qwen2.5-3b", "float32"), ("qwen2.5-3b", "bfloat16"),
         ("mamba2-370m", "float32"), ("mamba2-370m", "bfloat16"),
         ("zamba2-1.2b", "float32"), ("zamba2-1.2b", "bfloat16"),
         ("moonshot-v1-16b-a3b", "bfloat16")]
#: layers of a reduced config, where ``reduced()``'s are too few: zamba2 at
#: 14 has two segments, the first with its shared block in two layers
LAYERS = {"zamba2-1.2b": 14}
MOE = "moonshot-v1-16b-a3b"


def _reference_train_state(arch: str, dtype: str, seed: int):
    """The reference's reduced config and its ``init_train_state`` with
    numpy leaves: its own parameters, the AdamW moments drawn (so every
    leaf is distinct) and the counters at 3."""
    import jax

    from repro.configs.base import get_arch as jax_get_arch
    from repro.launch import steps as RS
    from repro.models import init_params as jax_init_params

    cfg = dataclasses.replace(jax_get_arch(arch).reduced(), dtype=dtype,
                              n_layers=LAYERS.get(arch, jax_get_arch(
                                  arch).reduced().n_layers))
    state = jax.tree.map(np.asarray, RS.init_train_state(
        cfg, jax_init_params(cfg, jax.random.PRNGKey(seed))))
    rng = np.random.default_rng(seed)
    for key in ("m", "v"):
        state["opt"][key] = jax.tree.map(
            lambda a: rng.normal(0, 1, a.shape).astype(np.float32),
            state["opt"][key])
    state["opt"]["count"] = np.int32(3)
    state["step"] = np.int32(3)
    return cfg, state


def _bits(a) -> np.ndarray:
    """A leaf's bytes as integers (bf16 leaves load as 2-byte voids)."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind in "Vf":
        return a.view(np.uint16)
    return a.view(np.dtype(f"u{a.dtype.itemsize}")) if a.ndim else a


def _port_state_equals(state, ref_state, model) -> None:
    """Every leaf of the port's ``state`` bit for bit the reference's."""
    from repro_torch.models.convert import reference_leaves

    named = dict(model.named_parameters())
    trees = ((named, ref_state["params"]),
             (state["opt"]["m"], ref_state["opt"]["m"]),
             (state["opt"]["v"], ref_state["opt"]["v"]))
    for got, want in trees:
        want = reference_leaves(want, model)
        assert sorted(got) == sorted(want)
        for name, leaf in want.items():
            t = got[name].detach()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16).numpy().view(np.uint16)
            else:
                t = t.numpy()
            np.testing.assert_array_equal(_bits(t), _bits(leaf),
                                          err_msg=name)
    assert int(state["step"]) == int(ref_state["step"])
    assert int(state["opt"]["count"]) == int(ref_state["opt"]["count"])


@pytest.mark.parametrize("arch,dtype", CROSS)
def test_reference_train_state_restores_in_the_port(tmp_path, arch, dtype):
    """A train state written by the reference's ``save_checkpoint`` (from
    its ``init_train_state``) restores into a fresh port train state, leaf
    for leaf; the port's own layout of that state holds other leaves (as
    many, in another order, where every segment has one layer, as
    moonshot's)."""
    from repro_torch.checkpoint import restore_reference_checkpoint
    from repro_torch.models.convert import config_from_reference

    cfg, ref_state = _reference_train_state(arch, dtype, seed=1)
    R.save_checkpoint(str(tmp_path), 3, ref_state)
    port_cfg = config_from_reference(cfg)
    state = init_train_state(port_cfg, init_params(
        port_cfg, torch.Generator().manual_seed(7), device="cpu"))
    # moonshot's reduced segments hold one layer each: its stacked leaves
    # are as many as the port's, and the first to differ is a shape
    with pytest.raises(ValueError, match="shape" if arch == MOE else
                       "leaves"):
        restore_checkpoint(str(tmp_path), state)
    out, step = restore_reference_checkpoint(str(tmp_path), state)
    assert out is state and step == 3
    _port_state_equals(state, ref_state, state["params"])


@pytest.mark.parametrize("arch,dtype", CROSS)
def test_port_train_state_restores_in_the_reference(tmp_path, arch, dtype):
    """The port's reference-layout write restores in the reference's
    ``restore_checkpoint`` against its own ``init_train_state``, leaf for
    leaf, with the reference's digests; the port reads it back too."""
    import jax

    from repro_torch.checkpoint import (
        restore_reference_checkpoint,
        save_reference_checkpoint,
    )
    from repro_torch.models.convert import train_state_from_reference

    cfg, ref_state = _reference_train_state(arch, dtype, seed=2)
    state = train_state_from_reference(ref_state, cfg, device="cpu")
    step_dir = save_reference_checkpoint(str(tmp_path / "port"), 3, state)
    like = jax.tree.map(np.zeros_like, ref_state)
    out, step = R.restore_checkpoint(str(tmp_path / "port"), like)
    assert step == 3
    want_leaves = jax.tree_util.tree_leaves(ref_state)
    got_leaves = jax.tree_util.tree_leaves(out)
    assert len(got_leaves) == len(want_leaves)
    for got, want in zip(got_leaves, want_leaves):
        assert got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    ref_dir = R.save_checkpoint(str(tmp_path / "ref"), 3, ref_state)
    assert _manifest(step_dir)["digests"] == _manifest(ref_dir)["digests"]
    fresh = train_state_from_reference(
        _reference_train_state(arch, dtype, seed=5)[1], cfg, device="cpu")
    restore_reference_checkpoint(str(tmp_path / "port"), fresh)
    _port_state_equals(fresh, ref_state, fresh["params"])


def test_reference_layout_leaf_counts():
    """The reduced qwen2.5-3b's train state: 44 leaves in the reference's
    layout (blocks stacked), 80 in the port's own (one per layer)."""
    from repro_torch.models.convert import reference_state_tree

    cfg = get_arch("qwen2.5-3b").reduced()
    state = init_train_state(cfg, init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    assert len(tree_leaves(reference_state_tree(state))) == 44
    assert len(tree_leaves(state)) == 80


def test_reference_layout_refuses_adafactor(tmp_path):
    from repro_torch.checkpoint import save_reference_checkpoint
    from repro_torch.optim import adafactor_init

    cfg = get_arch("qwen2.5-3b").reduced()
    state = init_train_state(cfg, init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    state["opt"] = adafactor_init(dict(state["params"].named_parameters()))
    with pytest.raises(NotImplementedError, match="Adafactor"):
        save_reference_checkpoint(str(tmp_path), 1, state)
