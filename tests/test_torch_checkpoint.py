"""The port's checkpointing (``repro_torch.train.checkpoint``) on the CPU:
the reference's checkpoint tests (``tests/test_substrate.py``) on torch
trees, the reference's leaf order, and checkpoints read across packages
in both directions. Every comparison is bitwise (bf16 leaves by their
uint16 bits): a checkpoint stores the bits it was given.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro_torch.train import checkpoint as ckpt


def _tree(seed=0):
    """``tests/test_substrate.py``'s tree as tensors, inserted in the
    same (unsorted) order."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.tensor(rng.standard_normal((4, 3)),
                                     dtype=torch.float32),
                   "b16": torch.tensor(rng.standard_normal(5),
                                       dtype=torch.bfloat16)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def _bits(x) -> np.ndarray:
    """A leaf of either package as comparable host bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _assert_same_leaves(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 10, t, extra={"note": "x"})
    got = ckpt.restore_latest(str(tmp_path), t)
    assert got is not None
    step, tree, extra = got
    assert step == 10 and extra == {"note": "x"}
    assert tree["params"]["b16"].dtype == torch.bfloat16
    assert tree["opt"]["step"].dtype == torch.int32
    _assert_same_leaves(ckpt.tree_flatten(tree)[0], ckpt.tree_flatten(t)[0])


def test_checkpoint_skips_corrupt(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 10, t)
    ckpt.save(str(tmp_path), 20, _tree(1))
    ckpt.corrupt_for_test(str(tmp_path), 20)
    step, tree, _ = ckpt.restore_latest(str(tmp_path), t)
    assert step == 10  # newest valid, not newest
    _assert_same_leaves(ckpt.tree_flatten(tree)[0], ckpt.tree_flatten(t)[0])


def test_checkpoint_rejects_shape_mismatch(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t)
    other = {"params": {"w": torch.zeros((2, 2)),
                        "b16": torch.zeros(5, dtype=torch.bfloat16)},
             "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    assert ckpt.restore_latest(str(tmp_path), other) is None


def test_checkpoint_rejects_dtype_mismatch(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t)
    for leaf, dtype in (("w", torch.float64), ("b16", torch.float16)):
        other = _tree()
        other["params"][leaf] = other["params"][leaf].to(dtype)
        assert ckpt.restore_latest(str(tmp_path), other) is None
    other = _tree()
    other["opt"]["step"] = torch.tensor(7, dtype=torch.int64)
    assert ckpt.restore_latest(str(tmp_path), other) is None


def test_checkpoint_async(tmp_path):
    """The snapshot is taken before the writer thread starts: the tree is
    overwritten in place right after ``save`` returns, and the checkpoint
    holds the values it had at the call."""
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    t = _tree()
    want = ckpt.tree_flatten(_tree())[0]
    saver.save(3, t)
    for leaf in ckpt.tree_flatten(t)[0]:
        leaf.zero_()
    saver.wait()
    assert ckpt.available_steps(str(tmp_path)) == [3]
    _, tree, _ = ckpt.restore_latest(str(tmp_path), _tree())
    _assert_same_leaves(ckpt.tree_flatten(tree)[0], want)


def test_checkpoint_async_surfaces_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = ckpt.AsyncCheckpointer(str(blocker))
    saver.save(1, _tree())
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()  # the error is raised once


def test_checkpoint_elastic_reshard(tmp_path):
    """Saved whole -> restoring under a different dp width is just a
    different slicing of the same arrays."""
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    _, tree, _ = ckpt.restore_latest(str(tmp_path), t)
    w = tree["params"]["w"].numpy()
    s4 = np.concatenate(np.split(w, 4, axis=0))
    s2 = np.concatenate(np.split(w, 2, axis=0))
    np.testing.assert_array_equal(s4, s2)


def test_restore_lands_on_the_like_leaves(tmp_path):
    """Meta tensors stand in for shapes (the reference's
    ShapeDtypeStructs) and restore onto the CPU, in their dtype."""
    t = _tree()
    ckpt.save(str(tmp_path), 2, t)
    like = ckpt.tree_map(lambda x: torch.empty_like(x, device="meta"), t)
    _, tree, _ = ckpt.restore_latest(str(tmp_path), like)
    for got, want in zip(ckpt.tree_flatten(tree)[0],
                         ckpt.tree_flatten(t)[0]):
        assert got.device.type == "cpu" and got.dtype == want.dtype
    _assert_same_leaves(ckpt.tree_flatten(tree)[0], ckpt.tree_flatten(t)[0])


Pair = collections.namedtuple("Pair", "b a")


def _nested(rng):
    """A tree of every container kind, its dict keys inserted out of
    sorted order, with numpy leaves (f32, f64, int64, bool) that carry
    their position."""
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "zeta": [mk(2), (mk(3), mk(1, 2)), {"y": mk(4), "x": mk(2, 2)}],
        "alpha": {"b": np.arange(3, dtype=np.int64), "a": None,
                  "c": np.array([True, False])},
        "mid": collections.OrderedDict(
            [("q", mk(2)), ("p", rng.standard_normal(2))]),
        "pair": Pair(mk(1), mk(5)),
    }


def test_leaf_order_is_the_references():
    tree = _nested(np.random.default_rng(0))
    leaves, treedef = ckpt.tree_flatten(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert [id(x) for x in leaves] == [id(x) for x in want]
    back = ckpt.tree_unflatten(treedef, leaves)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    assert ckpt.tree_flatten(back)[0] == leaves


def _pair_trees(seed=0):
    """One nested tree in both packages, with equal bits: a bf16 leaf, an
    int32 scalar, lists, a tuple and keys inserted out of order."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b16 = np.asarray(jnp.asarray(rng.standard_normal(7), jnp.bfloat16))
    mu = [rng.standard_normal(2).astype(np.float32) for _ in range(3)]
    pair = (rng.standard_normal((2, 2)).astype(np.float32),
            np.arange(5, dtype=np.int32))
    t16 = torch.from_numpy(b16.view(np.int16).copy()).view(torch.bfloat16)
    jax_tree = {
        "params": {"w": jnp.asarray(w), "b16": jnp.asarray(b16)},
        "opt": {"step": jnp.asarray(7, jnp.int32),
                "mu": [jnp.asarray(x) for x in mu],
                "pair": tuple(jnp.asarray(x) for x in pair)},
    }
    torch_tree = {
        "params": {"w": torch.from_numpy(w), "b16": t16},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "mu": [torch.from_numpy(x) for x in mu],
                "pair": tuple(torch.from_numpy(x) for x in pair)},
    }
    return jax_tree, torch_tree


def test_jax_writes_the_port_restores(tmp_path):
    jax_tree, torch_tree = _pair_trees()
    jckpt.save(str(tmp_path), 4, jax_tree, extra={"by": "jax"})
    like = ckpt.tree_map(torch.zeros_like, torch_tree)
    step, tree, extra = ckpt.restore_latest(str(tmp_path), like)
    assert step == 4 and extra == {"by": "jax"}
    assert isinstance(tree["opt"]["pair"], tuple)
    assert tree["params"]["b16"].dtype == torch.bfloat16
    _assert_same_leaves(ckpt.tree_flatten(tree)[0],
                        jax.tree_util.tree_leaves(jax_tree))


def test_the_port_writes_jax_restores(tmp_path):
    jax_tree, torch_tree = _pair_trees(1)
    ckpt.save(str(tmp_path), 9, torch_tree, extra={"by": "torch"})
    like = jax.tree_util.tree_map(jnp.zeros_like, jax_tree)
    step, tree, extra = jckpt.restore_latest(str(tmp_path), like)
    assert step == 9 and extra == {"by": "torch"}
    assert tree["params"]["b16"].dtype == jnp.bfloat16
    _assert_same_leaves(jax.tree_util.tree_leaves(tree),
                        ckpt.tree_flatten(torch_tree)[0])
