"""The port's spec helpers and mesh context (``sharding/partitioning.py``,
``launch/mesh.py::make_production_mesh``) against the reference's
``repro/sharding`` — the counterpart of ``tests/test_sharding.py``'s
partitioning tests (its ``compat`` tests have none: the port has no jax
shims).

* On every leaf of the ten configs' full-size parameter and train-state
  spec trees (the reference's from ``jax.eval_shape``, the port's from
  its ``meta`` model), at the production meshes (16, 16) and
  (2, 16, 16): the axis-filtered, shape-safe spec equals the
  reference's.
* ``test_sharding.py``'s five spec cases.
* A ``Sharding``'s block and gather on an abstract mesh, the mesh context,
  and the production mesh's refusal without enough ranks.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.sharding.partitioning import (  # noqa: E402
    P, Sharding, _divisible_spec, filter_spec, get_abstract_mesh,
    make_abstract_mesh, maybe_shard, set_mesh, shape_safe_shardings,
)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _port_paths(tree, prefix=()) -> dict:
    """{dotted path: leaf} of a port tree (dicts and named tuples)."""
    if isinstance(tree, (P, Sharding)) or not isinstance(tree, (dict, tuple)):
        return {".".join(prefix): tree}
    items = (tree.items() if isinstance(tree, dict)
             else zip(tree._fields, tree))
    out = {}
    for k, v in items:
        out.update(_port_paths(v, prefix + (str(k),)))
    return out


def _ref_paths(tree, is_leaf) -> dict:
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {".".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): leaf for path, leaf in flat}


def _ref_trees(arch: str):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.models import model_init
    from repro.train.loop import init_train_state, train_state_specs
    box = {}

    def init(k):
        p, s = model_init(k, get_arch(arch))
        box["specs"] = s
        return p
    sds = jax.eval_shape(init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    state = jax.eval_shape(init_train_state, sds)
    return state, train_state_specs(box["specs"])


def _port_trees(arch: str):
    from repro_torch.configs import get_arch
    from repro_torch.models import model_init
    from repro_torch.models.layers.common import stacked_tree
    from repro_torch.train.loop import TrainState, train_state_specs
    from repro_torch.train.optimizer import AdamWState
    model, specs = model_init(None, get_arch(arch), device="meta")
    shapes = stacked_tree(model, dict(model.named_parameters()))
    scalar = torch.zeros((), dtype=torch.int32, device="meta")
    return (TrainState(shapes, AdamWState(shapes, shapes, scalar), scalar),
            train_state_specs(specs))


def _arch_names():
    from repro_torch.configs import arch_names
    return arch_names()


@pytest.mark.parametrize("arch", _arch_names())
def test_shape_safe_specs_equal_the_reference(arch):
    from jax.sharding import PartitionSpec
    from repro.sharding import compat
    from repro.sharding.partitioning import (
        _divisible_spec as ref_divisible, filter_spec as ref_filter,
    )
    ref_state, ref_specs = _ref_trees(arch)
    state, specs = _port_trees(arch)
    ref_shapes = _ref_paths(ref_state, None)
    ref_spec = _ref_paths(ref_specs, lambda s: isinstance(s, PartitionSpec))
    shapes, spec = _port_paths(state), _port_paths(specs)
    assert set(shapes) == set(ref_shapes) == set(spec) == set(ref_spec)
    for sizes, names in MESHES.values():
        ref_mesh = compat.make_abstract_mesh(sizes, names)
        mesh = make_abstract_mesh(sizes, names)
        sh = _port_paths(shape_safe_shardings(mesh, state, specs))
        for path, leaf in shapes.items():
            assert tuple(leaf.shape) == tuple(ref_shapes[path].shape), path
            want = ref_divisible(ref_filter(ref_spec[path], names),
                                 ref_shapes[path].shape, ref_mesh)
            assert tuple(sh[path].spec) == tuple(want), (path, sizes)
            assert tuple(filter_spec(spec[path], names)) == tuple(
                ref_filter(ref_spec[path], names)), path


# ----------------------------------------- test_sharding.py's five cases
def test_filter_spec_drops_missing_axes():
    s = P(("pod", "data"), "model", None)
    assert filter_spec(s, ("data", "model")) == P("data", "model", None)
    assert filter_spec(s, ("model",)) == P(None, "model", None)


def test_divisible_spec_drops_indivisible():
    mesh = make_abstract_mesh((2,), ("data",))
    assert _divisible_spec(P("data"), (3,), mesh) == P(None)
    assert _divisible_spec(P("data"), (4,), mesh) == P("data")


def test_divisible_spec_tuple_prefix():
    mesh = make_abstract_mesh((2, 2), ("a", "b"))
    # dim 2: only the first axis of ("a","b") fits
    assert _divisible_spec(P(("a", "b")), (2,), mesh) == P("a")
    assert _divisible_spec(P(("a", "b")), (4,), mesh) == P(("a", "b"))


def test_shape_safe_shardings_tree():
    mesh = make_abstract_mesh((1,), ("data",))
    shapes = {"x": torch.empty(4, 4), "y": torch.empty(3)}
    specs = {"x": P("data", None), "y": P("data")}
    out = shape_safe_shardings(mesh, shapes, specs)
    assert out["x"].spec == P("data", None)


def test_maybe_shard_noop_without_mesh():
    x = torch.ones(4, 4)
    np.testing.assert_array_equal(maybe_shard(x, P("data", None)).numpy(),
                                  x.numpy())
    with set_mesh(make_abstract_mesh((2,), ("data",))):
        assert maybe_shard(x, P("data", None)) is x


# ------------------------------------------------------- the port's own
def test_mesh_context_nests_and_restores():
    assert get_abstract_mesh().empty
    outer = make_abstract_mesh((2, 2), ("data", "model"))
    inner = make_abstract_mesh((4,), ("data",))
    with set_mesh(outer):
        assert get_abstract_mesh() is outer
        with set_mesh(inner):
            assert get_abstract_mesh() is inner
        assert get_abstract_mesh() is outer
    assert get_abstract_mesh().empty


def test_sharding_splits_over_a_tuple_first_axis_major():
    """A dim over ("data", "model") splits into data x model blocks with
    data major, as ``NamedSharding`` lays it out; on an abstract mesh the
    block is rank 0's and the gather counts what a real one would send."""
    mesh = make_abstract_mesh((2, 3), ("data", "model"))
    x = torch.arange(24.0).reshape(12, 2)
    sh = Sharding(mesh, P(("data", "model"), None))
    assert sh.block_shape((12, 2)) == (2, 2)
    np.testing.assert_array_equal(sh.block(x).numpy(), x[:2].numpy())
    full = sh.gather(sh.block(x))
    assert full.shape == (12, 2)
    # model (3) then data (2): 2 blocks of 16 B sent, then 1 of 48 B
    assert mesh.traffic.bytes_sent == 2 * 16 + 1 * 48
    with pytest.raises(ValueError, match="split"):
        Sharding(mesh, P("model")).block(torch.zeros(4))


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import (
        make_production_mesh, production_mesh_shape,
    )
    assert production_mesh_shape() == ((16, 16), ("data", "model"))
    assert production_mesh_shape(True) == ((2, 16, 16),
                                           ("pod", "data", "model"))
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
