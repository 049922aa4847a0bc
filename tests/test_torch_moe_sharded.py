"""The MoE's sharded dispatch (``models/layers/moe.py::_moe_sharded``) on a
2 x 2 (data, model) mesh of CPU gloo ranks, against the dense path and the
reference's sharded path — the counterpart of
``tests/test_moe_sharded.py`` (``tests/helpers/moe_sharded_check.py``).

* E = 8 experts (expert-parallel: 4 a model rank) and E = 3
  (ffn-parallel: each model rank holds half of every expert's hidden dim).
* At ``capacity_factor=8.0`` no choice is dropped: y and aux within 1e-5
  of the port's dense path on the whole batch (the reference helper's
  bar), and the gradients of the parameters and of x too, with each rank
  differentiating its block's mean loss plus aux and the ranks' gradients
  averaged over the data axis (and summed over "model" for the expert
  weights, whose blocks a rank alone uses), which is what the mesh train
  step does.
* At the default 1.25 the capacity counts the rank's own tokens, so the
  sharded path drops other choices than the dense one: the choices each
  rank keeps equal the reference's sharded path on 4 forced host devices
  (``tests/_torch_moe_ref.py``, a subprocess), and y agrees within 1e-5.

JAX is imported inside the tests: the ranks import this module.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.sharding import dist  # noqa: E402

WORLD, D, F, TOP_K = 4, 32, 64, 2
X_SHAPE = (4, 16, D)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _moe(params: dict):
    from repro_torch.models.layers.common import Init
    from repro_torch.models.layers.moe import MoE
    e = params["router"].shape[-1]
    moe = MoE(Init(None, device="cpu"), D, F, e)
    with torch.no_grad():
        for k, v in params.items():
            getattr(moe, k).copy_(torch.from_numpy(np.array(v)))
    return moe


def _loss(out, w: torch.Tensor, tokens: int) -> torch.Tensor:
    return (out.y * w).sum() / tokens + out.aux_loss


def _grads(moe, x: torch.Tensor, w: torch.Tensor, cf: float) -> dict:
    from repro_torch.models.layers.moe import moe_apply
    x = x.clone().requires_grad_()
    out = moe_apply(moe, x, top_k=TOP_K, capacity_factor=cf)
    _loss(out, w, x.shape[0] * x.shape[1]).backward()
    g = {n: p.grad.numpy().copy() for n, p in moe.named_parameters()}
    g["x"] = x.grad.numpy()
    for p in moe.parameters():
        p.grad = None
    return {"y": out.y.detach().numpy(), "aux": out.aux_loss.item(),
            "grads": g}


def _rank(cases: list) -> list:
    """On every rank of a 2 x 2 mesh: each case's sharded forward and
    backward at 8.0, the forward at 1.25 and the keep masks."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers.moe import (
        _route_and_dispatch, capacity, sharded_layout,
    )
    from repro_torch.sharding.partitioning import set_mesh

    mesh = make_mesh((2, 2), ("data", "model"))
    d_ax, m_ax = mesh.axis("data"), mesh.axis("model")
    out = []
    for params, x, w in cases:
        moe = _moe(params)
        rows = slice(d_ax.index * 2, d_ax.index * 2 + 2)
        xb, wb = torch.from_numpy(x[rows]), torch.from_numpy(w[rows])
        with set_mesh(mesh):
            res = _grads(moe, xb, wb, 8.0)
            with torch.no_grad():
                from repro_torch.models.layers.moe import moe_apply
                y125 = moe_apply(moe, xb, top_k=TOP_K,
                                 capacity_factor=1.25).y.numpy()
        e = params["router"].shape[-1]
        t = xb.shape[0] * xb.shape[1]
        cap = capacity(t, TOP_K, e, 1.25)
        if sharded_layout(e, F, m_ax.size) == "expert":
            e_loc = e // m_ax.size
            e_lo = m_ax.index * e_loc
        else:
            e_lo, e_loc = 0, e
        with torch.no_grad():
            _, (inv, _, _, flat_e) = _route_and_dispatch(
                xb.reshape(t, D), moe.router, TOP_K, e_lo, e_loc, cap)
        mine = (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
        res.update(y125=y125, keep=(inv != e_loc * cap).numpy(),
                   mine=mine.numpy(), coords=(d_ax.index, m_ax.index),
                   e_lo=e_lo, e_loc=e_loc)
        if e_loc < e:
            # a layer whose expert weights hold only the rank's experts
            blk = _moe(params)
            for name in ("gate", "up", "down"):
                w_ = getattr(blk, name).detach().narrow(0, e_lo, e_loc)
                blk.add(name, torch.nn.Parameter(w_.clone()),
                        blk.specs[name])
            with set_mesh(mesh):
                res["block"] = _grads(blk, xb, wb, 8.0)
        out.append(res)
    return out


def _case(e: int, seed: int):
    """The reference's ``moe_init`` parameters and an input, as numpy."""
    import jax
    from repro.models.layers.moe import moe_init
    key = jax.random.PRNGKey(seed)
    p, _ = moe_init(key, D, F, e)
    x = np.asarray(jax.random.normal(key, X_SHAPE)) * 0.5
    w = np.random.default_rng(seed).standard_normal(X_SHAPE)
    return ({k: np.asarray(v) for k, v in p.items()},
            x.astype(np.float32), w.astype(np.float32))


CASES = {"expert-parallel": 8, "ffn-parallel": 3}


@pytest.fixture(scope="module")
def run():
    cases = [_case(e, 0) for e in CASES.values()]
    ranks = dist.spawn(_rank, WORLD, args=(cases,))
    return cases, ranks


@pytest.mark.parametrize("layout", list(CASES))
def test_sharded_equals_dense(run, layout):
    cases, ranks = run
    i = list(CASES).index(layout)
    params, x, w = cases[i]
    moe = _moe(params)
    dense = _grads(moe, torch.from_numpy(x), torch.from_numpy(w), 8.0)
    per = [r[i] for r in ranks]
    y = np.zeros_like(dense["y"])
    for r in per:
        d, m = r["coords"]
        if m == 0:
            y[d * 2:d * 2 + 2] = r["y"]
        else:   # every model rank holds the whole sum
            np.testing.assert_array_equal(r["y"], per[d * 2]["y"])
    assert np.abs(y - dense["y"]).max() <= TOL
    for r in per:
        assert abs(r["aux"] - dense["aux"]) <= TOL
    # the mesh step's reduction of the ranks' gradients
    n_data = 2
    for name, want in dense["grads"].items():
        if name == "x":
            got = np.zeros_like(want)
            for r in per:
                d, m = r["coords"]
                if m == 0:
                    got[d * 2:d * 2 + 2] = r["grads"]["x"] / n_data
            scale = np.abs(want).max()
        else:
            expert = name in ("gate", "up", "down")
            got = sum(r["grads"][name] for r in per
                      if expert or r["coords"][1] == 0) / n_data
            scale = np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= TOL * max(1.0, scale), (name, err, scale)


@pytest.mark.parametrize("layout", list(CASES))
def test_kept_choices_equal_the_reference_sharded_path(run, layout,
                                                       tmp_path):
    cases, ranks = run
    i = list(CASES).index(layout)
    params, x, _ = cases[i]
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, x=x, top_k=TOP_K, capacity_factor=1.25, **params)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, os.path.join(REPO, "tests",
                                                 "_torch_moe_ref.py"),
                    str(src), str(dst)], check=True, env=env, timeout=300)
    ref = np.load(dst)
    y = np.zeros_like(ref["y"])
    dropped = 0
    for r in (rr[i] for rr in ranks):
        d, m = r["coords"]
        np.testing.assert_array_equal(r["keep"], ref[f"keep_d{d}_m{m}"])
        dropped += int((r["mine"] & ~r["keep"]).sum())
        if m == 0:
            y[d * 2:d * 2 + 2] = r["y125"]
    assert np.abs(y - ref["y"]).max() <= TOL
    if layout == "expert-parallel":
        assert dropped > 0       # 1.25 drops choices at these shapes


def test_expert_block_weights_equal_the_whole_layer(run):
    """Expert-parallel: a layer holding only the rank's experts (weights
    of leading dim E / model) gives the outputs and gradients of the whole
    layer on the same mesh rank."""
    cases, ranks = run
    i = list(CASES).index("expert-parallel")
    for r in (r[i] for r in ranks):
        blk, lo, n = r["block"], r["e_lo"], r["e_loc"]
        np.testing.assert_array_equal(blk["y"], r["y"])
        assert blk["aux"] == r["aux"]
        for name, g in blk["grads"].items():
            want = r["grads"][name]
            if name in ("gate", "up", "down"):
                assert not want[:lo].any() and not want[lo + n:].any()
                want = want[lo:lo + n]
            np.testing.assert_array_equal(g, want, err_msg=name)
