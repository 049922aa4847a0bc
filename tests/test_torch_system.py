"""End-to-end tests of the port — the counterpart of
``tests/test_system.py``: the paper's pipeline (similarity -> HAP ->
hierarchy -> purity, against HK-Means) on half of Aggregation, the LM path
(config -> train -> checkpoint -> restore -> serve) and the fault
restart, all on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.baselines import hierarchical_kmeans  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    train_state_from_numpy, train_state_to_numpy,
)
from repro_torch.core import (  # noqa: E402
    link_hierarchy, pairwise_similarity, purity, run_hap, set_preferences,
    stack_levels,
)
from repro_torch.core.preferences import median_preference  # noqa: E402
from repro_torch.data import aggregation_like  # noqa: E402
from repro_torch.data.pipeline import synthetic_token_stream  # noqa: E402
from repro_torch.models import Mode, model_init  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.loop import (  # noqa: E402
    init_train_state, make_train_step,
)


def test_paper_pipeline_end_to_end():
    """§4.2's comparison, in miniature: HAP vs HK-Means on Aggregation;
    HAP's exemplars from the reference's similarity equal the
    reference's (ROADMAP C2: shared S, parallel order)."""
    import jax.numpy as jnp
    from repro.core import (
        pairwise_similarity as ref_ps, run_hap as ref_hap,
        set_preferences as ref_sp, stack_levels as ref_stack,
    )
    from repro.core.preferences import median_preference as ref_mp
    x, y = aggregation_like()
    sub = slice(0, 394)  # half the set
    xs, ys = x[sub], y[sub]
    s = pairwise_similarity(torch.as_tensor(xs))
    s = set_preferences(s, median_preference(s))
    res = run_hap(stack_levels(s, 3), iterations=40, damping=0.7,
                  order="parallel")
    hier = link_hierarchy(res.exemplars.numpy())
    hap_purity = purity(hier.labels[0], ys)

    hk = hierarchical_kmeans(xs, levels=3, branch=3, device="cpu")
    hk_purity = purity(hk.labels[0], ys)

    assert hap_purity > 0.9
    # "competitive with HK-Means" (paper Fig 5.1): within 10 points
    assert hap_purity > hk_purity - 0.1
    # hierarchy aggregates
    assert hier.n_clusters[0] >= hier.n_clusters[-1]

    rs = ref_ps(jnp.asarray(xs))
    rs = ref_sp(rs, ref_mp(rs))
    want = ref_hap(ref_stack(rs, 3), iterations=40, damping=0.7,
                   order="parallel").exemplars
    got = run_hap(stack_levels(torch.as_tensor(np.asarray(rs)), 3),
                  iterations=40, damping=0.7, order="parallel").exemplars
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lm_train_checkpoint_restore_serve(tmp_path):
    cfg = get_arch("tinyllama-1.1b-smoke")
    params, _ = model_init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    state = init_train_state(params)
    step = make_train_step(cfg, Mode("train", "dense"),
                           lr_kwargs={"peak": 5e-3, "warmup": 2,
                                      "total": 20})
    stream = synthetic_token_stream(cfg.vocab, 4, 48, seed=1)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for i in range(8):
        state, metrics = step(state, {"tokens": torch.as_tensor(
            next(stream))})
        assert bool(metrics["grad_finite"])
        if (i + 1) % 4 == 0:
            mgr.save(i + 1, train_state_to_numpy(state))
    step_no, tree = mgr.restore_latest(train_state_to_numpy(state))
    assert step_no == 8
    restored = train_state_from_numpy(tree, cfg, "cpu")
    d = max(float((a - b).detach().abs().max()) for a, b in zip(
        state.params.parameters(), restored.params.parameters()))
    assert d == 0.0

    engine = ServeEngine(cfg, restored.params, max_len=64)
    prompts = torch.randint(0, cfg.vocab, (2, 12),
                            generator=torch.Generator().manual_seed(0),
                            dtype=torch.int32)
    out = engine.generate(prompts, steps=4)
    assert out.shape == (2, 4)


def test_fault_restart_resumes():
    from repro_torch.runtime.fault import FaultPolicy, run_with_restarts
    calls = {"n": 0}

    def flaky(_):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("simulated worker failure")
        return "done"

    out = run_with_restarts(flaky, lambda: None,
                            FaultPolicy(max_restarts=5, backoff_s=0.0))
    assert out == "done" and calls["n"] == 3
