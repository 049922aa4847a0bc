"""The port's dense LM families against the JAX reference, on the CPU
(``-smoke`` configs; tolerances in ``tests/_torch_lm.py``): tinyllama,
granite, internlm2, qwen2.5 and internvl2 (the VLM's image-prefix stub).
Also the reference's own model properties (tests/test_models_smoke.py) on
the port: blockwise attention equals dense, the sliding window restricts
attention, the list state layout equals the stacked one, and the ten
full-size configs hit their published parameter counts (counted on the
``meta`` device, nothing allocated)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_lm import (  # noqa: E402,F401  (the shared per-arch tests)
    B, make_inputs, make_pair, one_torch_thread, pair_fixture, port_run, port_state,
    prefill_inputs, test_decode_matches_full_forward,
    test_decode_matches_reference, test_forward_matches_reference,
    test_params_round_trip, test_spec_tree_mirrors_reference,
)
from repro_torch.configs import ARCHS, SHAPES, get_arch  # noqa: E402
from repro_torch.models import (  # noqa: E402
    Mode, input_sharding, input_specs, make_inputs as model_inputs,
    model_apply, model_init,
)
from repro_torch.models.layers.common import count_params  # noqa: E402

pair = pytest.fixture(scope="module", params=[
    "tinyllama-1.1b", "granite-3-8b", "internlm2-20b", "qwen2.5-32b",
    "internvl2-2b"])(pair_fixture)


@pytest.fixture(scope="module")
def tiny():
    return make_pair("tinyllama-1.1b-smoke")


def test_blockwise_attention_matches_dense(tiny):
    inputs = make_inputs(tiny.cfg, B, 64)
    dense, _, _ = port_run(tiny, inputs)
    block, _, _ = port_run(tiny, inputs, ("train", "blockwise", 16, 16))
    np.testing.assert_allclose(block, dense, atol=3e-2, rtol=3e-2)


def test_sliding_window_restricts_attention():
    """With window W over 2 layers, the last token cannot see token 0."""
    p = make_pair("tinyllama-1.1b-smoke", window=8, n_layers=2)
    inputs = make_inputs(p.cfg, 1, 32)
    out1, _, _ = port_run(p, inputs)
    inputs["tokens"][0, 0] = (inputs["tokens"][0, 0] + 1) % p.cfg.vocab
    out2, _, _ = port_run(p, inputs)
    np.testing.assert_allclose(out1[0, -1], out2[0, -1], atol=1e-3)
    assert not np.allclose(out1[0, 1], out2[0, 1], atol=1e-4)


def test_list_layout_decode_matches_stacked(tiny):
    inputs = make_inputs(tiny.cfg, B, 16)
    pre, dec = prefill_inputs(tiny.cfg, inputs, 15)
    outs = {}
    for layout in ("stacked", "list"):
        st = port_state(tiny, B, 20, layout)
        _, st, _ = port_run(tiny, pre, ("prefill", "dense"), st)
        outs[layout], _, _ = port_run(tiny, dec, ("decode", "dense"), st)
    np.testing.assert_allclose(outs["list"], outs["stacked"], atol=2e-2,
                               rtol=2e-2)


def test_param_counts_match_published():
    expected = {
        "tinyllama-1.1b": (0.9e9, 1.2e9),
        "granite-3-8b": (7.5e9, 8.7e9),
        "internlm2-20b": (18e9, 21e9),
        "qwen2.5-32b": (31e9, 34e9),
        "mixtral-8x22b": (135e9, 145e9),
        "qwen3-moe-235b-a22b": (228e9, 240e9),
        "xlstm-1.3b": (1.0e9, 1.5e9),
        "recurrentgemma-9b": (8.5e9, 10.5e9),
        "internvl2-2b": (1.5e9, 2.3e9),
        "whisper-base": (0.05e9, 0.11e9),
    }
    assert set(expected) == set(ARCHS)
    for name, (lo, hi) in expected.items():
        model, _ = model_init(None, get_arch(name), device="meta")
        n = count_params(model)
        assert lo <= n <= hi, f"{name}: {n / 1e9:.2f}B outside [{lo},{hi}]"


def test_make_inputs_and_specs():
    cfg = get_arch("internvl2-2b-smoke")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                global_batch=2)
    gen = torch.Generator().manual_seed(0)
    inputs = model_inputs(cfg, shape, generator=gen, device="cpu")
    assert inputs["tokens"].shape == (2, 32 - cfg.img_tokens)
    assert inputs["img_embeds"].shape == (2, cfg.img_tokens, cfg.d_model)
    assert int(inputs["tokens"].max()) < cfg.vocab
    specs = input_specs(cfg, shape)
    assert {k: v.shape for k, v in specs.items()} == \
        {k: v.shape for k, v in inputs.items()}
    assert set(input_sharding(cfg, shape)) == set(inputs)
    decode = model_inputs(cfg, SHAPES["decode_32k"], device="cpu")
    assert decode["tokens"].shape == (128, 1)
    assert int(decode["positions"][0, 0]) == 32_768
    model, _ = model_init(gen, cfg, device="cpu")
    with torch.no_grad():
        logits, _, _ = model_apply(model, cfg, inputs, Mode("train", "dense"))
    assert logits.shape[:2] == (2, 32) and torch.isfinite(logits).all()


def test_entry_points_take_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_arch("tinyllama-1.1b-smoke")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model_init(None, cfg)
    from repro_torch.models import model_state_init
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model_state_init(cfg, 1, 8)
    from repro_torch.convert import lm_params_from_numpy, lm_state_from_numpy
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_state_from_numpy({})


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "recurrentgemma-9b",
                                  "xlstm-1.3b", "whisper-base"])
@pytest.mark.parametrize("layout", ["stacked", "list"])
def test_state_specs_and_shapes_mirror_reference(name, layout):
    """``model_state_specs`` has the reference's tree and specs, and
    ``model_state_init`` the reference's leaf shapes and dtypes."""
    import jax
    from jax.sharding import PartitionSpec

    from _torch_lm import spec_paths
    from repro.configs import get_arch as ref_arch
    from repro.models import model_state_init as ref_state_init
    from repro.models import model_state_specs as ref_state_specs
    from repro_torch.models import model_state_init, model_state_specs
    from repro_torch.models.layers.common import P

    cfg, rcfg = get_arch(name + "-smoke"), ref_arch(name + "-smoke")
    got = spec_paths(model_state_specs(cfg, layout=layout),
                     lambda x: isinstance(x, P))
    want = spec_paths(ref_state_specs(rcfg, layout=layout),
                      lambda x: isinstance(x, PartitionSpec))
    assert got == want
    st = model_state_init(cfg, 2, 16, layout=layout, device="cpu")
    rst = ref_state_init(rcfg, 2, 16, layout=layout)
    shapes = [(tuple(t.shape), str(t.dtype).split(".")[-1])
              for t in jax.tree.leaves(st)]
    ref_shapes = [(tuple(x.shape), str(x.dtype)) for x in
                  jax.tree.leaves(rst)]
    assert shapes == ref_shapes
