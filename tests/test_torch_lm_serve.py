"""The port's LM serving path on the CPU (``repro_torch.serve.engine``,
``batching``, ``kvcache`` and ``launch.serve``): the tests of
tests/test_serve.py and tests/test_batching.py on the port, and parity with
the JAX reference's engine, continuous batching and exemplar KV cache.

Greedy tokens are held to the reference's under the margin rule of
``tests/_torch_lm.py``: equal up to the first step whose reference top-2
margin is within twice the bfloat16 tolerance (that step's token may
flip, and from there the two runs diverge). The exemplar cache is
flat AP on the cached keys, which drifts from the reference's by float
rounding (ROADMAP C2): on clustered keys, where AP settles, the kept sets
are equal; on unclustered keys (the reference test's cache) a slot or two
a row may differ, and only the port's own properties are held there."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_lm import ATOL_BF16, make_pair, one_torch_thread  # noqa: E402,F401
from repro.serve.batching import (  # noqa: E402
    ContinuousBatchingEngine as RefBatching,
)
from repro.serve.engine import (  # noqa: E402
    ServeEngine as RefEngine, make_prefill_step as ref_prefill_step,
)
from repro.models import model_state_init as ref_state_init  # noqa: E402
from repro.models.layers.attention import init_cache as ref_cache  # noqa
from repro.serve import kvcache as ref_kv  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.layers.attention import KVCache, init_cache  # noqa
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine, ServeEngine, insert_sequence,
)
from repro_torch.serve.kvcache import (  # noqa: E402
    exemplar_compress_cache, exemplar_compress_window,
)

MARGIN = 2 * ATOL_BF16


@pytest.fixture(scope="module")
def tiny():
    return make_pair("tinyllama-1.1b-smoke")


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _ref_margins(engine, pair, prompts, tokens, max_len, extras=None):
    """The reference's top-2 logit margin before each generated token,
    decoding its own tokens (teacher forcing) as its ``engine`` does, with
    the engine's jitted decode step."""
    cfg, params = pair.ref_cfg, pair.ref_params
    b, s = prompts.shape
    s += cfg.img_tokens if cfg.family == "vlm" else 0
    states = ref_state_init(cfg, b, max_len, layout="stacked"
                            if cfg.family == "audio" else "list")
    inputs = {"tokens": jnp.asarray(prompts),
              "positions": jnp.broadcast_to(jnp.arange(s)[None], (b, s))}
    inputs.update({k: jnp.asarray(v) for k, v in (extras or {}).items()})
    logits, states = ref_prefill_step(cfg, s)(params, inputs, states)
    decode = engine._decode
    margins = []
    for i in range(tokens.shape[1]):
        top2 = np.sort(np.asarray(logits)[:, :cfg.vocab], axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        logits, states = decode(
            params, {"tokens": jnp.asarray(tokens[:, i:i + 1]),
                     "positions": jnp.full((b, 1), s + i, jnp.int32)},
            states)
    return np.stack(margins, axis=1)


def _equal_under_margin(got, want, margins) -> int:
    """Rows equal before their first step under the margin (whose token
    may flip); -> how many steps were compared."""
    compared = 0
    for row in range(want.shape[0]):
        under = np.flatnonzero(margins[row] <= MARGIN)
        stop = int(under[0]) if len(under) else want.shape[1]
        np.testing.assert_array_equal(got[row, :stop], want[row, :stop])
        compared += stop
    return compared


def test_engine_generates(tiny):
    engine = ServeEngine(tiny.cfg, tiny.model, max_len=64)
    out = engine.generate(_prompts(tiny.cfg, 2, 16), steps=6)
    assert out.shape == (2, 6) and out.dtype == torch.int32
    assert bool(((out >= 0) & (out < tiny.cfg.vocab)).all())


def test_greedy_is_deterministic_and_sampling_follows_the_generator(tiny):
    engine = ServeEngine(tiny.cfg, tiny.model, max_len=48)
    prompts = _prompts(tiny.cfg, 1, 8)
    a = engine.generate(prompts, steps=5)
    assert torch.equal(a, engine.generate(prompts, steps=5))
    draw = lambda seed: engine.generate(  # noqa: E731
        prompts, steps=5, temperature=1.0,
        generator=torch.Generator().manual_seed(seed))
    assert torch.equal(draw(1), draw(1))


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "internvl2-2b",
                                  "whisper-base"])
def test_engine_tokens_equal_the_reference(name, record_property):
    pair = make_pair(name + "-smoke")
    cfg = pair.cfg
    b, s, steps, max_len = 2, 12, 8, 48
    prompts = _prompts(cfg, b, s, seed=1)
    extras = {}
    if cfg.family == "vlm":
        extras["img_embeds"] = (0.02 * np.random.default_rng(2).standard_normal(
            (b, cfg.img_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "audio":
        extras["frames"] = (0.02 * np.random.default_rng(2).standard_normal(
            (b, cfg.enc_seq, cfg.d_model))).astype(np.float32)
    ref = RefEngine(pair.ref_cfg, pair.ref_params, max_len=max_len)
    want = np.asarray(ref.generate(
        jnp.asarray(prompts), steps=steps,
        extras={k: jnp.asarray(v) for k, v in extras.items()}))
    got = ServeEngine(cfg, pair.model, max_len=max_len).generate(
        prompts, steps=steps, extras=extras).numpy()
    margins = _ref_margins(ref, pair, prompts, want, max_len, extras)
    record_property("steps_compared", _equal_under_margin(got, want, margins))


def test_insert_sequence_tree_surgery():
    batch = {"a": torch.zeros(4, 3), "b": [torch.ones(4)]}
    one = {"a": torch.full((1, 3), 7.0), "b": [torch.full((1,), 9.0)]}
    out = insert_sequence(batch, one, 2)
    assert out["a"][2].tolist() == [7, 7, 7]
    assert float(out["b"][0][2]) == 9.0
    assert out["a"][0].tolist() == [0, 0, 0]
    assert float(batch["b"][0][2]) == 1.0          # the input is unchanged


def test_continuous_batching_matches_isolated_and_the_reference(tiny):
    """5 requests on 2 slots (slot reuse), two prompt lengths (the
    reference compiles a prefill a length): each output equals the port's
    isolated generate exactly, and the reference's continuous batching
    under the margin rule."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tiny.cfg.vocab, n).astype(np.int32)
               for n in (12, 7, 12, 7, 12)]
    max_new = 6
    engine = ContinuousBatchingEngine(tiny.cfg, tiny.model, slots=2,
                                      max_len=64)
    rids = [engine.submit(p, max_new=max_new) for p in prompts]
    finished = engine.run_to_completion()
    assert set(finished) == set(rids)
    isolated = ServeEngine(tiny.cfg, tiny.model, max_len=64)
    ref = RefBatching(tiny.ref_cfg, tiny.ref_params, slots=2, max_len=64)
    ref_ids = [ref.submit(p, max_new=max_new) for p in prompts]
    ref_done = ref.run_to_completion()
    ref_engine = RefEngine(tiny.ref_cfg, tiny.ref_params, max_len=64)
    for rid, ref_id, prompt in zip(rids, ref_ids, prompts):
        want = isolated.generate(prompt[None], steps=max_new).numpy()[0]
        np.testing.assert_array_equal(finished[rid], want)
        margins = _ref_margins(ref_engine, tiny, prompt[None],
                               ref_done[ref_id][None], 64)
        _equal_under_margin(finished[rid][None], ref_done[ref_id][None],
                            margins)


def test_slots_reused_and_interleaved(tiny):
    engine = ContinuousBatchingEngine(tiny.cfg, tiny.model, slots=2,
                                      max_len=48)
    rng = np.random.default_rng(1)
    rids = [engine.submit(rng.integers(0, tiny.cfg.vocab, 8), max_new=m)
            for m in (3, 9, 5)]
    out = engine.run_to_completion()
    assert sorted(len(out[r]) for r in rids) == [3, 5, 9]


def _three_clusters():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((3, 8)).astype(np.float32) * 5
    ks = (np.repeat(centers, 16, axis=0)
          + 0.05 * rng.standard_normal((48, 8))).astype(np.float32)
    vs = rng.standard_normal((48, 8)).astype(np.float32)
    return ks[:, None, :], vs[:, None, :]


def test_exemplar_window_selects_cluster_structure_as_the_reference():
    """Keys from 3 tight clusters: about 3 exemplars, their keys kept and
    their values the member means; mask and values equal the reference's."""
    ks, vs = _three_clusters()
    k_new, v_new, keep = exemplar_compress_window(
        torch.from_numpy(ks), torch.from_numpy(vs), preference=-200.0)
    keep = keep.numpy()
    assert 2 <= keep.sum() <= 8
    idx = np.flatnonzero(keep)
    np.testing.assert_allclose(k_new.numpy()[idx, 0], ks[idx, 0], atol=1e-4)
    rk, rv, rkeep = ref_kv.exemplar_compress_window(
        jnp.asarray(ks), jnp.asarray(vs), preference=-200.0)
    np.testing.assert_array_equal(keep, np.asarray(rkeep))
    np.testing.assert_allclose(k_new.numpy(), np.asarray(rk), atol=1e-6)
    np.testing.assert_allclose(v_new.numpy(), np.asarray(rv), atol=1e-5)


def test_exemplar_compress_cache_masks_positions():
    """tests/test_serve.py's cache on the port: the masked slots are the
    ones not kept, the newest region is untouched, the input unchanged."""
    rng = np.random.default_rng(1)
    k = torch.from_numpy(rng.standard_normal((2, 64, 2, 4)).astype(
        np.float32))
    pos = torch.arange(64, dtype=torch.int32).expand(2, 64).clone()
    cache = init_cache(2, 64, 2, 4, dtype=torch.float32, device="cpu")
    cache = cache._replace(k=k, v=k * 0.5, pos=pos)
    new, stats = exemplar_compress_cache(cache, window=32, preference=-10.0)
    kept = int(stats.kept.sum())
    assert int((new.pos[:, :32] == -1).sum()) == 2 * 32 - kept
    assert torch.equal(new.pos[:, 32:], cache.pos[:, 32:])
    assert torch.equal(cache.pos, pos)
    assert isinstance(new, KVCache)


def test_exemplar_compress_cache_equals_the_reference():
    """Two rows of clustered keys (3 and 4 clusters) in a 48-slot window of
    a 64-slot cache: kept counts, masks, keys and values equal."""
    rng = np.random.default_rng(2)
    rows = []
    for n_clusters in (3, 4):
        centers = rng.standard_normal((n_clusters, 8)).astype(np.float32) * 5
        pick = rng.integers(0, n_clusters, 64)
        rows.append(centers[pick] + 0.05 * rng.standard_normal((64, 8)))
    k = np.stack(rows).astype(np.float32).reshape(2, 64, 2, 4)
    v = rng.standard_normal((2, 64, 2, 4)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64)).copy()
    cache = KVCache(torch.from_numpy(k), torch.from_numpy(v),
                    torch.from_numpy(pos), torch.full((2,), 64,
                                                      dtype=torch.int32))
    new, stats = exemplar_compress_cache(cache, window=48, preference=-200.0)
    rcache = ref_cache(2, 64, 2, 4, dtype=jnp.float32)._replace(
        k=jnp.asarray(k), v=jnp.asarray(v), pos=jnp.asarray(pos))
    rnew, rstats = ref_kv.exemplar_compress_cache(rcache, window=48,
                                                  preference=-200.0)
    np.testing.assert_array_equal(stats.kept.numpy(), np.asarray(rstats.kept))
    assert 3 <= int(stats.kept.min())
    np.testing.assert_array_equal(new.pos.numpy(), np.asarray(rnew.pos))
    np.testing.assert_allclose(new.k.numpy(), np.asarray(rnew.k), atol=1e-6)
    np.testing.assert_allclose(new.v.numpy(), np.asarray(rnew.v), atol=1e-5)


def test_launch_serve_runs_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", "tinyllama-1.1b", "--smoke",
                              "--device", "cpu", "--steps", "4"]) == 0
    assert "generated (4, 4)" in capsys.readouterr().out
