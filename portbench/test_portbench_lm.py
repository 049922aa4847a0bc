"""CPU tests of the harness's dispatch by configuration and of the LM
serving program (``programs/lm_serve.py``): its cell's files, its runs
and judge against the plain reference at CPU sizes (``_tiny``), the
faults the judge has to catch, the fp8 control, the counts, the LM
cell's architecture, state and counts' sizes pinned to what they were
before the reference module declared them, configurations of other
architectures that run from files alone (another family member, a
pattern of two slots and a remainder, an MoE-shaped declaration), and
the program's spans under the LM window's spans-only profile."""
from __future__ import annotations

import dataclasses
import importlib
import io
import json
import sys
import time
import types
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from portbench import _tiny, device, loadgen, programs, run, spec
from portbench.counts import lm_dense as counts
from portbench.programs import lm_serve
from portbench.reference import lm_dense

BENCH = spec.load_benchmark()
LM = "qwen2.5-32b-pp4.doc-buckets"
LM_METRICS = {"prefill_ms", "decode_step_ms", "decode_roofline_pct",
              "mfu_device_pct"}
#: what the four solve cells resolved to before the LM cell came
SOLVE_CELLS = {
    "blobs-200k-topk.d2": (
        ["solve_s", "solve_p90_s", "peak_mem_gib", "setup_s"],
        ["idle_pct", "engine_self_ms", "preference_ms", "build_ms",
         "build_roofline_pct", "sweep_ms", "sweep_roofline_pct",
         "finalize_ms", "sweep_r_ms", "sweep_a_ms", "sweep_levels_ms",
         "sweep_assign_ms", "kernels_per_sweep", "host_syncs_per_solve",
         "host_copies_per_solve"]),
    "mandrill-dense.median": (
        ["solve_s", "dense_solve_s", "peak_mem_gib", "setup_s"],
        ["idle_pct", "engine_self_ms", "preference_ms", "build_ms",
         "sweep_ms", "sweep_roofline_pct", "finalize_ms", "sweep_r_ms",
         "sweep_a_ms", "sweep_levels_ms", "sweep_assign_ms",
         "kernels_per_sweep", "host_syncs_per_solve",
         "host_copies_per_solve"]),
    "blobs-200k-topk.d128": (
        ["solve_s", "peak_mem_gib", "setup_s"],
        ["idle_pct", "engine_self_ms", "preference_ms", "build_ms",
         "build_roofline_pct", "sweep_ms", "sweep_roofline_pct",
         "finalize_ms", "sweep_r_ms", "sweep_a_ms", "sweep_levels_ms",
         "sweep_assign_ms", "kernels_per_sweep", "host_syncs_per_solve",
         "host_copies_per_solve"]),
    "mandrill-dense.random-pref": (
        ["solve_s", "dense_solve_s", "dense_solve_p90_s", "peak_mem_gib",
         "setup_s"],
        ["idle_pct", "engine_self_ms", "build_ms", "sweep_ms",
         "sweep_roofline_pct", "finalize_ms", "sweep_r_ms", "sweep_a_ms",
         "sweep_levels_ms", "sweep_assign_ms", "kernels_per_sweep",
         "host_syncs_per_solve", "host_copies_per_solve"]),
}


def judged(cell, seed: int = 2 ** 31 + 11) -> dict:
    return run.run_cell(cell, seed, 0.0, False, "cpu",
                        time.perf_counter())["judged"]


def test_the_lm_cell_files_are_found_by_name():
    cell = spec.find_cell(BENCH, LM)
    assert cell.program == "lm_serve"
    assert programs.of(cell) is lm_serve
    assert set(cell.limits) == set(lm_serve.NUMBERS)
    assert cell.mix["generate"] == {"steps": 128}
    buckets = cell.data["per_input"]
    assert len(buckets) == cell.mix["pool"]
    assert [(b["batch"], b["prompt_len"]) for b in buckets] == [
        (32, 512), (16, 1024), (8, 2048), (4, 4096)]
    # one token budget a batch, so each bucket holds the same share
    assert {b["batch"] * b["prompt_len"] for b in buckets} == {16384}
    assert cell.data["vocab"] == cell.config["vocab_size"]
    assert set(cell.config["published"]) <= set(cell.config["reduced"])
    assert {m["name"] for m in cell.per_layer} == LM_METRICS
    for m in cell.per_layer:
        assert callable(importlib.import_module(
            f"portbench.metrics.{m['name']}").read)
    importlib.import_module(f"portbench.datasets.{cell.data['kind']}")
    importlib.import_module(f"portbench.counts.{cell.config['counts']}")
    assert lm_serve.reference_of(cell.config) is lm_dense
    for mod, attr in (lm_serve.RECORD, lm_serve.MODE_SPANS):
        assert hasattr(importlib.import_module(mod), attr)
    assert cell.config["reduced"] == ["num_hidden_layers", "rms_norm_eps"]
    cfg, changed = lm_serve.arch(cell.config)
    assert set(changed) == {"n_layers", "rope_theta", "head_dim"}
    assert cfg.resolved_head_dim == cell.config["head_dim"]


def test_solve_s_is_not_reported_on_the_lm_cell():
    cell = spec.find_cell(BENCH, LM)
    assert [m["name"] for m in cell.end_to_end] == [
        "generate_s", "peak_mem_gib", "setup_s"]
    solve_metrics = {m for e2e, pl in SOLVE_CELLS.values() for m in e2e + pl}
    assert not solve_metrics & {m["name"] for m in
                                cell.end_to_end + cell.per_layer} - {
        "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("name", sorted(SOLVE_CELLS))
def test_the_solve_cells_resolve_as_before(name):
    cell = spec.find_cell(BENCH, name)
    e2e, per_layer = SOLVE_CELLS[name]
    assert cell.program == "solve"
    assert programs.of(cell).NUMBERS == ("mismatch",)
    assert [m["name"] for m in cell.end_to_end] == e2e
    assert [m["name"] for m in cell.per_layer] == per_layer


def test_a_solve_run_loads_nothing_of_the_lm_path(tmp_path):
    import subprocess

    root = Path(spec.ROOT)
    code = (
        "import time, sys, json; from portbench import _tiny, run; "
        "run.run_cell(_tiny.tiny_cell('mandrill-dense.random-pref'), 5, "
        "0.0, False, 'cpu', time.perf_counter()); "
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith(("
        "'portbench.programs.lm', 'portbench.reference.lm', "
        "'repro_torch.serve', 'repro_torch.models')))))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=tmp_path, check=True,
        env={"PYTHONPATH": f"{root}:{root / 'src'}", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("trace", [0, 1])
def test_a_reduced_lm_runs_and_reads_near_the_reference(trace):
    cell = _tiny.tiny_cell(LM)
    out = run.run_cell(cell, 2 ** 31 + 3, 0.0, bool(trace), "cpu",
                       time.perf_counter())
    j = out["judged"]
    assert j["correct"] is True and j["failed"] == 0 and j["compared"] >= 1
    # bfloat16 products and residual stream against float32
    assert 0 < j["numbers"]["logit_rel_err"]["value"] < 0.03
    assert j["numbers"]["token_gap"]["value"] < 0.01
    if trace:
        assert "mfu_device_pct" not in out["metrics"]  # no device here
    else:
        assert set(out["metrics"]) == {"generate_s", "peak_mem_gib",
                                       "setup_s"}
    dev = {"platform": "gpu", "kind": "test", "count": 1,
           "memory_peak_bytes": 1}
    with redirect_stdout(io.StringIO()):
        line = run.result_line(out, dev, bool(trace))
    assert list(line["checks"]) == list(lm_serve.NUMBERS)
    json.dumps(line)


def test_the_ports_fixed_eps_shows_against_the_published_one():
    """The port's RMSNorm takes eps 1e-6 whatever the model states, so the
    configuration states 1e-6 and lists the key in ``reduced``: a
    reference at Qwen2.5's published 1e-5 would hold the port to a value
    it cannot run, and the judge sees the difference."""
    cell = _tiny.tiny_cell(LM)
    c = spec.find_cell(BENCH, LM).config
    assert (c["rms_norm_eps"], c["published"]["rms_norm_eps"]) == (1e-6, 1e-5)
    port = judged(cell)["numbers"]["logit_rel_err"]["value"]
    stated = judged(cell._replace(config={
        **cell.config, "rms_norm_eps": c["published"]["rms_norm_eps"]}))
    assert stated["numbers"]["logit_rel_err"]["value"] > 1.2 * port


def test_the_ports_parameters_are_the_benchmarks_weights():
    cell = _tiny.tiny_cell(LM)
    r = lm_serve.Run(cell, 7, "cpu", lambda: None)
    engines = list(r.engines.values())
    assert len(engines) == 2 and engines[0].params is engines[1].params
    params = dict(engines[0].params.named_parameters())
    state = lm_serve.port_state(r.weights, r.cfg)
    assert set(params) == set(state)
    assert all(params[k].data_ptr() == v.data_ptr()
               for k, v in state.items())
    r.release()


def _positions_shifted(engine):
    orig = engine.model_apply

    def apply(params, cfg, inputs, mode, **kw):
        if mode.kind == "decode":
            inputs = {**inputs, "positions": inputs["positions"] + 1}
        return orig(params, cfg, inputs, mode, **kw)
    return "model_apply", apply


def _layer_skipped(engine):
    orig = engine.model_apply

    def apply(params, cfg, inputs, mode, **kw):
        if mode.kind == "decode":
            cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers - 1)
        return orig(params, cfg, inputs, mode, **kw)
    return "model_apply", apply


def _state_unchanged(engine):
    orig = engine.make_decode_step

    def make(cfg):
        step = orig(cfg)

        def decode(params, inputs, states):
            return step(params, inputs, states)[0], states
        return decode
    return "make_decode_step", make


def _half_the_batch(engine):
    orig = engine.model_apply

    def apply(params, cfg, inputs, mode, **kw):
        logits, states, aux = orig(params, cfg, inputs, mode, **kw)
        if mode.kind == "decode":       # the second half's rows: the first's
            b = logits.shape[0]
            h = (b + 1) // 2
            logits = torch.cat([logits[:h], logits[:b - h]])
        return logits, states, aux
    return "model_apply", apply


def _token_altered(engine):
    orig = engine.next_tokens

    def nxt(logits, *args, **kw):
        t = orig(logits, *args, **kw).clone()
        t[0] = (t[0] + 1) % logits.shape[-1]
        return t
    return "next_tokens", nxt


FAULTS = {"decode_positions_shifted": _positions_shifted,
          "a_layer_skipped_in_decode": _layer_skipped,
          "decode_state_unchanged": _state_unchanged,
          "half_the_batch_left_out": _half_the_batch,
          "a_token_altered_where_produced": _token_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_reads_above_the_limit(fault, monkeypatch):
    from repro_torch.serve import engine

    attr, broken = FAULTS[fault](engine)
    monkeypatch.setattr(engine, attr, broken)
    j = judged(_tiny.tiny_cell(LM))
    assert j["correct"] is False and j["failed"] == 0
    assert any(v["value"] > v["limit"] for v in j["numbers"].values())


def test_the_fp8_control_is_not_correct():
    """The reference with every product's inputs in float8 e4m3 in the
    program's place, at the CPU size, on the program's own tokens."""
    cell = _tiny.tiny_cell(LM)
    r = lm_serve.Run(cell, 2 ** 31 + 23, "cpu", lambda: None)
    served = {x[0]: r.call(x) for x in r.inputs}
    r.release()
    ctl = {}
    for i, tokens in served.items():
        start = r.pool[i].shape[1] - 1
        for seq, _ in lm_serve._rows(r, i, tokens):
            ref = lm_dense.logits(r.weights, cell.config, seq, start)
            low = lm_dense.logits(r.weights, cell.config, seq, start,
                                  mm=lm_serve._fp8_mm)
            ctl = programs.worst(ctl, lm_serve._compare(
                low, ref, low.argmax(dim=-1)))
    assert any(ctl[k] > cell.limits[k] for k in lm_serve.NUMBERS)


def test_the_prompts_repeat_for_a_seed():
    data = {"kind": "uniform_tokens", "vocab": 152064, "batch": 8,
            "prompt_len": 2048}
    seed = 2 ** 31 + 7
    a, b = (loadgen.make_pool(data, 2, seed) for _ in range(2))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (8, 2048) and a[0].dtype == np.int64
    assert 0 <= a[0].min() and a[0].max() < 152064
    assert not np.array_equal(a[0], a[1])


def test_the_pool_takes_each_inputs_own_sizes():
    data = {"kind": "uniform_tokens", "vocab": 100,
            "per_input": [{"batch": 4, "prompt_len": 3},
                          {"batch": 2, "prompt_len": 6}]}
    pool = loadgen.make_pool(data, 3, 2 ** 31 + 9)
    assert [x.shape for x in pool] == [(4, 3), (2, 6), (4, 3)]
    assert not np.array_equal(pool[0], pool[2])


@pytest.mark.parametrize("b", [1, 4, 5, 8, 32])
def test_the_judged_rows_come_from_both_halves(b):
    seeds = [loadgen.input_seed(2 ** 31 + 5, lm_serve.JUDGED + i)
             for i in range(20)]
    for seed in seeds:
        rows = lm_serve.judged_rows(b, seed)
        assert rows == lm_serve.judged_rows(b, seed)
        assert rows == sorted(set(rows)) and 0 <= rows[0] and rows[-1] < b
        if b <= lm_serve.ROWS:
            assert rows == list(range(b))
        else:
            assert len(rows) == lm_serve.ROWS
            assert sum(r < b // 2 for r in rows) == lm_serve.ROWS // 2
    if b > lm_serve.ROWS:
        assert len({tuple(lm_serve.judged_rows(b, s)) for s in seeds}) > 1


def test_the_record_lies_on_the_host_and_holds_the_last_call():
    cell = _tiny.tiny_cell(LM)
    r = lm_serve.Run(cell, 2 ** 31 + 29, "cpu", lambda: None)
    first = r.call(r.inputs[0])
    kept = r.record[0][0].clone()
    again = r.call(r.inputs[0])
    assert torch.equal(first, again) and torch.equal(r.record[0][0], kept)
    assert r.recorded[0] == r.new and r.recorded[1] == 0
    assert all(buf.device.type == "cpu" for buf, _, _ in r.record)
    assert r.record[1][0].shape == (r.new, 3, 256)
    r.release()


def test_a_spans_only_profile_records_no_host_op():
    from portbench import tracing

    x = torch.ones(8, 8)
    with tracing.profile("cpu", host_ops=False) as prof:
        with tracing.record_function(tracing.PREFIX + "window"):
            with tracing.record_function(tracing.PREFIX + "decode"):
                (x @ x).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert names == {tracing.PREFIX + "window", tracing.PREFIX + "decode"}


TOY = {"hidden_size": 4, "num_hidden_layers": 2, "num_attention_heads": 2,
       "num_key_value_heads": 1, "head_dim": 2, "intermediate_size": 6,
       "vocab_size": 10, "qkv_bias": True, "tie_word_embeddings": False}


def test_counts_equal_the_hand_worked_values():
    # the toy: q and o 4 x 4, k and v 4 x 2, SwiGLU 3 x 4 x 6: 120
    # weights a layer; 8 bias and 8 gain values a layer, 4 final gains
    assert counts.layer_weights(TOY) == 120
    assert counts.non_embedding_params(TOY) == 2 * 136 + 4
    # B = 1, S = 3: 2 * 120 * 3 * 2 layers; 4 * 2 * 2 * (1 + 2 + 3) * 2;
    # the head 2 * 4 * 10
    assert counts.prefill_flops(TOY, 1, 3) == 1440 + 192 + 80
    # one decode step (2 new tokens), position 3 reads 4 keys
    assert counts.decode_flops(TOY, 1, 3, 2) == 480 + 80 + 2 * 16 * 4
    assert counts.call_flops(TOY, 1, 3, 2) == 2400
    # bf16: 276 + 40 head + 4 embedding values; 8 values of keys and
    # values a token over 3 before and 1 written
    assert counts.decode_bytes(TOY, 1, 3, 2) == 2 * (320 + 8 * 4)

    c = spec.find_cell(BENCH, LM).config
    assert counts.layer_weights(c) == 487_587_840
    assert counts.non_embedding_params(c) == 7_801_689_088
    # 2 * 16 * 487,587,840 * 2,048 + 16 * 4 * 40 * 128 * 2,098,176
    # + 2 * 5,120 * 152,064, for each of 8 rows
    assert counts.prefill_flops(c, 8, 2048) == 8 * (
        31_954_556_682_240 + 687_530_311_680 + 1_557_135_360)
    # 127 steps; keys 127 * 2,049 + 127 * 126 / 2 = 268,224
    assert counts.decode_flops(c, 8, 2048, 128) == 8 * (
        127 * (2 * 16 * 487_587_840 + 2 * 5_120 * 152_064)
        + 16 * 20_480 * 268_224)
    # weights 7,801,689,088 + 152,064 * 5,120 + 8 * 5,120; 32,768 values
    # of keys and values a token over 268,097 before and 127 written
    assert counts.decode_bytes(c, 8, 2048, 128) == 2 * (
        127 * 8_580_297_728 + 8 * 32_768 * (268_097 + 127))


def _toy_root(tmp_path, **over) -> spec.Cell:
    """A toy configuration of another family member (tinyllama-1.1b:
    tied embeddings, no q/k/v biases) in a root of its own: its
    configuration, mix and cell files and the BENCHMARK.json entries, and
    no harness file; ``over`` changes the configuration's keys. -> its
    cell, ``toy-llama.toy``."""
    here = tmp_path / "portbench"
    for sub in ("configs", "mixes", "cells"):
        (here / sub).mkdir(parents=True)
    lm = spec.find_cell(BENCH, LM).config
    config = {**{k: lm[k] for k in ("program", "data", "reference",
                                     "counts", "rms_norm_eps",
                                     "rope_theta")},
              "name": "toy-llama", "architecture": "tinyllama-1.1b",
              "hidden_size": 32, "num_hidden_layers": 3,
              "num_attention_heads": 4, "num_key_value_heads": 1,
              "head_dim": 8, "intermediate_size": 48, "vocab_size": 200,
              "qkv_bias": False, "tie_word_embeddings": True,
              "reduced": ["hidden_size"], **over}
    config["data"] = {**config["data"], "vocab": 200}
    mix = {"why": "toy", "pool": 2, "data": {"batch": 3, "prompt_len": 9},
           "generate": {"steps": 3}}
    limits = spec.find_cell(BENCH, LM).limits
    (here / "configs" / "toy-llama.json").write_text(json.dumps(config))
    (here / "mixes" / "toy.json").write_text(json.dumps(mix))
    (here / "cells" / "toy-llama.toy.json").write_text(
        json.dumps({"limits": limits}))
    bench = {**BENCH, "configs": [{"name": "toy-llama",
                                   "file": "portbench/configs/toy-llama.json",
                                   "reduced": ["hidden_size"]}],
             "workloads": [{"name": "toy-llama.toy", "config": "toy-llama",
                            "traffic": "toy", "chips": 1}]}
    bench["end_to_end"] = [{**m, "workloads": ["toy-llama.toy"]}
                           if m["name"] == "generate_s" else m
                           for m in BENCH["end_to_end"]]
    bench["per_layer"] = [{**m, "workloads": ["toy-llama.toy"]}
                          for m in BENCH["per_layer"]
                          if m["name"] in LM_METRICS]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert sorted(p.name for p in here.iterdir()) == ["cells", "configs",
                                                      "mixes"]
    return spec.find_cell(spec.load_benchmark(tmp_path), "toy-llama.toy",
                          root=tmp_path)


def test_a_second_lm_configuration_runs_from_files_alone(tmp_path):
    """A toy configuration of another family member, from its own files
    and no harness file edited; its CPU cut is its reference's."""
    cell = _toy_root(tmp_path)
    assert cell.program == "lm_serve"
    assert cell.limits == spec.find_cell(BENCH, LM).limits
    out = run.run_cell(cell, 2 ** 33 + 1, 0.0, False, "cpu",
                       time.perf_counter())
    assert out["judged"]["correct"] is True
    assert set(out["metrics"]) == {"generate_s", "peak_mem_gib", "setup_s"}
    tiny = _tiny.tiny_cell("toy-llama.toy", root=tmp_path)
    assert tiny.config == {**cell.config, **lm_dense.SMOKE["config"]}
    assert tiny.mix["generate"] == {"steps": 4} and tiny.mix["pool"] == 2


def test_a_two_slot_architecture_with_a_remainder_runs_from_files_alone(
        tmp_path, monkeypatch):
    """The registry's pattern of two slots over 3 layers: two units'
    slots and one layer left over, each parameter of the port's model
    one of the reference's weights, and the run ``correct``."""
    from repro_torch.configs import registry

    base = registry.get_arch("tinyllama-1.1b")
    monkeypatch.setitem(registry.ARCHS, "toy-two-slot", dataclasses.replace(
        base, name="toy-two-slot", pattern=("attn", "attn")))
    cell = _toy_root(tmp_path, architecture="toy-two-slot")
    cfg, _ = lm_serve.arch(cell.config)
    assert lm_serve.places(cfg) == [("units.0_attn.0", "attn"),
                                    ("units.1_attn.0", "attn"),
                                    ("rest.0_attn", "attn")]
    r = lm_serve.Run(cell, 2 ** 33 + 5, "cpu", lambda: None)
    params = dict(next(iter(r.engines.values())).params.named_parameters())
    state = lm_serve.port_state(r.weights, r.cfg)
    assert set(params) == set(state)
    assert {k.split(".attn.")[0] for k in params if ".attn.q.w" in k} == {
        "units.0_attn.0", "units.1_attn.0", "rest.0_attn"}
    # the embedding, padded from 200 rows to 256, is a copy each call
    assert all(params[k].data_ptr() == v.data_ptr()
               for k, v in state.items() if not k.endswith(".embedding"))
    assert len({p.data_ptr() for p in params.values()}) == len(params)
    r.release()
    out = run.run_cell(cell, 2 ** 33 + 7, 0.0, False, "cpu",
                       time.perf_counter())
    assert out["judged"]["correct"] is True


@pytest.mark.parametrize("stack", ["layers", "layers_attn"])
def test_a_stack_places_each_layer_once(stack):
    """A weight stacked over every layer, or over the layers of one kind,
    lands on each of those layers' parameter once; a stack of another
    length, or two weights on one parameter, is refused."""
    cfg = dataclasses.replace(lm_serve.arch(_tiny.tiny_cell(LM).config)[0],
                              n_layers=3, pattern=("attn", "attn"))
    w = {f"{stack}.norm1.scale": torch.arange(3.0)[:, None].expand(3, 4)}
    state = lm_serve.port_state(w, cfg)
    assert {k: float(v[0]) for k, v in state.items()} == {
        "units.0_attn.0.norm1.scale": 0.0,
        "units.1_attn.0.norm1.scale": 1.0, "rest.0_attn.norm1.scale": 2.0}
    with pytest.raises(ValueError, match="stacks 2 layers"):
        lm_serve.port_state({f"{stack}.norm1.scale": torch.ones(2, 4)}, cfg)
    with pytest.raises(ValueError, match="two of the reference's weights"):
        lm_serve.port_state({**w, "layers_attn.norm1.scale": w[
            f"{stack}.norm1.scale"], "layers.norm1.scale": w[
            f"{stack}.norm1.scale"]}, cfg)
    assert lm_serve.port_state({"layers_moe.norm1.scale":
                                torch.ones(0, 4)}, cfg) == {}


#: an MoE-shaped configuration, on the registry's mixtral-8x22b: 64
#: published experts of which 8 are held on this chip
MOE = {"architecture": "mixtral-8x22b", "reference": {"module": "toy_moe"},
       "counts": "toy_moe", "hidden_size": 32, "num_hidden_layers": 3,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8,
       "vocab_size": 200, "num_experts": 64, "num_experts_held": 8,
       "num_experts_per_tok": 4, "moe_intermediate_size": 24,
       "sliding_window": 16, "rope_parameters": {"rope_theta": 5e5},
       "tie_word_embeddings": False}


def _toy_moe(monkeypatch, kinds: str = "moe"):
    """A reference module and a counts module for ``MOE``, registered
    under ``portbench.reference.toy_moe`` and ``portbench.counts.toy_moe``;
    -> (the reference, the configurations the counts were handed)."""
    fields = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
              "num_attention_heads": "n_heads",
              "num_key_value_heads": "n_kv", "head_dim": "head_dim",
              "vocab_size": "vocab", "num_experts_held": "n_experts",
              "num_experts_per_tok": "top_k",
              "moe_intermediate_size": "d_ff", "sliding_window": "window",
              "tie_word_embeddings": "tied_embeddings"}
    ref = types.ModuleType("portbench.reference.toy_moe")
    ref.BLOCK = {"family": "moe", "norm": "rms", "mlp": "swiglu",
                 "capacity_factor": 1.25}
    ref.arch_fields = lambda c: {
        **{f: c[k] for k, f in fields.items()},
        "rope_theta": c["rope_parameters"]["rope_theta"]}
    ref.layer_kinds = lambda c: [kinds] * c["num_hidden_layers"]
    seen = []
    cnt = types.ModuleType("portbench.counts.toy_moe")
    cnt.call_flops = lambda c, b, s, new: seen.append(c) or 1e12
    monkeypatch.setitem(sys.modules, ref.__name__, ref)
    monkeypatch.setitem(sys.modules, cnt.__name__, cnt)
    return ref, seen


def test_an_moe_declaration_sets_the_ports_fields_and_reaches_the_counts(
        monkeypatch):
    from portbench import tracing
    from portbench.metrics import mfu_device_pct

    ref, seen = _toy_moe(monkeypatch)
    cfg, changed = lm_serve.arch(MOE)
    assert (cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.window,
            cfg.rope_theta) == (8, 4, 24, 16, 5e5)
    assert "n_experts" not in changed          # mixtral's 8, held here
    assert changed["window"] == (4096, 16) and changed["top_k"] == (2, 4)
    assert cfg.layer_kinds() == ["moe"] * 3

    r = lm_serve.Run.__new__(lm_serve.Run)
    r.cell, r.ref, r.new = types.SimpleNamespace(config=MOE), ref, 3
    r.pool = [np.zeros((2, 5), dtype=np.int64)]
    calls = [types.SimpleNamespace(input_index=0)] * 2
    _, shapes = r.counts(calls)
    assert shapes == {"config": MOE, "counts": "toy_moe", "new": 3,
                      "calls": [[2, 5], [2, 5]]}
    reading = tracing.Reading(
        calls=2, sweeps=0, shapes=shapes, window_ns=10 ** 9,
        busy_ns=10 ** 9, host_ns={}, solve_self_ns=0, device_by_layers={},
        missing=set(), top_ops=[], idle_gaps=[])
    assert mfu_device_pct.read(reading) > 0
    assert seen == [MOE, MOE]


@pytest.mark.parametrize("fault", ["layer_kinds", "block"])
def test_an_architecture_other_than_the_references_is_refused(
        fault, monkeypatch):
    ref, _ = _toy_moe(monkeypatch, "attn" if fault == "layer_kinds"
                      else "moe")
    if fault == "block":
        monkeypatch.setattr(ref, "BLOCK", {**ref.BLOCK, "family": "dense"})
    with pytest.raises(ValueError, match="not the block the reference"):
        lm_serve.arch(MOE)


#: what the LM cell's configuration set in the port's ArchConfig, and
#: handed to its counts, before the reference declared it
PARENT_FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
                 "num_attention_heads": "n_heads",
                 "num_key_value_heads": "n_kv", "head_dim": "head_dim",
                 "intermediate_size": "d_ff", "vocab_size": "vocab",
                 "rope_theta": "rope_theta", "qkv_bias": "qkv_bias",
                 "tie_word_embeddings": "tied_embeddings"}


def test_the_lm_cells_architecture_is_its_parents():
    from repro_torch.configs.registry import get_arch

    c = spec.find_cell(BENCH, LM).config
    cfg, changed = lm_serve.arch(c)
    assert cfg == dataclasses.replace(
        get_arch("qwen2.5-32b"),
        **{f: c[k] for k, f in PARENT_FIELDS.items()})
    assert changed == {"n_layers": (64, 16), "head_dim": (0, 128),
                       "rope_theta": (10000.0, 1e6)}


def test_the_lm_cells_port_state_is_its_parents():
    """At full size, on ``meta``: layer i's weights at
    ``units.0_attn.<i>``, and the port's model takes each of them."""
    from repro_torch.models import model_init

    c = spec.find_cell(BENCH, LM).config
    cfg, _ = lm_serve.arch(c)
    w = {name: torch.empty(shape, device="meta")
         for name, (shape, _, _) in lm_dense.layout(c).items()}
    state = lm_serve.port_state(w, cfg)
    assert set(state) == {
        f"units.0_attn.{i}.{p}" for i in range(16) for p in lm_dense.LAYER
    } | {"embed.embedding", "lm_head.embedding", "final_norm.scale"}
    model, _ = model_init(None, cfg, device="meta")
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == {
        k: tuple(v.shape) for k, v in state.items()}
    assert state["embed.embedding"].shape == (152064, 5120)


def test_the_lm_cells_counts_are_handed_its_parents_sizes():
    cell = spec.find_cell(BENCH, LM)
    r = lm_serve.Run.__new__(lm_serve.Run)
    r.cell, r.ref, r.new = cell, lm_dense, cell.mix["generate"]["steps"]
    r.pool = loadgen.make_pool(cell.data, cell.mix["pool"], 2 ** 31 + 41)
    calls = [types.SimpleNamespace(input_index=i) for i in (0, 1, 2, 3, 0)]
    n, got = r.counts(calls)
    parent = {k: cell.config[k] for k in PARENT_FIELDS}
    assert n == 0 and got == {
        "config": cell.config, "counts": "lm_dense", "new": 128,
        "calls": [[32, 512], [16, 1024], [8, 2048], [4, 4096], [32, 512]]}
    for f in (counts.call_flops, counts.decode_flops, counts.decode_bytes):
        assert [f(got["config"], b, s, 128) for b, s in got["calls"]] == [
            f(parent, b, s, 128) for b, s in got["calls"]]


def test_the_lm_cells_cpu_cut_is_its_parents():
    cell, tiny = spec.find_cell(BENCH, LM), _tiny.tiny_cell(LM)
    assert tiny.config == {
        **cell.config, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "intermediate_size": 128, "vocab_size": 256}
    assert tiny.data == {**cell.data, "vocab": 256, "per_input": [
        {"batch": 2, "prompt_len": 16}, {"batch": 3, "prompt_len": 8}]}
    assert tiny.mix == {**cell.mix, "pool": 2, "generate": {"steps": 4}}
    assert tiny.solve == cell.solve and tiny.limits == cell.limits


class _Event:
    """One event of a profiler trace, as ``kineto_results.events()``
    gives it."""

    def __init__(self, name, start, end, device=False, corr=0, link=0):
        self._v = (name, start, end, corr, link)
        self._dev = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._v[3]

    def linked_correlation_id(self):
        return self._v[4]


#: a spans-only window on a card: a user-scope program span inside
#: ``generate`` launches one kernel, and one more is launched outside it;
#: both user-scope spans draw a shadow range on the device's timeline
SPANS_ONLY_TRACE = [
    _Event("portbench.window", 0, 1000),
    _Event("portbench.generate", 10, 990),
    _Event("repro_torch.user", 100, 400),
    _Event("cudaLaunchKernel", 150, 160, corr=7),
    _Event("cudaLaunchKernel", 700, 710, corr=8),
    _Event("gemm", 500, 600, device=True, corr=7),
    _Event("copy", 800, 850, device=True, corr=8),
    _Event("repro_torch.user", 500, 900, device=True),
    _Event("portbench.generate", 480, 950, device=True),
]


def test_the_program_spans_shadows_on_the_device_are_not_work():
    """A user-scope ``repro_torch.<name>`` span is read with the device
    time of the kernels launched inside it; its shadow range on the
    device's timeline is neither a device op nor busy time."""
    from portbench import program, tracing

    p = program.parse(SPANS_ONLY_TRACE)
    assert p.host_ns == {"user": 300}
    assert p.device_ns == {"user": 100} and p.device_ops == {"user": 1}
    assert p.on_device
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(
            events=lambda: SPANS_ONLY_TRACE)))
    r = tracing.read(prof, calls=1, sweeps=0, shapes={}, missing=set())
    assert r.busy_ns == 150
    assert sorted(n for n, _ in r.top_ops) == ["copy", "gemm"]


def test_a_user_scope_program_span_in_generate_is_read(monkeypatch):
    """Under the LM window's spans-only profile a ``record_function``
    named ``repro_torch.<name>``, opened inside ``generate``, is read by
    ``program.of``; a function-scope span (``repro_torch.obs.span``) is
    not recorded at all."""
    from portbench import program
    from repro_torch import obs
    from repro_torch.serve import engine

    assert lm_serve.HOST_OPS is False
    orig = engine.model_apply

    def apply(*args, **kwargs):
        with torch.profiler.record_function(program.SPAN + "user"), \
                obs.span("fast"):
            return orig(*args, **kwargs)

    got = []
    monkeypatch.setattr(engine, "model_apply", apply)
    monkeypatch.setattr(run, "per_layer",
                        lambda cell, reading: got.append(
                            program.of(reading)) or {})
    out = run.run_cell(_tiny.tiny_cell(LM), 2 ** 31 + 43, 0.0, True, "cpu",
                       time.perf_counter())
    assert out["judged"]["correct"] is True
    [p] = got
    assert p is not None and set(p.host_ns) == {"user"}
    assert p.host_ns["user"] > 0


def test_a_run_that_loads_jax_exits_3_and_prints_no_result(monkeypatch,
                                                           capsys):
    monkeypatch.setattr(device, "available", lambda chips: None)
    monkeypatch.setattr(run, "run_cell", lambda *a: {"judged": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", LM, "--seed", "1", "--seconds", "1"]) == 3
    captured = capsys.readouterr()
    assert captured.out == "" and "jax" in captured.err
