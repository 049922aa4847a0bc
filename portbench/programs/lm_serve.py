"""The ``lm_serve`` program: ``repro_torch.serve.engine.ServeEngine``'s
``generate`` on static batches of prompts, greedy.

The configuration's reference module
(``portbench/reference/<reference.module>.py``) declares the architecture
it computes, so that a configuration of another block comes as new files
alone:

- ``arch_fields(c)``: the port's ``ArchConfig`` fields that configuration
  ``c`` sets (nested keys may map too);
- ``layer_kinds(c)``: the port's block kind of each layer, at ``c``'s
  depth;
- ``BLOCK``: the other ``ArchConfig`` fields it computes as given (family,
  norm, MLP, window);
- ``SMOKE``: the CPU tests' cut of its configurations (``_tiny``);
- ``make_weights(c, seed, device)`` and ``logits(w, c, tokens, start,
  mm=)``: the weights, ``layers.<path>`` stacked over every layer or
  ``layers_<kind>.<path>`` over the layers of one kind (``port_state``),
  and the forward pass.

Set-up builds the port's architecture that the configuration names
(``architecture``, a key of the port's registry) with the reference's
fields put in its place (``dataclasses.replace``), checks its layers'
kinds and ``BLOCK`` against the reference's, draws the weights from the
seed on the card (``make_weights``: one draw a stacked tensor, float32,
the port's parameter type) and hands them to the port by name: the model
is built on the ``meta`` device and takes those very tensors, each
parameter one (``load_state_dict(assign=True)``, strict), so the
reference reads what the program reads and nothing the program made.
Then the pool of prompts from the seed (input i takes the mix's i-th
``per_input`` batch and prompt length), an engine for each prompt length
with its cache sized to the prompt and the new tokens, and one warm-up
``generate`` of each input's shape with two new tokens: every shape the
window uses, since a decode step's shapes are the same from one step to
the next.

The window calls ``generate(prompt, steps=new)`` on the pool's prompts in
turn. A wrapper on the engine's ``next_tokens`` (``RECORD``) copies each
step's float32 logits at ``ROWS`` rows of the batch, half from each half,
drawn from the seed for each input, into a pinned host buffer of that
input, without a synchronisation (4 rows of 152,064 logits, 2.4 MB a
step); each buffer ends up holding its input's last call, and none of it
lies in the card's memory. A traced window opens ``portbench.prefill``
and ``portbench.decode`` spans around the engine's ``model_apply``
(``MODE_SPANS``), by ``mode.kind``, and records no other host op: its
profile keeps user-scope ranges alone (``HOST_OPS``,
``tracing.profile``), so a span of the port's on this path is read
(``portbench/program.py``) where it is a ``record_function``, and not
where it is a function-scope op such as ``repro_torch.obs.span``.

The comparison that decides ``correct``, once the window has closed: for
the sampled rows of each input's last call, the plain reference
(float32, TF32 off) runs the whole forward pass over the prompt and the
call's own new tokens (teacher forcing) and gives the logits at the
prompt's last position and at each decode position. Two numbers, the
worst over rows, positions and calls:

- ``logit_rel_err``: ||program - reference||_2 / ||reference||_2 of the
  logits at one position;
- ``token_gap``: the reference's best logit less its logit of the token
  the program served there (0 where they agree; the served token is
  greedy, so rounding moves it only among near ties).

Every earlier call of an input served the same tokens as its last call,
or its sampled rows are judged too, by ``token_gap`` (its logits are not
kept). A call that raised, or returned other than (B, new) tokens, fails.
"""
from __future__ import annotations

import dataclasses
import importlib
import sys
import time

import numpy as np
import torch

from portbench import loadgen, tracing
from portbench.programs import worst
from portbench.reference import precision

CALL_SPAN = "generate"
NUMBERS = ("logit_rel_err", "token_gap")
#: a traced window records the spans and the launches, not every op: the
#: decode step is paced by the host's eager issue of its ops
HOST_OPS = False
#: the engine's argmax, called with the step's (B, V) logits first
RECORD = ("repro_torch.serve.engine", "next_tokens")
#: the engine's model call, as f(params, cfg, inputs, mode, ...)
MODE_SPANS = ("repro_torch.serve.engine", "model_apply")
ROWS = 4               # rows of each batch judged, half from each half
#: SeedSequence entries of the weights' stream and of input i's judged
#: rows (the pool's inputs are 0..)
WEIGHTS = 2 ** 32
JUDGED = 2 ** 32 + 1
PAD_TO = 128           # the port's embedding rows, padded with zeros
BAD = 1e30             # what a NaN reads as


def reference_of(c: dict):
    """The plain reference module that configuration ``c`` names."""
    return importlib.import_module(
        f"portbench.reference.{c['reference']['module']}")


def arch(c: dict):
    """The port's ArchConfig for configuration ``c``, -> (config, the
    fields that differ from the registry's entry)."""
    from repro_torch.configs.registry import get_arch

    base = get_arch(c["architecture"])
    ref = reference_of(c)
    new = ref.arch_fields(c)
    cfg = dataclasses.replace(base, **new)
    port = {k: getattr(cfg, k) for k in ref.BLOCK}
    kinds = cfg.layer_kinds()
    if port != ref.BLOCK or kinds != ref.layer_kinds(c):
        raise ValueError(f"{base.name} is {port} with layers {kinds}, not "
                         f"the block the reference computes, {ref.BLOCK} "
                         f"with layers {ref.layer_kinds(c)}")
    changed = {f: (getattr(base, f), v) for f, v in new.items()
               if getattr(base, f) != v}
    return cfg, changed


def places(cfg) -> list:
    """(where the port's model holds layer i, its kind), in the layers'
    order, as ``models/lm.py`` lays them out: the pattern's units,
    ``units.<slot>_<kind>.<unit>``, then the remainder,
    ``rest.<slot>_<kind>``."""
    from repro_torch.models.lm import _unit_layout

    n_units, pat, rest = _unit_layout(cfg)
    return ([(f"units.{j}_{kind}.{u}", kind) for u in range(n_units)
             for j, kind in enumerate(pat)]
            + [(f"rest.{j}_{kind}", kind) for j, kind in enumerate(rest)])


def port_state(w: dict, cfg) -> dict:
    """The port's parameters by name, each one of the tensors of ``w``
    (a view; the embeddings padded to the port's row count): the
    reference's ``layers.<path>``, stacked on a leading axis over every
    layer, or ``layers_<kind>.<path>``, over the layers of that kind in
    order, is layer i's ``<place>.<path>`` (``places``). Raises where a
    stack does not hold one entry a layer, or two weights name one
    parameter."""
    where = places(cfg)
    out = {}

    def put(name, t):
        if name in out:
            raise ValueError(f"two of the reference's weights are {name}")
        out[name] = t

    for name, t in w.items():
        stack, _, path = name.partition(".")
        if stack == "layers" or stack.startswith("layers_"):
            kind = stack[len("layers_"):]
            at = [p for p, k in where if kind in ("", k)]
            if t.shape[0] != len(at):
                raise ValueError(f"{name} stacks {t.shape[0]} layers, not "
                                 f"the {len(at)} it is held by")
            for p, layer in zip(at, t):
                put(f"{p}.{path}", layer)
        elif name.endswith(".embedding") and t.shape[0] % PAD_TO:
            put(name, torch.nn.functional.pad(
                t, (0, 0, 0, -t.shape[0] % PAD_TO)))
        else:
            put(name, t)
    return out


def judged_rows(b: int, seed: int) -> list:
    """The rows of a batch of ``b`` that the judge reads: ``ROWS`` of
    them drawn from ``seed``, half from each half of the batch (every row
    where ``b <= ROWS``)."""
    if b <= ROWS:
        return list(range(b))
    rng = np.random.default_rng(seed)
    h = b // 2
    lo = rng.choice(h, ROWS // 2, replace=False)
    hi = h + rng.choice(b - h, ROWS - ROWS // 2, replace=False)
    return sorted(int(r) for r in np.concatenate([lo, hi]))


class Recorder:
    """Wraps the engine's ``next_tokens`` so that, while ``into`` is
    (host buffer (new, rows, V), the rows on the logits' device, the
    batch), each call's logits at those rows are copied into the buffer's
    next step, without a synchronisation (NaN where the logits are not
    the batch's); ``n`` counts the steps."""

    def __init__(self):
        self.mod = importlib.import_module(RECORD[0])
        self.orig = getattr(self.mod, RECORD[1])
        self.into, self.n = None, 0

        def record(logits, *args, **kwargs):
            if self.into is not None:
                buf, rows, b = self.into
                if self.n < len(buf) and logits.shape[0] != b:
                    buf[self.n].fill_(float("nan"))
                elif self.n < len(buf):
                    buf[self.n].copy_(logits.index_select(0, rows),
                                      non_blocking=True)
                self.n += 1
            return self.orig(logits, *args, **kwargs)

        setattr(self.mod, RECORD[1], record)

    def close(self) -> None:
        setattr(self.mod, RECORD[1], self.orig)


class ModeSpans:
    """Context manager: wraps the engine's ``model_apply`` in a
    ``portbench.<mode.kind>`` span."""

    LAYERS = {"prefill", "decode"}

    def __init__(self):
        self.missing: set = set()
        self._undo = None

    def __enter__(self):
        mod = importlib.import_module(MODE_SPANS[0])
        attr = MODE_SPANS[1]
        if not hasattr(mod, attr):
            self.missing = set(self.LAYERS)
            print(f"portbench: {':'.join(MODE_SPANS)} does not exist; the "
                  "prefill and decode metrics are left out", file=sys.stderr)
            return self
        orig = getattr(mod, attr)

        def span(params, cfg, inputs, mode, *args, **kwargs):
            with tracing.record_function(tracing.PREFIX + mode.kind):
                return orig(params, cfg, inputs, mode, *args, **kwargs)

        setattr(mod, attr, span)
        self._undo = (mod, attr, orig)
        return self

    def __exit__(self, *exc):
        if self._undo is not None:
            setattr(*self._undo)
            self._undo = None
        return False


class Run:
    def __init__(self, cell, seed: int, dev: str, sync):
        from repro_torch.models import model_init
        from repro_torch.serve.engine import ServeEngine

        c = cell.config
        self.cell, self.new = cell, cell.mix["generate"]["steps"]
        marks = [time.perf_counter()]
        self.ref = reference_of(c)
        cfg, changed = arch(c)
        self.cfg = cfg
        self.weights = self.ref.make_weights(
            c, loadgen.input_seed(seed, WEIGHTS), dev)
        model, _ = model_init(None, cfg, device="meta")
        model.load_state_dict(port_state(self.weights, cfg), assign=True)
        sync()
        marks.append(time.perf_counter())
        self.pool = loadgen.make_pool(cell.data, cell.mix["pool"], seed)
        self.inputs = [(i, torch.from_numpy(x).to(dev))
                       for i, x in enumerate(self.pool)]
        self.engines = {s: ServeEngine(cfg, model, max_len=s + self.new)
                        for s in {x.shape[1] for x in self.pool}}
        self.rows = [judged_rows(x.shape[0], loadgen.input_seed(
            seed, JUDGED + i)) for i, x in enumerate(self.pool)]
        width = -(-c["vocab_size"] // PAD_TO) * PAD_TO
        self.record = [
            (torch.empty((self.new, len(r), width), dtype=torch.float32,
                         pin_memory=dev == "cuda"),
             torch.tensor(r, device=dev), x.shape[0])
            for r, x in zip(self.rows, self.pool)]
        sync()
        marks.append(time.perf_counter())
        self.rec = Recorder()
        self.recorded = [0] * len(self.pool)   # steps of each last call
        shapes = {}
        for x in self.inputs:
            shapes.setdefault(tuple(x[1].shape), x)
        for i, prompt in shapes.values():             # warm-up
            self.rec.into, self.rec.n = self.record[i], 0
            self.engines[prompt.shape[1]].generate(prompt, steps=2)
        self.rec.into = None
        sync()
        marks.append(time.perf_counter())
        self.steps = list(zip(("weights", "prompts", "warm-up generate"),
                              (b - a for a, b in zip(marks, marks[1:]))))
        print(f"portbench: {cfg.name}, changed from the registry: "
              f"{changed}", file=sys.stderr)

    def call(self, x):
        i, prompt = x
        self.rec.into, self.rec.n = self.record[i], 0
        try:
            return self.engines[prompt.shape[1]].generate(prompt,
                                                          steps=self.new)
        finally:
            self.rec.into = None
            self.recorded[i] = self.rec.n

    def spans(self):
        return ModeSpans()

    def values(self, calls: list, window_s: float) -> dict:
        ok = [c for c in calls if c.error is None]
        return {"generate_s": window_s / len(ok)} if ok else {}

    def counts(self, calls: list) -> tuple[int, dict]:
        return 0, {"config": self.cell.config,
                   "counts": self.cell.config["counts"],
                   "new": self.new,
                   "calls": [[int(n) for n in self.pool[c.input_index].shape]
                             for c in calls]}

    def release(self) -> None:
        self.rec.close()
        self.engines = self.inputs = None


def _gap(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """The reference's best logit less its logit of the ``served`` token
    (P,) at each position; a served id outside the vocabulary reads as
    the largest gap."""
    vocab = ref.shape[-1]
    served = served.to(ref.device).long()
    got = ref.gather(1, served.clamp(0, vocab - 1)[:, None])[:, 0]
    got = torch.where((served >= 0) & (served < vocab), got, -BAD)
    return ref.max(dim=-1).values - got


def _worst(v: torch.Tensor) -> float:
    # a NaN compares false with every limit and with max(): read it as
    # the largest number
    return float(torch.nan_to_num(v, nan=BAD, posinf=BAD).max())


def _compare(prog: torch.Tensor, ref: torch.Tensor,
             served: torch.Tensor) -> dict:
    """The numbers of logits ``prog`` (P, V') against ``ref`` (P, V) and
    the ``served`` token (P,) at each position. The port pads its
    vocabulary to a multiple of 128 with logits of -1e30, and those
    columns are not compared."""
    vocab = ref.shape[-1]
    prog = prog.to(ref.device)
    rel = (prog[:, :vocab] - ref).norm(dim=-1) / ref.norm(dim=-1)
    return {"logit_rel_err": _worst(rel),
            "token_gap": _worst(_gap(ref, served))}


def _rows(run, i: int, tokens: torch.Tensor):
    """The judged rows of input ``i``'s call that served ``tokens``
    (B, new): (the row's sequence as the reference reads it, its served
    tokens (new,)), in ``run.rows[i]``'s order."""
    dev = run.weights["embed.embedding"].device
    tokens = tokens.to(dev)
    for r in run.rows[i]:
        prompt = torch.from_numpy(np.asarray(run.pool[i][r])).to(dev)
        seq = torch.cat([prompt.long(), tokens[r, :-1].long()])
        yield seq, tokens[r]


def _reference(run, cell, i: int, seq: torch.Tensor, **kw) -> torch.Tensor:
    start = run.pool[i].shape[1] - 1
    return run.ref.logits(run.weights, cell.config, seq, start, **kw)


def judge(cell, run, calls: list, device) -> dict:
    """-> {"correct", "failed", "compared", "numbers": {name: {"value",
    "limit"}}, "why"}."""
    failed, last = [], {}
    for n, c in enumerate(calls):
        want = (run.pool[c.input_index].shape[0], run.new)
        if c.error is not None:
            failed.append(f"call {n}: raised")
        elif tuple(c.result.shape) != want:
            failed.append(f"call {n}: tokens {tuple(c.result.shape)}, "
                          f"not {want}")
        else:
            last[c.input_index] = n
    seen = dict.fromkeys(NUMBERS, 0.0)
    for i, n in sorted(last.items()):
        if run.recorded[i] != run.new:
            failed.append(f"input {i}: {run.recorded[i]} steps recorded, "
                          f"not {run.new}")
            continue
        kept = calls[n].result
        logits = run.record[i][0]                     # (new, rows, V)
        for k, (seq, served) in enumerate(_rows(run, i, kept)):
            ref = _reference(run, cell, i, seq)
            seen = worst(seen, _compare(logits[:, k], ref, served))
        for c in calls:
            if c.input_index != i or c is calls[n] or c.error is not None \
                    or c.result.shape != kept.shape \
                    or torch.equal(c.result, kept):
                continue
            for seq, served in _rows(run, i, c.result):
                gap = _worst(_gap(_reference(run, cell, i, seq), served))
                seen["token_gap"] = max(seen["token_gap"], gap)
    numbers = {k: {"value": seen[k], "limit": cell.limits[k]}
               for k in NUMBERS}
    within = all(v["value"] <= v["limit"] for v in numbers.values())
    compared = len(calls) - sum(c.error is not None for c in calls)
    return {"correct": bool(last and compared and not failed and within),
            "failed": len(failed), "compared": compared,
            "numbers": numbers, "why": failed[:5]}


def _fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return precision.e4m3(a) @ precision.e4m3(b)


def readings(cell, seed: int, program: bool, control: bool) -> dict:
    """One seed's line for ``calibrate.py``: each pool input generated
    once, as the window does, and the judged rows compared as the judge
    compares them; the program's numbers, and the control's: the
    reference with every matrix product's inputs rounded to float8 e4m3
    (``precision.e4m3``, one scale a tensor), the precision below the
    configuration's bfloat16, at each position of the same prompts and
    tokens, its served token the one it puts first."""
    run = Run(cell, seed, "cuda", torch.cuda.synchronize)
    try:
        served = {x[0]: run.call(x) for x in run.inputs}
    finally:
        run.release()
    torch.cuda.synchronize()
    prog, ctl, t_ref, t_ctl = {}, {}, 0.0, 0.0
    for i, tokens in served.items():
        for k, (seq, toks) in enumerate(_rows(run, i, tokens)):
            t0 = time.perf_counter()
            ref = _reference(run, cell, i, seq)
            torch.cuda.synchronize()
            t_ref += time.perf_counter() - t0
            if program:
                prog = worst(prog, _compare(run.record[i][0][:, k], ref,
                                            toks))
            if control:
                t0 = time.perf_counter()
                low = _reference(run, cell, i, seq, mm=_fp8_mm)
                ctl = worst(ctl, _compare(low, ref, low.argmax(dim=-1)))
                torch.cuda.synchronize()
                t_ctl += time.perf_counter() - t0
    line = {"seed": seed, "reference_s": t_ref, "control_s": t_ctl}
    if prog:
        line["program"] = prog
    if ctl:
        line["control"] = ctl
    return line
