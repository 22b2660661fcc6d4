"""The LM steps' named profiler ranges (``obs.range``, ``obs.RANGES``).

  * under a CPU ``torch.profiler`` one prefill and one decode step of tiny
    qwen2-, granite- and xLSTM-shaped configs open every range of their
    layers, each nested as the program opens it (``rope`` inside
    ``qkv_proj`` inside the step; every other layer's range directly inside
    the step, the final ``norm`` inside ``unembed``);
  * with no profiler recording no ``record_function`` is entered, and the
    logits and caches are bitwise those of a profiled run;
  * ``obs.span`` is a profiler range while a profiler records, with the
    tracer on or off, and its off path stays the shared no-op span; with
    the tracer off its profiled span keeps the no-op ``set``, so an async
    sweep's event engine runs under a profiler and gives the records of
    an unprofiled run.
"""

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import stacked  # noqa: E402
from repro_torch.obs.trace import NULL_SPAN  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

B, S, CACHE = 2, 16, 24
LAYERS = ("embed", "norm", "qkv_proj", "rope", "attn_core", "cache_write",
          "out_proj", "unembed")
FFN = {"qwen2-7b": ("mlp",),
       "granite-moe-1b-a400m": ("moe_router", "moe_expert_products",
                                "moe_combine")}
# the program range each range opens inside, where it is not the step
PARENT = {"rope": ("qkv_proj",), "norm": ("prefill_step", "serve_step",
                                          "unembed")}


def _steps(arch):
    """A tiny config's prefill and serve steps, f32, with params and a
    prompt drawn from a seed."""
    cfg = reduced(get_config(arch), n_layers=2, d_model=64)
    prefill, _ = steps.make_prefill_step(
        cfg, InputShape("t", seq_len=CACHE, global_batch=B, kind="prefill"),
        dtype=torch.float32)
    serve, _ = steps.make_serve_step(
        cfg, InputShape("t", seq_len=CACHE, global_batch=B, kind="decode"),
        dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = stacked.init_params_stacked(cfg, gen, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         dtype=torch.int32)
    return prefill, serve, params, toks


def _run(arch):
    """One prefill and one decode step: (logits, logits, cache)."""
    prefill, serve, params, toks = _steps(arch)
    logits, cache = prefill(params, toks)
    tok = logits.argmax(-1).to(torch.int32)
    out, cache = serve(params, cache, tok, S)
    return logits, out, cache


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _range_parent(ev):
    """The innermost program range around the profiler event ``ev``."""
    p = ev.cpu_parent
    while p is not None and p.name not in obs.RANGES:
        p = p.cpu_parent
    return None if p is None else p.name


def _ranges_under(events, step):
    """{range: the set of program ranges directly around it} for the
    ranges inside the ``step`` range's events."""
    seen = {}
    for ev in events:
        if ev.name not in obs.RANGES or ev.name == step:
            continue
        anc, p = [], ev.cpu_parent
        while p is not None:
            anc.append(p.name)
            p = p.cpu_parent
        if step in anc:
            seen.setdefault(ev.name, set()).add(_range_parent(ev))
    return seen


@pytest.mark.parametrize("arch", sorted(FFN))
def test_every_range_opens_and_nests_in_both_steps(arch):
    _, events = _profiled(lambda: _run(arch))
    names = [ev.name for ev in events]
    assert names.count("prefill_step") == 1
    assert names.count("serve_step") == 1
    for step in ("prefill_step", "serve_step"):
        seen = _ranges_under(events, step)
        assert set(seen) == set(LAYERS) | set(FFN[arch]), (step, seen)
        for name, parents in seen.items():
            allowed = PARENT.get(name, (step,))
            assert parents <= set(allowed), (step, name, parents)
        assert seen["rope"] == {"qkv_proj"}
    assert not any(_range_parent(ev) for ev in events
                   if ev.name in ("prefill_step", "serve_step"))


def test_the_slstm_loop_is_a_range_of_its_own():
    prefill, _, params, toks = _steps("xlstm-350m")
    _, events = _profiled(lambda: prefill(params, toks))
    loops = [ev for ev in events if ev.name == "slstm_step_loop"]
    assert loops and all(_range_parent(ev) == "prefill_step"
                         for ev in loops)


@pytest.mark.parametrize("arch", sorted(FFN))
def test_no_range_enters_without_a_profiler_and_bits_hold(arch,
                                                          monkeypatch):
    import torch.autograd.profiler as prof_mod
    entered = []
    real = prof_mod.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(prof_mod, "record_function", Counting)
    plain = _run(arch)
    assert entered == []
    assert obs.range(obs.NORM) is NULL_SPAN
    traced, _ = _profiled(lambda: _run(arch))
    assert set(entered) >= {"prefill_step", "serve_step", "attn_core"}
    for a, b in zip(leaves(plain), leaves(traced)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("tracer_on", [False, True], ids=["off", "on"])
def test_obs_span_is_a_profiler_range_while_one_records(tracer_on):
    obs.disable()
    obs.tracer.clear()      # whatever an earlier test left in the tracer
    try:
        if tracer_on:
            obs.enable()
        assert (obs.span("plan") is NULL_SPAN) != tracer_on
        _, events = _profiled(lambda: obs.span("plan", phase="plan")
                              .__enter__().__exit__(None, None, None))
        with obs.span("pack"):
            pass
        spans = [sp.name for sp in obs.tracer.spans]
    finally:
        obs.disable()
        obs.tracer.clear()
    assert [ev.name for ev in events if ev.name == "plan"] == ["plan"]
    assert spans == (["plan", "pack"] if tracer_on else [])


def test_a_profiled_span_keeps_set_with_the_tracer_off():
    obs.disable()
    obs.tracer.clear()

    def collect():
        with obs.span("COLLECT", phase="collect", n_live=2) as sp:
            assert sp.set(n_lanes=1, n_deferred=0) is sp
        return sp

    sp, events = _profiled(collect)
    assert sp is not NULL_SPAN
    assert [ev.name for ev in events if ev.name == "COLLECT"] == ["COLLECT"]
    assert obs.tracer.spans == []


def test_an_async_sweep_runs_under_a_profiler():
    from repro_torch.experiments import TrialSpec, run_sweep
    spec = TrialSpec(dataset="emnist", aggregator="fedavg", seed=0,
                     tuner="fedtune", m0=2, e0=1.0, rounds=1, mode="async",
                     target_accuracy=0.99, batch_size=5, eval_points=64)
    obs.disable()
    plain = run_sweep([spec], device="cpu")
    profiled, events = _profiled(lambda: run_sweep([spec], device="cpu"))
    names = {ev.name for ev in events}
    assert {"COLLECT", "PACK", "APPLY"} <= names
    a, b = plain[0], profiled[0]
    assert (a.history_acc, a.cost, a.dispatch_log) == (
        b.history_acc, b.cost, b.dispatch_log)
