"""The stacked cache written in place (``models/stacked.py``,
``attention.prefill_into_cache``, ``launch/steps.py``), on one device.

  * ``stacked.prefill`` and ``stacked.decode_step`` return the stacked
    cache they were given: every leaf the same storage (``data_ptr``),
    but a leaf whose dtype the step changes (the RG-LRU's f32 state after
    the cache's bf16 zeros), which is stacked anew as before;
  * ``make_serve_step`` after ``make_prefill_step`` returns the cache it
    was given, every leaf, step after step;
  * logits and caches are bitwise those of the per-layer path
    (``lm.prefill`` and ``lm.decode_step`` on ``lm.init_cache``'s layers,
    then ``stack_cache``), at f32 and bf16, for the attention, RG-LRU,
    xLSTM and encoder-decoder families, a windowed layer's ring included;
  * a prompt written into a cache that held a longer earlier prompt gives
    the fresh cache's bits: the slots past it are emptied.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm, stacked  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

# arch: (layers, prompt); each stacks two cycles of its pattern, and the
# reduced windows (64) are shorter than the 80-slot cache
CASES = {"gemma2-2b": (4, 72), "recurrentgemma-9b": (6, 72),
         "xlstm-350m": (4, 128), "seamless-m4t-medium": (2, 40)}
B, EXTRA, STEPS = 2, 8, 3


def _setup(arch, dtype, seed=0):
    layers, s = CASES[arch]
    cfg = reduced(get_config(arch), n_layers=layers)
    gen = torch.Generator().manual_seed(seed)
    params = stacked.init_params_stacked(cfg, gen, dtype)
    toks = torch.randint(0, cfg.vocab_size, (B, s), generator=gen,
                         dtype=torch.int32)
    fe = None
    if cfg.frontend is not None:
        fe = torch.randn((B, cfg.frontend.seq_len, cfg.frontend.feature_dim),
                         generator=gen).to(dtype)
    return cfg, params, toks, fe


def _ptrs(tree):
    return [x.data_ptr() for x in leaves(tree)]


def _same_bits(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", sorted(CASES))
def test_stacked_steps_write_the_cache_they_were_given(arch, dtype):
    cfg, params, toks, fe = _setup(arch, dtype)
    s = toks.shape[1]
    n = s + EXTRA
    cache_st = stacked.init_cache_stacked(cfg, B, n, dtype=dtype)
    given = leaves(cache_st)
    logits, out = stacked.prefill(params, cfg, toks, cache_st, frontend=fe)
    # the per-layer path, restacked as the reference's scan stacks it
    per = stacked.unstack_params(params, cfg)
    w_logits, w_cache = lm.prefill(per, cfg, toks,
                                   lm.init_cache(cfg, B, n, dtype=dtype),
                                   frontend=fe)
    assert torch.equal(logits, w_logits)
    _same_bits(out, stacked.stack_cache(w_cache, cfg))
    for x, y in zip(given, leaves(out)):
        if y.dtype == x.dtype:
            assert y.data_ptr() == x.data_ptr()
        else:   # stacked anew, as the stack's dtype changes
            assert (x.dtype, y.dtype) == (dtype, torch.float32)
    tok = logits.argmax(-1).to(torch.int32)
    for i in range(STEPS):
        ptrs = _ptrs(out)
        logits, out2 = stacked.decode_step(params, cfg, tok, s + i, out)
        w_logits, w_cache = lm.decode_step(per, cfg, tok, s + i,
                                           w_cache)
        assert _ptrs(out2) == ptrs
        assert torch.equal(logits, w_logits)
        _same_bits(out2, stacked.stack_cache(w_cache, cfg))
        out, tok = out2, logits.argmax(-1).to(torch.int32)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_serve_step_returns_the_cache_it_was_given(arch):
    cfg, params, toks, fe = _setup(arch, torch.bfloat16, seed=1)
    s = toks.shape[1]
    shape = dict(seq_len=s + EXTRA, global_batch=B)
    pf, _ = steps.make_prefill_step(
        cfg, InputShape("p", kind="prefill", **shape))
    sv, _ = steps.make_serve_step(
        cfg, InputShape("d", kind="decode", **shape))
    logits, cache = pf(params, toks) if fe is None else pf(params, toks, fe)
    tok = logits.argmax(-1).to(torch.int32)
    for i in range(STEPS):
        ptrs = _ptrs(cache)
        logits, cache = sv(params, cache, tok, s + i)
        assert _ptrs(cache) == ptrs
        tok = logits.argmax(-1).to(torch.int32)


@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-9b"])
def test_prefill_into_a_used_cache_gives_the_fresh_caches_bits(arch):
    cfg, params, toks, fe = _setup(arch, torch.float32, seed=2)
    s = toks.shape[1]
    n = s + EXTRA
    per = stacked.unstack_params(params, cfg)
    longer = torch.cat([toks, toks[:, :EXTRA]], dim=1)
    used = lm.prefill(per, cfg, longer, lm.init_cache(cfg, B, n))[1]
    logits, cache = lm.prefill(per, cfg, toks, used)
    w_logits, w_cache = lm.prefill(per, cfg, toks, lm.init_cache(cfg, B, n))
    assert torch.equal(logits, w_logits)
    _same_bits(cache, w_cache)
    slots = [st.slot_pos for st in cache["layers"] if hasattr(st, "slot_pos")]
    assert slots and all(int((sp >= 0).sum()) == min(s, len(sp))
                         for sp in slots)
    assert np.all([bool((sp[s:] == -1).all()) for sp in slots
                   if len(sp) > s])


def _rank_mesh_serve(cm, arch, b, prompt):
    """Prefill and serve steps on a (2, 2) mesh: the logits, the cache
    gathered, and whether every serve step returned the local shards it
    was given."""
    from repro_torch.launch import mesh as mesh_mod
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")
    return _serve_run(arch, b, prompt, mesh)


def _serve_run(arch, b, prompt, mesh=None):
    """The first ``prompt`` tokens of the case's prompt, in a cache of
    the case's prompt + EXTRA slots."""
    cfg, params, toks, fe = _setup(arch, torch.float32, seed=3)
    shape = dict(seq_len=toks.shape[1] + EXTRA, global_batch=b)
    toks = toks[:1, :prompt].repeat(b, 1)
    s = toks.shape[1]
    pf, _ = steps.make_prefill_step(
        cfg, InputShape("p", kind="prefill", **shape), mesh=mesh,
        dtype=torch.float32)
    sv, _ = steps.make_serve_step(
        cfg, InputShape("d", kind="decode", **shape), mesh=mesh,
        dtype=torch.float32)
    logits, cache = pf(params, toks)
    outs, same = [logits], []
    tok = logits.argmax(-1).to(torch.int32)
    for i in range(STEPS):
        ptrs = [getattr(x, "_local_tensor", x).data_ptr()
                for x in leaves(cache)]
        logits, cache = sv(params, cache, tok, s + i)
        same.append(ptrs == [getattr(x, "_local_tensor", x).data_ptr()
                             for x in leaves(cache)])
        outs.append(logits)
        tok = logits.argmax(-1).to(torch.int32)
    whole = [x.full_tensor() if hasattr(x, "full_tensor") else x
             for x in leaves(cache)]
    return torch.stack(outs), whole, same


@pytest.mark.parametrize("b,prompt", [(4, 72), (1, 72), (4, 24)])
def test_mesh_prefill_and_serve_write_the_local_shards(tmp_path, b, prompt):
    """gemma2-2b at 4 layers (two stacked cycles) on a (2, 2) mesh of gloo
    ranks: each rank's cache is made as its own shards and written in
    place (the stacked ``slot_pos`` is split on its layer axis, so its
    layers are written back into the stack); logits and the cache within
    1e-4 of one device's.  At B=1 < data the serve steps split the cache's
    sequence over both axes, where the prefill's rules split it over
    ``model``: the first serve step moves it once, the later ones keep
    their shards.  A 24-token prompt in 80 slots (64 on a windowed layer)
    lies wholly in the first ``model`` rank's shard: the second rank's
    slots start past it and are all emptied."""
    from repro_torch.launch import mesh as mesh_mod
    ranks = mesh_mod.run_ranks(_rank_mesh_serve, 4, device="cpu",
                               init_file=str(tmp_path / "rendezvous"),
                               args=("gemma2-2b", b, prompt))
    want_logits, want_cache, _ = _serve_run("gemma2-2b", b, prompt)
    for logits, cache, same in ranks:
        assert all(same[1:]) and same[0] == (b >= 2)
        top = float(want_logits.abs().max())
        assert float((logits - want_logits).abs().max()) <= 1e-4 * top
        assert len(cache) == len(want_cache)
        for x, w in zip(cache, want_cache):
            assert x.dtype == w.dtype and x.shape == w.shape
            if w.dtype == torch.int32:
                assert torch.equal(x, w)
            else:
                scale = max(float(w.abs().max()), 1e-30)
                assert float((x - w).abs().max()) <= 1e-4 * scale
