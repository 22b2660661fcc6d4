"""The rest of the LM zoo in the port against the JAX reference, on the CPU:
the MoE FFN (granite-moe, dbrx), the xLSTM mixers (xlstm-350m), the
encoder-decoder with cross-attention (seamless-m4t) and the vision-patch
prefix (internvl2).

Inputs are made with numpy from a seed; params are the reference's,
carried across by ``repro_torch.weights``.  The reference runs with
``use_kernel=False``, as its own tests do; on CPU tensors the port runs
its plain paths (the kernel's counterparts are held on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``).

Tolerances, as ``tests/test_torch_lm.py``: 1e-5 for single modules (f32;
XLA and PyTorch sum the matmuls in other orders), 1e-4 for a whole
model's logits and cache.  MoE expert ids must be equal: the port's
stable descending sort breaks ties toward the lower index, as
``jax.lax.top_k`` does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs.base import LayerSpec as JLayerSpec  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, MoEConfig  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import xlstm as xl  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

XLSTM = "xlstm-350m"
SEAMLESS = "seamless-m4t-medium"
INTERNVL = "internvl2-1b"
NEW_ARCHS = (XLSTM, "granite-moe-1b-a400m", "dbrx-132b", SEAMLESS, INTERNVL)
MODULE_TOL = 1e-5
MODEL_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _randn(rng, shape, scale=1.0, loc=0.0):
    return (rng.standard_normal(shape) * scale + loc).astype(np.float32)


def _cfgs(arch, n_layers=3):
    return (reduced(get_config(arch), n_layers=n_layers),
            jreduced(jget_config(arch), n_layers=n_layers))


def _tree(jp):
    return jax.tree.map(lambda a: _t(np.asarray(a)), jp)


def _params(cfg, jcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    template = build_model(cfg).init(0, "cpu")
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                             template=template), jp


def _frontend(cfg, b, rng):
    if cfg.frontend is None:
        return None
    return _randn(rng, (b, cfg.frontend.seq_len, cfg.frontend.feature_dim))


def _prefix_len(cfg):
    f = cfg.frontend
    return f.seq_len if f is not None and f.kind == "vision_patches" else 0


# the reference's functions, jitted once per shape
_jroute = jax.jit(jffn._route, static_argnums=(2,))
_jmoe_dense = jax.jit(jffn.moe_ffn_dense, static_argnums=(2, 3))
_jmoe_dispatch = jax.jit(jffn.moe_ffn_dispatch, static_argnums=(2, 3, 4))
_jchunkwise = jax.jit(jxl.mlstm_chunkwise)
_jmlstm_block = jax.jit(jxl.mlstm_block, static_argnums=(2,))
_jmlstm_decode = jax.jit(jxl.mlstm_decode_step, static_argnums=(3,))
_jslstm_block = jax.jit(jxl.slstm_block, static_argnums=(2,))
_jslstm_decode = jax.jit(jxl.slstm_decode_step, static_argnums=(3,))
_jattention = jax.jit(jattn.attention, static_argnums=(1, 2),
                      static_argnames=("causal", "rope", "use_kernel"))
_jencode = jax.jit(jlm._encode, static_argnums=(1,),
                   static_argnames=("use_kernel",))
_jembed = jax.jit(jlm._embed_inputs, static_argnums=(1,))
_jprefill = jax.jit(jlm.prefill, static_argnums=(1,),
                    static_argnames=("use_kernel",))
_jdecode = jax.jit(jlm.decode_step, static_argnums=(1,))


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------

def _moe(e, k, f, d=64, seed=0):
    moe, jmoe = MoEConfig(e, k, f), JMoEConfig(e, k, f)
    jp = jffn.init_moe_params(jax.random.PRNGKey(seed), d, jmoe)
    return moe, jmoe, _tree(jp), jp


@pytest.mark.parametrize("e,k", [(4, 2), (32, 8), (16, 4)])
def test_route_matches_reference(e, k):
    """granite's 32 experts top-8, dbrx's 16 top-4, the reduced 4 top-2."""
    moe, jmoe, p, jp = _moe(e, k, 32, seed=e)
    x = _randn(np.random.default_rng(e), (96, 64))
    gates, ids, aux = ffn._route(p, _t(x), moe)
    jgates, jids, jaux = _jroute(jp, jnp.asarray(x), jmoe)
    np.testing.assert_array_equal(_np(ids), np.asarray(jids))
    _close(gates, jgates, MODULE_TOL)
    _close(aux, jaux, MODULE_TOL)


def test_route_breaks_ties_toward_the_lower_expert():
    """Equal probabilities keep expert order, as ``jax.lax.top_k`` does."""
    moe, jmoe, p, jp = _moe(8, 3, 16)
    p = dict(p, router=torch.zeros_like(p["router"]))
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    x = _randn(np.random.default_rng(1), (5, 64))
    ids = ffn._route(p, _t(x), moe)[1]
    np.testing.assert_array_equal(_np(ids), np.tile([0, 1, 2], (5, 1)))
    np.testing.assert_array_equal(
        _np(ids), np.asarray(_jroute(jp, jnp.asarray(x), jmoe)[1]))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_ffn_dense_matches_reference(act):
    moe, jmoe, p, jp = _moe(4, 2, 48)
    x = _randn(np.random.default_rng(2), (2, 11, 64))
    y, aux = ffn.moe_ffn_dense(p, _t(x), moe, act)
    jy, jaux = _jmoe_dense(jp, jnp.asarray(x), jmoe, act)
    _close(y, jy, MODULE_TOL)
    _close(aux, jaux, MODULE_TOL)


def _dropped(ids, e, k, t, capacity_factor):
    capacity = int(max(1, capacity_factor * t * k / e))
    capacity = (capacity + 7) // 8 * 8
    counts = np.bincount(np.asarray(ids).reshape(-1), minlength=e)
    return int(np.maximum(counts - capacity, 0).sum())


@pytest.mark.parametrize("capacity_factor", [0.25, 1.25])
def test_moe_ffn_dispatch_matches_reference(capacity_factor):
    """At 0.25 the buffers overflow and tokens are dropped (the overflow
    bin); at the default 1.25 the routes fit or nearly so."""
    moe, jmoe, p, jp = _moe(4, 2, 48, seed=3)
    x = _randn(np.random.default_rng(3), (2, 40, 64))
    y, aux = ffn.moe_ffn_dispatch(p, _t(x), moe, "silu", capacity_factor)
    jy, jaux = _jmoe_dispatch(jp, jnp.asarray(x), jmoe, "silu",
                              capacity_factor)
    _close(y, jy, MODULE_TOL)
    _close(aux, jaux, MODULE_TOL)
    ids = _jroute(jp, jnp.asarray(x.reshape(80, 64)), jmoe)[1]
    if capacity_factor < 1:
        assert _dropped(ids, 4, 2, 80, capacity_factor) > 0


def test_moe_impl_selects_the_path():
    moe, _, p, _ = _moe(4, 2, 48, seed=4)
    x = _t(_randn(np.random.default_rng(4), (2, 9, 64)))
    y = ffn.moe_ffn(p, x, moe)[0]
    assert torch.equal(y, ffn.moe_ffn_dispatch(p, x, moe)[0])
    with ffn.moe_impl("dense"):
        assert torch.equal(ffn.moe_ffn(p, x, moe)[0],
                           ffn.moe_ffn_dense(p, x, moe)[0])
    assert torch.equal(ffn.moe_ffn(p, x, moe)[0], y)
    with pytest.raises(NotImplementedError, match="item 15"):
        with ffn.moe_impl("hierarchical"):
            pass


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

def _mlstm_inputs(rng, b=2, h=2, s=64, hd=16):
    q = _randn(rng, (b, h, s, hd))
    k = _randn(rng, (b, h, s, hd), hd ** -0.5)
    v = _randn(rng, (b, h, s, hd))
    return q, k, v, _randn(rng, (b, h, s)), _randn(rng, (b, h, s), 1.0, 2.0)


@pytest.mark.parametrize("s", [64, 256])
def test_mlstm_chunkwise_matches_reference(s):
    """One chunk (S=64) and two (S=256, chunk 128), the final (C, n, m)
    included."""
    ins = _mlstm_inputs(np.random.default_rng(s), s=s)
    h, (c, n, m) = xl.mlstm_chunkwise(*map(_t, ins))
    jh, (jc, jn, jm) = _jchunkwise(*map(jnp.asarray, ins))
    for got, want in ((h, jh), (c, jc), (n, jn), (m, jm)):
        _close(got, want, MODULE_TOL)


def test_mlstm_chunkwise_matches_its_step_loop():
    """The port's chunkwise form against its own recurrence, step by step
    (three chunks of 32 across the state carry)."""
    q, k, v, i, f = map(_t, _mlstm_inputs(np.random.default_rng(5), s=96))
    h, (c, n, m) = xl.mlstm_chunkwise(q, k, v, i, f, chunk=32)
    st = (torch.zeros_like(c), torch.zeros_like(n),
          torch.full_like(m, float("-inf")))
    hs = []
    for t in range(q.shape[2]):
        st, h_t = xl._mlstm_step(st, (q[:, :, t], k[:, :, t], v[:, :, t],
                                      i[:, :, t], f[:, :, t]))
        hs.append(h_t)
    _close(h, torch.stack(hs, dim=2), MODULE_TOL)
    # the stabilised state is C * exp(-m): compare it so
    _close(c * torch.exp(-m)[..., None, None],
           st[0] * torch.exp(-st[2])[..., None, None], MODULE_TOL)
    _close(n * torch.exp(-m)[..., None], st[1] * torch.exp(-st[2])[..., None],
           MODULE_TOL)


def _xlstm_layer_params(cfg, jcfg, kind, seed):
    init = {"mlstm": jxl.init_mlstm_params, "slstm": jxl.init_slstm_params}
    jp = init[kind](jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    # give the zero-initialised biases values so the test sees them
    jp = dict(jp, **{k: jnp.asarray(_randn(rng, jp[k].shape, 0.5)) + jp[k]
                     for k in jp if k.startswith("b_") or k == "conv_b"})
    return _tree(jp), jp


def test_mlstm_block_and_decode_step_match_reference():
    cfg, jcfg = _cfgs(XLSTM)
    p, jp = _xlstm_layer_params(cfg, jcfg, "mlstm", 6)
    rng = np.random.default_rng(6)
    x = _randn(rng, (2, 40, cfg.d_model))
    _close(xl.mlstm_block(p, _t(x), cfg),
           _jmlstm_block(jp, jnp.asarray(x), jcfg), MODULE_TOL)
    # decode from a state reached by a prefill of the reference's
    y, st = xl.mlstm_sequence(p, _t(x), cfg)
    w, hh, hd = xl._mlstm_dims(cfg)
    jst = jxl.MLSTMState(C=jnp.asarray(_np(st.C)), n=jnp.asarray(_np(st.n)),
                         m=jnp.asarray(_np(st.m)),
                         conv_tail=jnp.asarray(_np(st.conv_tail)))
    for i in range(3):
        x1 = _randn(rng, (2, 1, cfg.d_model))
        y, st = xl.mlstm_decode_step(p, _t(x1), st, cfg)
        jy, jst = _jmlstm_decode(jp, jnp.asarray(x1), jst, jcfg)
        _close(y, jy, MODULE_TOL)
        for a, b in zip(st, jst):
            _close(a, b, MODULE_TOL)
    # a fresh state: m = -inf meets no -inf in a subtraction
    st0 = xl.init_mlstm_state(cfg, 2)
    y0, st1 = xl.mlstm_decode_step(p, _t(x1), st0, cfg)
    jy0, jst1 = _jmlstm_decode(jp, jnp.asarray(x1),
                               jxl.init_mlstm_state(jcfg, 2), jcfg)
    assert bool(torch.isfinite(y0).all())
    _close(y0, jy0, MODULE_TOL)
    _close(st1.m, jst1.m, MODULE_TOL)


def test_slstm_block_and_decode_step_match_reference():
    cfg, jcfg = _cfgs(XLSTM)
    p, jp = _xlstm_layer_params(cfg, jcfg, "slstm", 7)
    rng = np.random.default_rng(7)
    x = _randn(rng, (2, 30, cfg.d_model))
    _close(xl.slstm_block(p, _t(x), cfg),
           _jslstm_block(jp, jnp.asarray(x), jcfg), MODULE_TOL)
    st = xl.init_slstm_state(cfg, 2)
    jst = jxl.init_slstm_state(jcfg, 2)
    for i in range(4):
        x1 = _randn(rng, (2, 1, cfg.d_model))
        y, st = xl.slstm_decode_step(p, _t(x1), st, cfg)
        jy, jst = _jslstm_decode(jp, jnp.asarray(x1), jst, jcfg)
        _close(y, jy, MODULE_TOL)
        for a, b in zip(st, jst):
            _close(a, b, MODULE_TOL)


# ---------------------------------------------------------------------------
# the encoder-decoder and the vision prefix
# ---------------------------------------------------------------------------

def test_cross_attention_matches_reference():
    """Non-causal, no rope, T != S; and decode's one query at a global
    position against the encoder output, plain as in the reference."""
    cfg, jcfg = _cfgs(SEAMLESS)
    spec, jspec = cfg.layers[0], jcfg.layers[0]
    jp = jattn.init_attention_params(jax.random.PRNGKey(8), jcfg, bias=False)
    p = _tree(jp)
    rng = np.random.default_rng(8)
    x = _randn(rng, (2, 12, cfg.d_model))
    enc = _randn(rng, (2, 16, cfg.d_model))
    got = attn.attention(p, cfg, spec, _t(x), causal=False,
                         kv_input=_t(enc), rope=False)
    want = _jattention(jp, jcfg, jspec, jnp.asarray(x), jnp.arange(12),
                       causal=False, kv_input=jnp.asarray(enc),
                       kv_positions=jnp.arange(16), rope=False,
                       use_kernel=False)
    _close(got, want, MODULE_TOL)
    x1 = _randn(rng, (2, 1, cfg.d_model))
    got = attn.cross_decode_attention(p, cfg, spec, _t(x1), 12, _t(enc))
    want = _jattention(jp, jcfg, jspec, jnp.asarray(x1),
                       jnp.asarray([12], jnp.int32), causal=False,
                       kv_input=jnp.asarray(enc),
                       kv_positions=jnp.arange(16), rope=False,
                       use_kernel=False)
    _close(got, want, MODULE_TOL)


def test_encoder_matches_reference():
    cfg, jcfg = _cfgs(SEAMLESS)
    p, jp = _params(cfg, jcfg)
    fe = _frontend(cfg, 2, np.random.default_rng(9))
    jout, jpos = _jencode(jp, jcfg, jnp.asarray(fe), use_kernel=False)
    _close(lm._encode(p, cfg, _t(fe)), jout, MODULE_TOL)
    np.testing.assert_array_equal(np.asarray(jpos), np.arange(16))


def test_embed_inputs_with_vision_prefix_matches_reference():
    """Patches projected and not scaled, then the tokens scaled by
    sqrt(d)."""
    cfg, jcfg = _cfgs(INTERNVL)
    p, jp = _params(cfg, jcfg)
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    fe = _frontend(cfg, 2, rng)
    got = lm._embed_inputs(p, cfg, _t(tokens), _t(fe))
    assert got.shape == (2, 16 + 7, cfg.d_model)
    _close(got, _jembed(jp, jcfg, jnp.asarray(tokens), jnp.asarray(fe)),
           MODULE_TOL)
    with pytest.raises(ValueError, match="patch"):
        lm._embed_inputs(p, cfg, _t(tokens))


# ---------------------------------------------------------------------------
# whole models: params, prefill + decode with their caches, generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_carry_across_leaf_for_leaf(arch):
    """The MoE's (E, d, f) experts, the xLSTM's per-head (H, hd, hd)
    blocks, the encoder and the frontend projection, leaf for leaf."""
    cfg, jcfg = _cfgs(arch)
    p, jp = _params(cfg, jcfg)
    jl, tl = jax.tree.leaves(jp), leaves(p)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert lm.param_count(p) == jlm.param_count(jp)


def _compare_cache(cache, jcache, tol):
    for st, jst in zip(cache["layers"], jcache["layers"]):
        assert type(st).__name__ == type(jst).__name__
        if isinstance(st, attn.KVCache):
            _close(st.k, jst.k, tol)
            _close(st.v, jst.v, tol)
            np.testing.assert_array_equal(_np(st.slot_pos),
                                          _np(jst.slot_pos))
        else:                      # mLSTM C/n/m/conv_tail, sLSTM c/n/m/h
            assert st._fields == jst._fields
            for a, b in zip(st, jst):
                _close(a, b, tol)
    assert ("enc_out" in cache) == ("enc_out" in jcache)
    if "enc_out" in cache:
        _close(cache["enc_out"], jcache["enc_out"], tol)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prompt 40 and 6 decode steps fed the reference's tokens: logits and
    every layer's cache or state within 1e-4."""
    cfg, jcfg = _cfgs(arch)
    p, jp = _params(cfg, jcfg)
    b, s, steps = 2, 40, 6
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    fe = _frontend(cfg, b, rng)
    p_len = _prefix_len(cfg)
    max_len = p_len + s + steps + 1
    cache = lm.init_cache(cfg, b, max_len)
    jcache = jlm.init_cache(jcfg, b, max_len)
    logits, cache = lm.prefill(p, cfg, _t(prompt), cache,
                               frontend=None if fe is None else _t(fe))
    jlogits, jcache = _jprefill(
        jp, jcfg, jnp.asarray(prompt), jcache,
        frontend=None if fe is None else jnp.asarray(fe), use_kernel=False)
    _close(logits, jlogits, MODEL_TOL)
    _compare_cache(cache, jcache, MODEL_TOL)
    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    for i in range(steps):
        pos = p_len + s + i
        logits, cache = lm.decode_step(p, cfg, _t(tok), pos, cache)
        jlogits, jcache = _jdecode(jp, jcfg, jnp.asarray(tok),
                                   jnp.int32(pos), jcache)
        _close(logits, jlogits, MODEL_TOL)
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    _compare_cache(cache, jcache, MODEL_TOL)


@pytest.mark.parametrize("arch", [INTERNVL, SEAMLESS])
def test_serve_generate_with_frontend_on_cpu(arch):
    """``generate`` counts the vision prefix: the cache holds prefix +
    prompt + tokens, decode starts at position prefix + S, and each id is
    the argmax of the logits before it; the same steps by hand agree."""
    from repro_torch.launch.serve import frontend_input, generate

    cfg = reduced(get_config(arch), n_layers=2)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    gen = torch.Generator().manual_seed(3)
    b, s, steps = 2, 12, 4
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    fe = frontend_input(cfg, b, gen, "cpu")
    assert fe.shape == (b, 16, cfg.d_model)
    out = generate(model, params, prompt, steps, frontend=fe)
    p_len = 16 if arch == INTERNVL else 0
    assert out["prefix_len"] == p_len
    assert out["ids"].shape == (b, steps + 1)
    assert bool(torch.isfinite(out["step_logits"]).all())
    assert torch.equal(out["ids"][:, 1:], out["step_logits"].argmax(-1).T)
    cache = model.init_cache(b, max_len=p_len + s + steps + 1, device="cpu")
    logits, cache = model.prefill(params, prompt, cache, frontend=fe)
    assert torch.equal(logits, out["prefill_logits"])
    for i in range(steps):
        logits, cache = model.decode_step(params, out["ids"][:, i],
                                          p_len + s + i, cache)
        assert torch.equal(logits, out["step_logits"][i])
