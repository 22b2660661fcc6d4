"""The port's LM serving path against the JAX reference, on the CPU.

Inputs are made with numpy from a seed; params are the reference's
``init_params`` carried across by ``repro_torch.weights.params_from_numpy``.
On CPU tensors the port runs its plain paths (``naive_attention``, the
sequential ``rglru_scan_ref``), so these tests hold the model's arithmetic;
the Hopper kernels are held against the same plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_gpu.py``).

Tolerances: 1e-5 for single modules (f32; XLA and PyTorch sum matmuls and
the reference's associative scan in another order), 1e-4 for the logits
of a whole 3-layer model, 5e-3 for decode against forward inside the port
(the reference's own bound, ``tests/test_models.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config, reduced  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

RG = "recurrentgemma-9b"
# the LM configs whose layers the port runs (attention and RG-LRU mixers,
# dense FFN, no encoder or frontend)
SERVED_ARCHS = ("recurrentgemma-9b", "gemma2-2b", "qwen2-7b",
                "command-r-35b", "minitron-8b")
MODULE_TOL = 1e-5
MODEL_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cfgs(arch, n_layers=3):
    return (reduced(get_config(arch), n_layers=n_layers),
            jreduced(jget_config(arch), n_layers=n_layers))


def _params(cfg, jcfg, seed=0):
    """The reference's initial params, as (port tensors, JAX arrays)."""
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jp)
    template = build_model(cfg).init(0, "cpu")
    return params_from_numpy(tree, "cpu", template=template), jp


# the reference's functions, jitted once per shape (eager JAX dispatches
# every primitive on its own and takes several times longer here)
_jrglru_block = jax.jit(jrec.rglru_block, static_argnames=("use_kernel",))
_jrglru_decode = jax.jit(jrec.rglru_decode_step)
_jprefill_attn = jax.jit(jattn.prefill_into_cache, static_argnums=(1, 2),
                         static_argnames=("use_kernel",))
_jattention = jax.jit(jattn.attention, static_argnums=(1, 2),
                      static_argnames=("use_kernel",))
_jdecode_attn = jax.jit(jattn.decode_attention, static_argnums=(1, 2))
_jprefill = jax.jit(jlm.prefill, static_argnums=(1,),
                    static_argnames=("use_kernel",))
_jdecode = jax.jit(jlm.decode_step, static_argnums=(1,))
_jforward = jax.jit(jlm.forward, static_argnums=(1,),
                    static_argnames=("use_kernel",))


@jax.jit
def _jsecond_scan(jp, x):
    """The reference prefill's second scan (``lm.py:332-340``)."""
    u = jnp.einsum("bsd,dw->bsw", x, jp["w_in"])
    a, b = jrec._gates(jp, jrec._causal_conv(u, jp["conv_w"], jp["conv_b"]))
    return u, jrec.rglru_scan(a, b)


def _randn(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_gelu_match_reference():
    rng = np.random.default_rng(0)
    x = _randn(rng, (2, 9, 4, 32), 2.0)
    w = _randn(rng, (32,), 0.1)
    _close(common.rmsnorm(_t(x), _t(w), 1e-6),
           jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6), MODULE_TOL)
    pos = np.arange(9)
    for theta in (10_000.0, 1_000_000.0):
        _close(common.apply_rope(_t(x), _t(pos), theta),
               jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
               MODULE_TOL)
    _close(common.activation("gelu")(_t(x)),
           jcommon.activation("gelu")(jnp.asarray(x)), MODULE_TOL)
    _close(common.softcap(_t(x * 20), 30.0),
           jcommon.softcap(jnp.asarray(x * 20), 30.0), MODULE_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(1)
    jp = jffn.init_mlp_params(jax.random.PRNGKey(1), 64, 96)
    p = {k: _t(v) for k, v in jp.items()}
    x = _randn(rng, (2, 7, 64))
    _close(ffn.mlp(p, _t(x), act), jffn.mlp(jp, jnp.asarray(x), act),
           MODULE_TOL)


# ---------------------------------------------------------------------------
# recurrent block
# ---------------------------------------------------------------------------

def _rglru_params(cfg, jcfg, seed=2):
    jp = jrec.init_rglru_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    # the gates start at zero; give them values so the test sees them
    w = jp["a_gate_w"].shape[0]
    jp = dict(jp, **{k: jnp.asarray(_randn(rng, (w,), 0.5)) for k in
                     ("a_gate_w", "a_gate_b", "x_gate_w", "x_gate_b",
                      "conv_b")})
    return {k: _t(v) for k, v in jp.items()}, jp


def test_rglru_block_and_decode_step_match_reference():
    cfg, jcfg = _cfgs(RG)
    p, jp = _rglru_params(cfg, jcfg)
    rng = np.random.default_rng(3)
    x = _randn(rng, (2, 40, cfg.d_model))
    _close(rec.rglru_block(p, _t(x)),
           _jrglru_block(jp, jnp.asarray(x), use_kernel=False), MODULE_TOL)
    # the params' own init, untouched, as well
    jp0 = jrec.init_rglru_params(jax.random.PRNGKey(5), jcfg)
    _close(rec.rglru_block({k: _t(v) for k, v in jp0.items()}, _t(x)),
           _jrglru_block(jp0, jnp.asarray(x)), MODULE_TOL)

    st = rec.RGLRUState(h=_t(_randn(rng, (2, cfg.lru_width))),
                        conv_tail=_t(_randn(rng, (2, 3, cfg.lru_width))))
    jst = jrec.RGLRUState(h=jnp.asarray(_np(st.h)),
                          conv_tail=jnp.asarray(_np(st.conv_tail)))
    x1 = _randn(rng, (2, 1, cfg.d_model))
    y, st2 = rec.rglru_decode_step(p, _t(x1), st)
    jy, jst2 = _jrglru_decode(jp, jnp.asarray(x1), jst)
    _close(y, jy, MODULE_TOL)
    _close(st2.h, jst2.h, MODULE_TOL)
    _close(st2.conv_tail, jst2.conv_tail, 0.0)


def test_rglru_sequence_state_equals_second_scan():
    """The port takes the prefill state from the block's own scan; the
    reference scans a second time.  Same h, same conv tail."""
    cfg, jcfg = _cfgs(RG)
    p, jp = _rglru_params(cfg, jcfg)
    x = _randn(np.random.default_rng(4), (2, 33, cfg.d_model))
    _, h_last, u = rec.rglru_sequence(p, _t(x))
    ju, jh = _jsecond_scan(jp, jnp.asarray(x))
    _close(h_last, jh[:, -1], MODULE_TOL)
    _close(u[:, -3:], ju[:, -3:], MODULE_TOL)


# ---------------------------------------------------------------------------
# attention: prefill into the cache (both branches) and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,s", [(RG, 40), (RG, 100), ("gemma2-2b", 50),
                                    ("qwen2-7b", 30)])
def test_prefill_into_cache_and_decode_match_reference(arch, s):
    """recurrentgemma's window is 64 in the reduced config: s=40 fills the
    spare-room branch, s=100 the ring branch.  gemma2 adds the soft-cap
    (its layer 1 is global), qwen2 the qkv bias."""
    cfg, jcfg = _cfgs(arch)
    li = next(i for i, sp in enumerate(cfg.layers) if sp.mixer == "attn")
    if arch == "gemma2-2b":
        li = 1
    spec, jspec = cfg.layers[li], jcfg.layers[li]
    jp = jattn.init_attention_params(jax.random.PRNGKey(li), jcfg)
    rng = np.random.default_rng(s)
    if "bq" in jp:
        jp = dict(jp, **{k: jnp.asarray(_randn(rng, jp[k].shape, 0.1))
                         for k in ("bq", "bk", "bv")})
    p = {k: _t(v) for k, v in jp.items()}
    x = _randn(rng, (2, s, cfg.d_model))
    max_len = s + 6
    cache = attn.init_kv_cache(cfg, spec, 2, max_len)
    jcache = jattn.init_kv_cache(jcfg, jspec, 2, max_len)
    y, cache = attn.prefill_into_cache(p, cfg, spec, _t(x), cache)
    jy, jcache = _jprefill_attn(
        jp, jcfg, jspec, jnp.asarray(x), jnp.arange(s), jcache,
        use_kernel=False)
    _close(y, jy, MODULE_TOL)
    _close(cache.k, jcache.k, MODULE_TOL)
    _close(cache.v, jcache.v, MODULE_TOL)
    np.testing.assert_array_equal(_np(cache.slot_pos), _np(jcache.slot_pos))
    # the full-sequence attention is the same function
    _close(attn.attention(p, cfg, spec, _t(x)),
           _jattention(jp, jcfg, jspec, jnp.asarray(x), jnp.arange(s),
                           use_kernel=False), MODULE_TOL)
    for i in range(3):
        x1 = _randn(rng, (2, 1, cfg.d_model))
        y, cache = attn.decode_attention(p, cfg, spec, _t(x1), s + i, cache)
        jy, jcache = _jdecode_attn(jp, jcfg, jspec, jnp.asarray(x1),
                                            jnp.int32(s + i), jcache)
        _close(y, jy, MODULE_TOL)
        np.testing.assert_array_equal(_np(cache.slot_pos),
                                      _np(jcache.slot_pos))
        _close(cache.k, jcache.k, MODULE_TOL)


def test_naive_attention_matches_reference():
    rng = np.random.default_rng(7)
    q = _randn(rng, (2, 24, 2, 3, 16))
    k = _randn(rng, (2, 24, 2, 16))
    v = _randn(rng, (2, 24, 2, 16))
    pos = np.arange(24)
    for window, cap in ((None, None), (8, 20.0)):
        _close(attn.naive_attention(_t(q), _t(k), _t(v), q_pos=_t(pos),
                                    k_pos=_t(pos), window=window, cap=cap),
               jattn.naive_attention(
                   jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                   window=window, cap=cap), MODULE_TOL)


# ---------------------------------------------------------------------------
# the slice: reduced recurrentgemma-9b, prefill + 8 decode steps
# ---------------------------------------------------------------------------

def test_params_carry_across_leaf_for_leaf():
    cfg, jcfg = _cfgs(RG)
    p, jp = _params(cfg, jcfg)
    jl = jax.tree.leaves(jp)
    tl = leaves(p)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert lm.param_count(p) == jlm.param_count(jp)


def test_recurrentgemma_prefill_and_decode_match_reference():
    """Prompt 160 > window 64: the ring branch of every attention layer."""
    cfg, jcfg = _cfgs(RG)
    assert [s.mixer for s in cfg.layers] == ["rglru", "rglru", "attn"]
    p, jp = _params(cfg, jcfg)
    b, s, steps = 2, 160, 8
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    cache = lm.init_cache(cfg, b, s + steps + 1)
    jcache = jlm.init_cache(jcfg, b, s + steps + 1)
    logits, cache = lm.prefill(p, cfg, _t(prompt), cache)
    jlogits, jcache = _jprefill(jp, jcfg, jnp.asarray(prompt), jcache,
                                  use_kernel=False)
    _close(logits, jlogits, MODEL_TOL)
    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    for i in range(steps):
        logits, cache = lm.decode_step(p, cfg, _t(tok), s + i, cache)
        jlogits, jcache = _jdecode(jp, jcfg, jnp.asarray(tok),
                                          jnp.int32(s + i), jcache)
        _close(logits, jlogits, MODEL_TOL)
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    for st, jst in zip(cache["layers"], jcache["layers"]):
        if isinstance(st, attn.KVCache):
            _close(st.k, jst.k, MODEL_TOL)
            _close(st.v, jst.v, MODEL_TOL)
            np.testing.assert_array_equal(_np(st.slot_pos),
                                          _np(jst.slot_pos))
        else:
            _close(st.h, jst.h, MODEL_TOL)
            _close(st.conv_tail, jst.conv_tail, MODEL_TOL)


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_forward_matches_reference(arch):
    cfg, jcfg = _cfgs(arch, n_layers=2)
    p, jp = _params(cfg, jcfg)
    tokens = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    _close(lm.forward(p, cfg, _t(tokens)),
           _jforward(jp, jcfg, jnp.asarray(tokens), use_kernel=False),
           MODEL_TOL)


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_decode_matches_forward(arch):
    """Mirror of ``tests/test_models.py::test_arch_decode_matches_forward``
    on the port alone, with its own seeded init."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = model.init(0, "cpu")
    b, s = 2, 16
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)))
    full = model.forward(params, tokens)
    cache = model.init_cache(b, max_len=s + 4, device="cpu")
    _, cache = model.prefill(params, tokens[:, :s - 1], cache)
    dec, _ = model.decode_step(params, tokens[:, s - 1], s - 1, cache)
    err = float((dec - full[:, -1]).abs().max())
    assert err < 5e-3, f"{arch}: decode/forward mismatch {err}"


@pytest.mark.parametrize("arch", sorted(set(ARCH_NAMES) - set(SERVED_ARCHS)))
def test_unported_architectures_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(get_config(arch))


def test_serve_generate_on_cpu():
    from repro_torch.launch.serve import cut_layers, generate

    cfg = cut_layers(reduced(get_config(RG), n_layers=4), 3)
    assert cfg.n_layers == 3 and cfg.d_model == 128
    model = build_model(cfg)
    params = model.init(0, "cpu")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 70)))
    out = generate(model, params, prompt, 4)
    assert out["ids"].shape == (2, 5)
    assert out["step_logits"].shape == (4, 2, cfg.vocab_size)
    assert bool(torch.isfinite(out["step_logits"]).all())
    # greedy: each id is the argmax of the logits before it
    assert torch.equal(out["ids"][:, 1:],
                       out["step_logits"].argmax(-1).T)
