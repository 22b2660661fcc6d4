"""The port's LM training path against the JAX reference, on the CPU.

Inputs are made with numpy from a seed; params are the reference's
``init_params`` carried across by ``repro_torch.weights.params_from_numpy``
(the layer-stacked tree too).  On CPU tensors the port runs its plain
versions, so these tests hold the gradient's arithmetic: the plain
attention backward ``ref.flash_attention_bwd_ref`` against ``jax.vjp`` of
the reference's blocked custom VJP, the plain reverse scan against autodiff
of the reference's associative scan, the chunked CE, every config's loss
and gradient, the stacked layout, and ``make_fl_train_step`` over two
rounds against the reference's step on a 1 x 1 CPU mesh.  The Hopper
backward kernels are held against the same plain versions on the card
(``chip_smoke.py`` phase 2c, ``tests/test_torch_gpu.py``).

Tolerances (f32; XLA and PyTorch sum in other orders): 1e-5 for a single
module (MODULE_TOL), 1e-4 for a whole model's loss and for its params and
momentum after a step (MODEL_TOL).  A gradient leaf is compared as its
max-abs difference over its max-abs (``_rel``).  A leaf whose gradient is
zero by the maths holds only rounding noise on both sides (the sLSTM's
input-gate bias: a shift of every i_t scales c and n alike, so h = c / n
does not move; both packages give ~3e-9 of the tree's largest gradient,
where the next smallest leaf is at 1e-3): in a tree, a leaf whose
reference max-abs is below 1e-6 of the tree's largest counts as zero, and
the port's must be below it too (``_close_trees``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs.shapes import InputShape as JShape  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.models import stacked as jstacked  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config, reduced  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model, lm, stacked  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

MODULE_TOL = 1e-5
MODEL_TOL = 1e-4
GEMMA, RG = "gemma2-2b", "recurrentgemma-9b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _randn(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(got, want) -> float:
    """max |got - want| over max |want| (0 where equal)."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    den = np.abs(w).max() if w.size else 0.0
    num = np.abs(g - w).max() if w.size else 0.0
    return 0.0 if num == 0.0 else num / max(den, 1e-30)


def _absmax(x) -> float:
    a = _np(x)
    return float(np.abs(a).max()) if a.size else 0.0


def _close_trees(got, want, tol, what):
    gl, wl = leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), (what, len(gl), len(wl))
    zero = 1e-6 * max(_absmax(w) for w in wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        if _absmax(w) <= zero:          # zero by the maths: noise both sides
            assert _absmax(g) <= zero, f"{what}: leaf {i} is not ~0"
        else:
            err = _rel(g, w)
            assert err <= tol, f"{what}: leaf {i} off by {err}"


def _cfgs(arch, n_layers):
    return (reduced(get_config(arch), n_layers=n_layers),
            jreduced(jget_config(arch), n_layers=n_layers))


def _params(cfg, jcfg, seed=0, stack=False):
    """The reference's initial params, as (port tensors, JAX arrays)."""
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    template = build_model(cfg).init(0, "cpu")
    if stack:
        jp = jstacked.stack_params(jp, jcfg)
        template = stacked.stack_params(template, cfg)
    tree = jax.tree.map(np.asarray, jp)
    return params_from_numpy(tree, "cpu", template=template), jp


def _batch(cfg, b, s, rng, ignore=True):
    """A numpy batch: tokens, labels (some -1 when ``ignore``), weights
    and the config's stub frontend."""
    lo = -1 if ignore else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(lo, cfg.vocab_size, (b, s)).astype(np.int32),
           "weight": rng.uniform(0.5, 4.0, b).astype(np.float32)}
    if cfg.frontend is not None:
        out["frontend"] = _randn(rng, (b, cfg.frontend.seq_len,
                                       cfg.frontend.feature_dim))
    return out


def _seq(cfg):
    return 128 if cfg.family == "ssm" else 24      # xLSTM: one mLSTM chunk


# XLA's CPU back end at its lowest optimisation: the reference's programs
# compile in ~60% of the time and compute the same f32 function
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def _compiled(jitted, *args):
    """``jitted`` compiled for ``args`` with ``FAST_XLA``."""
    return jitted.lower(*args).compile(compiler_options=FAST_XLA)


def _grad_leaves(params):
    for x in leaves(params):
        x.requires_grad_(True)
        x.grad = None


# ---------------------------------------------------------------------------
# the plain backward passes
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (B, Kh, G, S, T, D, causal, window, cap)
    "causal_gqa": (2, 2, 2, 24, 24, 16, True, None, None),
    "window": (1, 2, 1, 24, 24, 8, True, 7, None),
    "cap_mqa": (1, 1, 4, 16, 16, 16, True, None, 5.0),
    "window_cap_gqa": (2, 1, 3, 24, 24, 8, True, 5, 2.0),
    "noncausal_s_ne_t": (2, 2, 2, 12, 20, 16, False, None, None),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_bwd_ref_matches_reference(case):
    """(dq, dk, dv) from the saved (out, lse) against ``jax.vjp`` of the
    reference's blocked attention (its custom VJP, small q/kv chunks) and
    against ``torch.autograd`` of ``flash_attention_ref``; the autograd
    Function on CPU tensors gives the same."""
    b, kh, g, s, t, d, causal, window, cap = ATTN_CASES[case]
    rng = np.random.default_rng(sorted(ATTN_CASES).index(case))
    q = _randn(rng, (b, s, kh, g, d))
    k = _randn(rng, (b, t, kh, d))
    v = _randn(rng, (b, t, kh, d))
    do = _randn(rng, (b, s, kh * g, d))
    q_pos = jnp.arange(s) + (t - s)
    f = lambda q_, k_, v_: jattn.blocked_attention(  # noqa: E731
        q_, k_, v_, q_pos=q_pos, k_pos=jnp.arange(t), causal=causal,
        window=window, cap=cap, q_chunk=4, kv_chunk=4)

    def out_and_grads(q_, k_, v_, do_):
        out_, vjp = jax.vjp(f, q_, k_, v_)
        return out_, vjp(do_)

    args = [jnp.asarray(a) for a in (q, k, v, do)]
    jout, (jdq, jdk, jdv) = _compiled(jax.jit(out_and_grads), *args)(*args)
    # the port's layout: q (B, H, S, D), k/v (B, Kh, T, D)
    tq = _t(q).reshape(b, s, kh * g, d).transpose(1, 2)
    tk, tv = _t(k).transpose(1, 2), _t(v).transpose(1, 2)
    tdo = _t(do).transpose(1, 2)
    kw = dict(causal=causal, window=window, cap=cap)
    out, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    np.testing.assert_allclose(_np(out.transpose(1, 2)), np.asarray(jout),
                               rtol=MODULE_TOL, atol=MODULE_TOL)
    dq, dk, dv = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, **kw)
    for got, want in ((dq.transpose(1, 2).reshape(b, s, kh, g, d), jdq),
                      (dk.transpose(1, 2), jdk), (dv.transpose(1, 2), jdv)):
        assert _rel(got, want) <= MODULE_TOL
    leaves_ = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    auto = torch.autograd.grad(ref.flash_attention_ref(*leaves_, **kw),
                               leaves_, tdo)
    fn = torch.autograd.grad(ops.flash_attention(*leaves_, **kw), leaves_,
                             tdo)
    for got, a, c in zip((dq, dk, dv), auto, fn):
        assert _rel(got, a) <= MODULE_TOL
        assert torch.equal(got, c)


def test_flash_attention_lse_matches_reference_forward():
    """The optional log-sum-exp equals the reference's ``_flash_forward``
    lse, m + log(max(l, 1e-30)); asking for it leaves the output as it
    was."""
    b, kh, g, s, d = 2, 2, 2, 20, 16
    rng = np.random.default_rng(9)
    q = _randn(rng, (b, s, kh, g, d))
    k = _randn(rng, (b, s, kh, d))
    v = _randn(rng, (b, s, kh, d))
    pos = jnp.arange(s)
    _, jlse = jattn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=pos,
        k_pos=pos, causal=True, window=6, cap=3.0, q_chunk=4, kv_chunk=4)
    tq = _t(q).reshape(b, s, kh * g, d).transpose(1, 2)
    tk, tv = _t(k).transpose(1, 2), _t(v).transpose(1, 2)
    kw = dict(causal=True, window=6, cap=3.0)
    out, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    assert torch.equal(out, ref.flash_attention_ref(tq, tk, tv, **kw))
    np.testing.assert_allclose(_np(lse), np.asarray(jlse).reshape(b, -1, s),
                               rtol=MODULE_TOL, atol=MODULE_TOL)


def test_rglru_scan_bwd_ref_matches_reference():
    """The reverse scan against ``jax.vjp`` of the reference's associative
    scan and against autograd of the sequential ``rglru_scan_ref``; the
    autograd Function on CPU tensors is the plain reverse scan's bits."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0.5, 0.999, (2, 37, 19)).astype(np.float32)
    x = _randn(rng, (2, 37, 19))
    dh = _randn(rng, (2, 37, 19))
    args = [jnp.asarray(z) for z in (a, x, dh)]
    jda, jdb = _compiled(jax.jit(
        lambda a_, x_, dh_: jax.vjp(jrec.rglru_scan, a_, x_)[1](dh_)),
        *args)(*args)
    ta, tx, tdh = _t(a), _t(x), _t(dh)
    h = ref.rglru_scan_ref(ta, tx)
    da, db = ref.rglru_scan_bwd_ref(ta, h, tdh)
    assert _rel(da, jda) <= MODULE_TOL and _rel(db, jdb) <= MODULE_TOL
    la, lx = ta.clone().requires_grad_(True), tx.clone().requires_grad_(True)
    auto = torch.autograd.grad(ref.rglru_scan_ref(la, lx), (la, lx), tdh)
    assert _rel(da, auto[0]) <= MODULE_TOL and _rel(db, auto[1]) <= MODULE_TOL
    fn = torch.autograd.grad(ops.rglru_scan(la, lx), (la, lx), tdh)
    assert torch.equal(fn[0], da) and torch.equal(fn[1], db)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def test_chunked_ce_matches_reference():
    """Five chunks of 10 tokens over 48 (two padding tokens), the final
    soft-cap, ignored labels and per-sequence weights: ce, acc and the
    gradients of x, the final norm and the (tied) embedding."""
    cfg, jcfg = _cfgs(GEMMA, 2)
    assert cfg.final_softcap is not None and cfg.tie_embeddings
    p, jp = _params(cfg, jcfg)
    rng = np.random.default_rng(5)
    x = _randn(rng, (2, 24, cfg.d_model))
    labels = rng.integers(-1, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels[0, :3] = -1
    w = np.asarray([1.0, 3.0], np.float32)
    tok_w = (labels >= 0).astype(np.float32) * w[:, None]

    def jf(jp_, x_):
        ce, acc = jlm.chunked_ce(jp_, jcfg, x_, jnp.asarray(labels),
                                 jnp.asarray(tok_w), chunk_tokens=10)
        return ce, acc

    jx = jnp.asarray(x)
    (jce, jacc), jgrads = _compiled(jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)), jp, jx)(jp, jx)
    small = {"embed": p["embed"], "final_norm": p["final_norm"]}
    tx = _t(x).requires_grad_(True)
    _grad_leaves(small)
    ce, acc = lm.chunked_ce(small, cfg, tx, _t(labels), _t(tok_w),
                            chunk_tokens=10)
    ce.backward()
    assert abs(ce.item() - float(jce)) <= MODULE_TOL * abs(float(jce))
    assert float(acc) == pytest.approx(float(jacc), abs=1e-7)
    assert _rel(tx.grad, jgrads[1]) <= MODULE_TOL
    for k in small:
        assert _rel(small[k].grad, jgrads[0][k]) <= MODULE_TOL, k


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_fn_matches_reference(arch):
    """``lm.loss_fn`` (under remat) against ``jax.value_and_grad`` of the
    reference's (``use_kernel=False``): loss, ce, aux and acc, and every
    gradient leaf within MODEL_TOL of its max-abs.  The MoE runs its
    default capacity dispatch on both sides."""
    cfg, jcfg = _cfgs(arch, 2)
    p, jp = _params(cfg, jcfg)
    rng = np.random.default_rng(ARCH_NAMES.index(arch))
    nb = _batch(cfg, 2, _seq(cfg), rng)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    jf = jax.value_and_grad(
        lambda jp_, b_: jlm.loss_fn(jp_, jcfg, b_, use_kernel=False),
        has_aux=True)
    (jloss, jmet), jgrads = _compiled(jax.jit(jf), jp, jb)(jp, jb)
    _grad_leaves(p)
    loss, met = lm.loss_fn(p, cfg, {k: _t(v) for k, v in nb.items()},
                           remat=True)
    loss.backward()
    assert _rel(loss.detach(), jloss) <= MODEL_TOL
    for k in ("ce", "aux", "acc"):
        assert abs(met[k].item() - float(jmet[k])) <= \
            MODEL_TOL * max(abs(float(jmet[k])), 1.0), k
    _close_trees(tree_map(lambda x: x.grad, p), jgrads, MODEL_TOL, arch)


# ---------------------------------------------------------------------------
# stacked layout
# ---------------------------------------------------------------------------

# recurrentgemma's stacked loss is held against the reference inside its
# train step (test_fl_train_step_matches_reference)
STACKED = {GEMMA: 4, "seamless-m4t-medium": 4}


@pytest.mark.parametrize("arch", sorted(STACKED))
def test_stacked_round_trip_and_loss(arch):
    """Two full cycles: the port's stacked tree is the reference's leaf
    for leaf and unstacks to the original; the stacked loss (remat) equals
    the unrolled one, and both packages' stacked losses and gradients
    agree."""
    cfg, jcfg = _cfgs(arch, STACKED[arch])
    p, jp = _params(cfg, jcfg)
    cycle, n_full, _ = stacked.find_cycle(cfg)
    assert (cycle, n_full) == jstacked.find_cycle(jcfg)[:2] and n_full >= 2
    ps = stacked.stack_params(p, cfg)
    jps = jstacked.stack_params(jp, jcfg)
    js = jax.tree.leaves(jps)
    assert len(leaves(ps)) == len(js)
    assert all(np.array_equal(_np(a), np.asarray(b))
               for a, b in zip(leaves(ps), js))
    back = stacked.unstack_params(ps, cfg)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(p)))
    rng = np.random.default_rng(21)
    nb = _batch(cfg, 2, 16, rng)
    tb = {k: _t(v) for k, v in nb.items()}
    unrolled, _ = lm.loss_fn(p, cfg, tb)
    _grad_leaves(ps)
    loss, met = stacked.loss_fn(ps, cfg, tb, remat=True)
    assert _rel(loss.detach(), unrolled.detach()) <= 1e-6
    loss.backward()
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    jf = _compiled(jax.jit(jax.value_and_grad(
        lambda a, b: jstacked.loss_fn(a, jcfg, b, use_kernel=False),
        has_aux=True)), jps, jb)
    (jloss, _), jgrads = jf(jps, jb)
    assert _rel(loss.detach(), jloss) <= MODEL_TOL
    _close_trees(tree_map(lambda x: x.grad, ps), jgrads, MODEL_TOL, arch)


def test_stacked_decode_equals_unrolled():
    """Prefill and three decode steps over stacked params and a stacked
    cache give the unrolled path's logits exactly (recurrentgemma: two
    rg-lru/rg-lru/attn cycles)."""
    cfg = reduced(get_config(RG), n_layers=6)
    model = build_model(cfg)
    p = model.init(0, "cpu")
    ps = stacked.stack_params(p, cfg)
    rng = np.random.default_rng(2)
    tokens = _t(rng.integers(0, cfg.vocab_size, (2, 20)))
    cache = model.init_cache(2, max_len=24, device="cpu")
    cache_st = stacked.init_cache_stacked(cfg, 2, 24, device="cpu")
    lg, cache = model.prefill(p, tokens, cache)
    lg_st, cache_st = stacked.prefill(ps, cfg, tokens, cache_st)
    assert torch.equal(lg, lg_st)
    for i in range(3):
        tok = torch.argmax(lg, dim=-1)
        lg, cache = model.decode_step(p, tok, 20 + i, cache)
        lg_st, cache_st = stacked.decode_step(ps, cfg, tok, 20 + i, cache_st)
        assert torch.equal(lg, lg_st)
    assert len(cache_st["stacked"]) == 3 and cache_st["rest"] == []


# ---------------------------------------------------------------------------
# the FL train step
# ---------------------------------------------------------------------------

_JMESH = None


def _jmesh():
    global _JMESH
    if _JMESH is None:
        _JMESH = jax.sharding.Mesh(
            np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    return _JMESH


STEP_CASES = {
    # name: (arch, layers, step kwargs); the options share one case, so
    # the reference's step compiles three times, not five
    "gemma2_plain": (GEMMA, 4, {}),
    "gemma2_passes2_micro2_int8": (GEMMA, 4, {"local_passes": 2,
                                              "microbatches": 2,
                                              "quantize_comm": True}),
    "recurrentgemma_plain": (RG, 6, {}),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_fl_train_step_matches_reference(case):
    """Two rounds of ``make_fl_train_step`` from the reference's stacked
    init params against the reference's step (f32, 1 x 1 CPU mesh):
    params, momentum and loss after each round within MODEL_TOL."""
    arch, n_layers, kw = STEP_CASES[case]
    cfg, jcfg = _cfgs(arch, n_layers)
    b, s = 4, 32
    jfn, _ = jsteps.make_fl_train_step(
        jcfg, _jmesh(), JShape("t", seq_len=s, global_batch=b, kind="train"),
        dtype=jnp.float32, lr=1e-2, **kw)
    fn, (p_struct, m_struct, b_struct) = steps.make_fl_train_step(
        cfg, InputShape("t", seq_len=s, global_batch=b, kind="train"),
        lr=1e-2, dtype=torch.float32, **kw)
    p, jp = _params(cfg, jcfg, stack=True)
    assert [x.shape for x in leaves(p)] == [x.shape for x in leaves(p_struct)]
    assert all(x.device.type == "meta" for x in leaves(m_struct))
    m = tree_map(torch.zeros_like, p)
    jm = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), jp)
    rng = np.random.default_rng(31)
    batches = [_batch(cfg, b, s, rng, ignore=False) for _ in range(2)]
    with _jmesh():
        jfn = _compiled(jfn, jp, jm, {k: jnp.asarray(v)
                                      for k, v in batches[0].items()})
    for r, nb in enumerate(batches):
        with _jmesh():
            jp, jm, jloss, _ = jfn(jp, jm, {k: jnp.asarray(v)
                                            for k, v in nb.items()})
        p, m, loss, met = fn(p, m, {k: _t(v) for k, v in nb.items()})
        assert _rel(loss, jloss) <= MODEL_TOL, (case, r)
        _close_trees(p, jp, MODEL_TOL, f"{case} params round {r}")
        _close_trees(m, jm, MODEL_TOL, f"{case} momentum round {r}")
    assert not any(x.requires_grad for x in leaves(p))


def test_train_step_contract():
    """The structs are on the meta device with the full config's shapes
    (nothing allocated), in bf16 by default as the reference's, f32 when
    asked; the hierarchical MoE raises; the prefill and decode shapes
    dispatch to their steps; the STE is the reference's bits."""
    from repro_torch.configs.shapes import get_shape

    cfg = get_config(GEMMA)
    _, (p_struct, m_struct, b_struct) = steps.make_fl_train_step(
        cfg, get_shape("train_4k"))
    assert sum(x.numel() for x in leaves(p_struct)) == 2_614_222_080
    assert all(x.device.type == "meta" for x in leaves(p_struct))
    assert {x.dtype for x in leaves(p_struct)} == {torch.bfloat16}
    assert {x.dtype for x in leaves(m_struct)} == {torch.float32}
    assert b_struct["tokens"].shape == (256, 4096)
    _, (p32, _, _) = steps.make_fl_train_step(cfg, get_shape("train_4k"),
                                              dtype=torch.float32)
    assert {x.dtype for x in leaves(p32)} == {torch.float32}
    with pytest.raises(NotImplementedError, match="item 15"):
        steps.make_fl_train_step(cfg, get_shape("train_4k"),
                                 moe_mode="hierarchical")
    fn, (pp, tok) = steps.step_for_shape(cfg, get_shape("prefill_32k"))
    assert callable(fn) and tok.shape == (32, 32768)
    assert {x.dtype for x in leaves(pp)} == {torch.bfloat16}
    fn, structs = steps.step_for_shape(cfg, get_shape("decode_32k"))
    assert callable(fn) and structs[2].shape == (128,)
    fn, _ = steps.step_for_shape(reduced(cfg), get_shape("train_4k"))
    assert callable(fn)
    rng = np.random.default_rng(6)
    w, r = _randn(rng, (16, 257), 2.0), _randn(rng, (16, 257))
    want, jvjp = jax.vjp(jax.jit(jsteps._quantize_dequantize_ste),
                         jnp.asarray(w))
    tw = _t(w).requires_grad_(True)
    got = steps._quantize_dequantize_ste(tw)
    assert np.array_equal(_np(got), np.asarray(want))
    got.backward(_t(r))
    assert _rel(tw.grad, jvjp(jnp.asarray(r))[0]) <= MODULE_TOL


def test_distributed_fl_cli_on_cpu(capsys):
    from repro_torch.launch import distributed_fl

    distributed_fl.main(["--arch", RG, "--rounds", "2", "--device", "cpu",
                         "--batch", "4", "--seq-len", "32"])
    out = capsys.readouterr().out
    assert "reduced, 4 layers" in out and "device=cpu" in out
    losses = [float(ln.split("loss=")[1].split()[0])
              for ln in out.splitlines() if "weighted FL loss=" in ln]
    assert len(losses) == 2 and all(np.isfinite(losses))
