"""The port at bf16 against the JAX reference at bf16, on the CPU.

Inputs are made with numpy from a seed and rounded to bf16 once, so both
packages start from the same bf16 values; params are the reference's
``init_params(dtype=bfloat16)`` carried across by
``repro_torch.weights.params_from_numpy``.  On CPU tensors the port runs its
plain versions; the Hopper bf16 kernels are held against the same plain
versions on the card (``chip_smoke.py`` phase 2e, ``tests/test_torch_gpu.py``).

Tolerances, each against the reference's max-abs of what is compared:

* the plain bf16 attention (f32 arithmetic, one rounding to bf16) against
  the Pallas kernel in interpret mode and ``repro.kernels.ref``: 8e-3,
  about one bf16 ulp at the max (the reference's own test allows 3e-2);
* its gradient against ``_flash_backward`` at bf16: 2e-2 a gradient;
* the bf16 scan: bitwise (f32 state, one rounding a step at the store);
* the training step over two rounds: loss within 1e-2 relative; the
  update bitwise the reference's ``p - lr * m.astype(p.dtype)`` on the
  port's own p and m; momentum held through each package's f32 step from
  the same state, the witness of its own bf16 rounding: bf16 arithmetic
  rounds at other places in XLA and PyTorch, so each package's bf16
  momentum lies 1-5% of a leaf's max-abs from its f32 step's and the two
  differ by up to 6%.  Each leaf's distance from f32 may exceed the
  reference's own by 3e-2, and the mean over leaves of the RMS distance
  may be 1.25 times the reference's; params within 2 bf16 ulps element
  by element beyond what the momentum's difference moves them by;
* the bf16 attention limits on the card: the kernels' arithmetic,
  emulated, passes them and planted faults do not;
* prefill and serve logits: 3e-2; ``quantize_params`` and
  ``dequantize_params``: bitwise.
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
from repro.kernels.flash_attention import flash_attention as jpallas_attn  # noqa: E402,E501
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jpallas_scan  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import stacked as jstacked  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.kernels import ops, parity, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model, stacked  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

BF = jnp.bfloat16
ATTN_TOL = 8e-3
GRAD_TOL = 2e-2
LOSS_TOL = 1e-2
MOMENTUM_TOL = 3e-2
RMS_RATIO = 1.25
LOGIT_TOL = 3e-2
GEMMA, RG = "gemma2-2b", "recurrentgemma-9b"
# XLA's CPU back end at its lowest optimisation (as tests/test_torch_train.py)
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def _bf(rng, shape, scale=1.0):
    """numpy f32 values that are exactly bf16 (rounded once)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(x, BF).astype(jnp.float32))


def _tb(a):
    """numpy (f32 holding bf16 values, or bf16) -> a bf16 tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(torch.bfloat16)


def _jb(a):
    return jnp.asarray(np.asarray(a, np.float32), BF)


def _f(x):
    """A tensor or array as f64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _rel(got, want) -> float:
    g, w = _f(got), _f(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    num = np.abs(g - w).max() if w.size else 0.0
    return 0.0 if num == 0.0 else num / max(np.abs(w).max(), 1e-30)


_JMESH = None


def _jmesh():
    global _JMESH
    if _JMESH is None:
        _JMESH = jax.sharding.Mesh(
            np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    return _JMESH


def _compiled(jitted, *args):
    return jitted.lower(*args).compile(compiler_options=FAST_XLA)


# ---------------------------------------------------------------------------
# the plain versions at bf16
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (B, H, Kh, S, T, D, causal, window, cap)
    "causal_gqa": (2, 4, 2, 64, 64, 32, True, None, None),
    "window_mqa": (1, 4, 1, 64, 64, 64, True, 16, None),
    "cap_gqa": (1, 4, 2, 32, 32, 128, True, None, 5.0),
    "window_cap": (2, 2, 1, 48, 48, 32, True, 8, 2.0),
    "noncausal_s_ne_t": (2, 2, 2, 24, 40, 32, False, None, None),
}


def _attn_inputs(case):
    b, h, kh, s, t, d = ATTN_CASES[case][:6]
    rng = np.random.default_rng(sorted(ATTN_CASES).index(case))
    return (_bf(rng, (b, h, s, d)), _bf(rng, (b, kh, t, d)),
            _bf(rng, (b, kh, t, d)), _bf(rng, (b, h, s, d)))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_ref_bf16_matches_reference(case):
    """bf16 in, bf16 out, lse in f32: the port's plain attention against
    ``repro.kernels.ref.flash_attention_ref`` at bf16 and (S == T) the
    Pallas kernel in interpret mode; its f32 results keep their bits."""
    q, k, v, _ = _attn_inputs(case)
    causal, window, cap = ATTN_CASES[case][6:]
    kw = dict(causal=causal, window=window, cap=cap)
    out, lse = ref.flash_attention_ref(_tb(q), _tb(k), _tb(v),
                                       return_lse=True, **kw)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want = jref.flash_attention_ref(_jb(q), _jb(k), _jb(v), **kw)
    assert want.dtype == BF
    assert _rel(out, want) <= ATTN_TOL
    if q.shape[2] == k.shape[2]:
        pallas = jpallas_attn(_jb(q), _jb(k), _jb(v), interpret=True, **kw)
        assert pallas.dtype == BF
        assert _rel(out, pallas) <= ATTN_TOL
    # the same values in f32: the f32 path is untouched by the bf16 one
    t32 = [torch.from_numpy(np.array(a)) for a in (q, k, v)]
    o32 = ref.flash_attention_ref(*t32, **kw)
    assert o32.dtype == torch.float32
    assert torch.equal(out, o32.to(torch.bfloat16))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_bwd_ref_bf16_matches_reference(case):
    """(dq, dk, dv) in bf16 from bf16 (q, k, v, out, dout) and f32 lse
    against the reference's ``_flash_backward`` at bf16, from the same
    forward (the reference's bf16 out and lse); the autograd Function on
    CPU tensors gives the plain version's gradients in bf16."""
    q, k, v, do = _attn_inputs(case)
    b, h, kh, s, t, d = ATTN_CASES[case][:6]
    causal, window, cap = ATTN_CASES[case][6:]
    g = h // kh
    # the reference's layout: q (B, S, K, G, D), k/v (B, T, K, D)
    jq = _jb(q).transpose(0, 2, 1, 3).reshape(b, s, kh, g, d)
    jk, jv = _jb(k).transpose(0, 2, 1, 3), _jb(v).transpose(0, 2, 1, 3)
    jdo = _jb(do).transpose(0, 2, 1, 3)
    q_pos, k_pos = jnp.arange(s) + (t - s), jnp.arange(t)
    opts = dict(q_pos=q_pos, k_pos=k_pos, causal=causal, window=window,
                cap=cap, q_chunk=8, kv_chunk=8)
    jout, jlse = jattn._flash_forward(jq, jk, jv, **opts)
    jdq, jdk, jdv = jattn._flash_backward(jq, jk, jv, jout, jlse, jdo,
                                          **opts)
    assert jdq.dtype == BF
    out = _tb(np.asarray(jout.astype(jnp.float32))).transpose(1, 2)
    lse = torch.from_numpy(np.asarray(jlse)).reshape(b, h, s)
    kw = dict(causal=causal, window=window, cap=cap)
    dq, dk, dv = ref.flash_attention_bwd_ref(_tb(q), _tb(k), _tb(v), out,
                                             lse, _tb(do), **kw)
    assert {x.dtype for x in (dq, dk, dv)} == {torch.bfloat16}
    for got, want in ((dq.transpose(1, 2).reshape(b, s, kh, g, d), jdq),
                      (dk.transpose(1, 2), jdk), (dv.transpose(1, 2), jdv)):
        assert _rel(got, want) <= GRAD_TOL
    xs = [_tb(a).requires_grad_(True) for a in (q, k, v)]
    y = ops.flash_attention(*xs, **kw)
    assert y.dtype == torch.bfloat16
    grads = torch.autograd.grad(y, xs, _tb(do))
    o2, l2 = ref.flash_attention_ref(*[x.detach() for x in xs],
                                     return_lse=True, **kw)
    plain = ref.flash_attention_bwd_ref(*[x.detach() for x in xs], o2, l2,
                                        _tb(do), **kw)
    for a, w in zip(grads, plain):
        assert a.dtype == torch.bfloat16 and torch.equal(a, w)


@pytest.mark.parametrize("shape", [(2, 256, 64), (1, 128, 520), (2, 1, 64)])
def test_rglru_scan_ref_bf16_bitwise_against_pallas(shape):
    """bf16 a and b: the plain scan (f32 state, each h_t rounded to bf16)
    equals the Pallas kernel in interpret mode bit for bit.  The Pallas
    call is compiled at XLA's lowest CPU optimisation (``FAST_XLA``), which
    computes its step ``a * h + b`` as written, a multiply then an add; at
    the default level XLA contracts the two into one fused multiply-add,
    which the kernel's source does not ask for, and 3e-5 of the values
    then move by one bf16 ulp."""
    rng = np.random.default_rng(sum(shape))
    a = np.asarray(jnp.asarray(rng.uniform(0.8, 0.999, shape), BF)
                   .astype(jnp.float32))
    x = _bf(rng, shape, 0.3)
    scan = jax.jit(lambda a_, x_: jpallas_scan(a_, x_, block_w=shape[2],
                                               interpret=True))
    want = _compiled(scan, _jb(a), _jb(x))(_jb(a), _jb(x))
    got = ref.rglru_scan_ref(_tb(a), _tb(x))
    assert got.dtype == torch.bfloat16 and want.dtype == BF
    assert np.array_equal(_f(got), _f(want))
    got2 = ops.rglru_scan(_tb(a), _tb(x))
    assert torch.equal(got, got2)


# the card's bf16 attention limits (chip_smoke.py phase 2e and the card
# tests): name: (B, H, Kh, S, T, D, causal, window, cap)
LIMIT_CASES = {
    "causal_mqa": (1, 4, 1, 1024, 1024, 128, True, None, None),
    "cap_gqa": (1, 4, 2, 1024, 1024, 128, True, None, 50.0),
    "window": (1, 2, 1, 1024, 1024, 256, True, 256, None),
    # seamless-m4t's cross-attention, reduced: 16/16, S=512 over T=1024
    "noncausal_cross": (1, 4, 4, 256, 512, 64, False, None, None),
}


def _kernel_like(q, k, v, do, causal, window, cap):
    """The bf16 kernels' arithmetic, emulated: the forward's P V as two
    bf16 passes (P = hi + lo) summed in f32, one rounding at the store;
    the backward with P and dS each rounded once to bf16 before their
    products, f32 sums (their tensor-core truncation over a walk is
    emulated in tests/test_torch_attn_bwd.py)."""
    f32, bf = torch.float32, torch.bfloat16
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    sc, mask, dcap = ref._attn_scores(q, k, causal, window, cap)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    lsum = p.sum(-1, keepdim=True)
    hi = p.to(bf).to(f32)
    lo = (p - hi).to(bf).to(f32)
    vf = v.to(f32)
    out = (torch.einsum("bkgst,bktd->bkgsd", hi, vf)
           + torch.einsum("bkgst,bktd->bkgsd", lo, vf)) / lsum
    out = out.reshape(b, h, s, d).to(bf)
    p = (p / lsum).to(bf).to(f32)
    dof = do.to(f32).reshape(b, kh, g, s, d)
    delta = (dof * out.to(f32).reshape(b, kh, g, s, d)).sum(-1)
    ds = p * (torch.einsum("bkgsd,bktd->bkgst", dof, vf) - delta[..., None])
    if dcap is not None:
        ds = ds * dcap
    ds = torch.where(mask, ds, torch.zeros_like(ds)).to(bf).to(f32)
    scale = d ** -0.5
    qf = q.to(f32).reshape(b, kh, g, s, d)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k.to(f32)) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qf) * scale
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dof)
    return out, (dq.reshape(b, h, s, d).to(bf), dk.to(bf), dv.to(bf))


@pytest.mark.parametrize("case", sorted(LIMIT_CASES))
def test_bf16_attention_limits_take_kernel_arithmetic_not_faults(case):
    """The element limit on the bf16 forward (2 bf16 ulps plus 1e-3 of the
    row's max-abs) and the row limit on its gradients (2e-2 of each row's
    max-abs) pass the kernels' arithmetic, emulated, and reject faults
    planted in the plain result: the second half of the rows computed with
    one 64-key V tile read as zeros, and dv's last quarter of keys zeroed."""
    b, h, kh, s, t, d, causal, window, cap = LIMIT_CASES[case]
    rng = np.random.default_rng(sorted(LIMIT_CASES).index(case) + 30)
    q, do = _tb(_bf(rng, (b, h, s, d))), _tb(_bf(rng, (b, h, s, d)))
    k, v = _tb(_bf(rng, (b, kh, t, d))), _tb(_bf(rng, (b, kh, t, d)))
    kw = dict(causal=causal, window=window, cap=cap)
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    grads = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    emu_out, emu_grads = _kernel_like(q, k, v, do, causal, window, cap)
    floor = parity.row_floor(out, parity.BF16_ROW_FLOOR)
    assert 0.0 < parity.bf16_ulps(emu_out, out, floor) <= 1.0
    for got, want in zip(emu_grads, grads):
        assert 0.0 < parity.row_rel_err(got, want) <= GRAD_TOL
    vz = v.clone()
    vz[:, :, t // 2 - 64:t // 2] = 0
    bad = out.clone()
    bad[:, :, s // 2:] = ref.flash_attention_ref(q, k, vz, **kw)[:, :, s // 2:]
    assert parity.bf16_ulps(bad, out, floor) > 2.0
    dq_bad = grads[0].clone()
    dq_bad[:, :, s // 2:] = ref.flash_attention_bwd_ref(
        q, k, vz, out, lse, do, **kw)[0][:, :, s // 2:]
    dv_bad = grads[2].clone()
    dv_bad[:, :, 3 * t // 4:] = 0
    assert parity.row_rel_err(dq_bad, grads[0]) > GRAD_TOL
    assert parity.row_rel_err(dv_bad, grads[2]) > GRAD_TOL


# ---------------------------------------------------------------------------
# the production steps at bf16
# ---------------------------------------------------------------------------

def _cfgs(arch, n_layers, **kw):
    return (reduced(get_config(arch), n_layers=n_layers, **kw),
            jreduced(jget_config(arch), n_layers=n_layers, **kw))


def _params_bf16(cfg, jcfg, seed=0):
    """The reference's stacked bf16 init params, as (port tensors, JAX
    arrays)."""
    jp = jstacked.stack_params(
        jlm.init_params(jcfg, jax.random.PRNGKey(seed), dtype=BF), jcfg)
    template = tree_map(lambda x: x.to(torch.bfloat16),
                        stacked.stack_params(build_model(cfg).init(0, "cpu"),
                                             cfg))
    tree = jax.tree.map(np.asarray, jp)
    return params_from_numpy(tree, "cpu", template=template), jp


def _batch(cfg, b, s, rng):
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "weight": rng.uniform(0.5, 4.0, b).astype(np.float32)}


def _rms_rel(got, want) -> float:
    """The root mean square of got - want over that of want."""
    g, w = _f(got), _f(want)
    return float(np.sqrt(((g - w) ** 2).mean())
                 / max(np.sqrt((w ** 2).mean()), 1e-30))


def _check_step(old, new, jold, jnew, lr, what):
    """One bf16 step of each package, ``old``/``jold`` the (params,
    momentum) it started from and ``new``/``jnew`` its result as (params,
    momentum, the momentum of the same package's f32 step from the same
    state).  The momentum of each package's bf16 step lies 1-5% of a
    leaf's max-abs from its own f32 step's, because bf16 rounds at other
    places in PyTorch and XLA, so the two bf16 steps differ by up to 6%
    (each package's distance from f32 is that witness).  Held:

    * the update is the reference's ``p - lr * m.astype(p.dtype)``, run op
      by op in JAX on the port's own p and new m: bitwise;
    * each momentum leaf's distance from the f32 step exceeds the
      reference's own by at most MOMENTUM_TOL of its max-abs;
    * over all leaves, the mean RMS distance from the f32 step is at most
      RMS_RATIO times the reference's (a bf16 fault spread over the tree);
    * params within 2 bf16 ulps element by element, beyond what the
      params' difference before the step and the update's difference move
      them by: lr |m - m_ref| plus a bf16 ulp of each m (the update rounds
      m to bf16, where p - lr m cancels that ulp is larger than p's)."""
    (p0, _), (p1, m1, m32) = old, new
    (jp0, _), (jp1, jm1, jm32) = jold, jnew
    e_port, e_ref = [], []
    for i, (a0, a1, b1, b32, ja0, ja1, jb1, jb32) in enumerate(zip(
            leaves(p0), leaves(p1), leaves(m1), leaves(m32), jp0,
            jax.tree.leaves(jp1), jax.tree.leaves(jm1),
            jax.tree.leaves(jm32))):
        assert a1.dtype == torch.bfloat16 and b1.dtype == torch.float32
        rule = _jb(_f(a0)) - lr * jnp.asarray(_f(b1), jnp.float32).astype(BF)
        assert np.array_equal(_f(a1), _f(rule)), f"{what}: update leaf {i}"
        e_p, e_r = _rel(b1, b32), _rel(jb1, jb32)
        assert e_p <= e_r + MOMENTUM_TOL, (
            f"{what}: momentum leaf {i}: {e_p} from the f32 step "
            f"(the reference's {e_r})")
        e_port.append(_rms_rel(b1, b32))
        e_ref.append(_rms_rel(jb1, jb32))
        mp, mr = _f(b1), _f(jb1)
        slack = lr * (np.abs(mp - mr) + 2.0 ** -7 * (np.abs(mp) + np.abs(mr))) \
            + np.abs(_f(a0) - ja0)
        err_p = parity.bf16_ulps(a1, torch.from_numpy(_f(ja1)),
                                 torch.from_numpy(slack))
        assert err_p <= 2.0, f"{what}: param leaf {i}: {err_p} ulps"
    assert np.mean(e_port) <= RMS_RATIO * np.mean(e_ref), (
        what, np.mean(e_port), np.mean(e_ref))


STEP_CASES = {
    # name: (arch, layers, step kwargs)
    "gemma2": (GEMMA, 3, {}),
    "gemma2_passes2_micro2": (GEMMA, 3, {"local_passes": 2,
                                         "microbatches": 2}),
    "recurrentgemma": (RG, 3, {}),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_fl_train_step_bf16_matches_reference(case):
    """Two rounds of ``make_fl_train_step(dtype=bf16)`` (its default) from
    the reference's bf16 stacked params against the reference's step at
    bf16 on a 1 x 1 CPU mesh, each package's f32 step from the same state
    beside it (``_check_step``)."""
    arch, n_layers, kw = STEP_CASES[case]
    cfg, jcfg = _cfgs(arch, n_layers)
    b, s = 4, 32
    jfn, _ = jsteps.make_fl_train_step(
        jcfg, _jmesh(), JShape("t", seq_len=s, global_batch=b, kind="train"),
        dtype=BF, lr=1e-2, **kw)
    fn, (p_struct, m_struct, _) = steps.make_fl_train_step(
        cfg, InputShape("t", seq_len=s, global_batch=b, kind="train"),
        lr=1e-2, **kw)
    # each package's f32 step: the witness of its own bf16 rounding
    jfn32, _ = jsteps.make_fl_train_step(
        jcfg, _jmesh(), JShape("t", seq_len=s, global_batch=b, kind="train"),
        dtype=jnp.float32, lr=1e-2, **kw)
    fn32, _ = steps.make_fl_train_step(
        cfg, InputShape("t", seq_len=s, global_batch=b, kind="train"),
        dtype=torch.float32, lr=1e-2, **kw)
    p, jp = _params_bf16(cfg, jcfg)
    assert [(x.shape, x.dtype) for x in leaves(p)] == \
        [(x.shape, x.dtype) for x in leaves(p_struct)]
    m = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32), p)
    jm = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), jp)
    rng = np.random.default_rng(41)
    batches = [_batch(cfg, b, s, rng) for _ in range(2)]

    def to32(tree):
        return jax.tree.map(lambda x: x.astype(jnp.float32), tree)

    with _jmesh():
        jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
        jfn32 = _compiled(jfn32, to32(jp), jm, jb0)
        jfn = _compiled(jfn, jp, jm, jb0)
    for r, nb in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        tb = {k: torch.from_numpy(v) for k, v in nb.items()}
        _, m32, _, _ = fn32(tree_map(lambda x: x.float(), p),
                            tree_map(torch.clone, m), tb)
        old = (tree_map(torch.clone, p), tree_map(torch.clone, m))
        jold = ([_f(x) for x in jax.tree.leaves(jp)], None)
        with _jmesh():
            _, jm32, _, _ = jfn32(to32(jp), jax.tree.map(jnp.copy, jm), jb)
            jp, jm, jloss, _ = jfn(jp, jm, jb)
        p, m, loss, _ = fn(p, m, tb)
        assert _rel(loss, jloss) <= LOSS_TOL, (case, r)
        _check_step(old, (p, m, m32), jold, (jp, jm, jm32), 1e-2,
                    f"{case} round {r}")


def test_fl_train_step_bf16_sums_gradients_in_f32():
    """E = 3 passes over one batch give 3 equal bf16 gradients g.  The
    reference sums them into f32 zeros (3g is exact there) and divides by
    3: exactly g, so the momentum after one step equals the E = 1 step's.
    Summed in bf16 (the params' ``.grad``), (g + g) + g rounds and the
    mean misses g; the port keeps an f32 sum and gives g's bits."""
    cfg, _ = _cfgs(GEMMA, 2)
    shape = InputShape("t", seq_len=16, global_batch=2, kind="train")
    base = tree_map(lambda x: x.to(torch.bfloat16),
                    stacked.stack_params(build_model(cfg).init(3, "cpu"), cfg))
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg, 2, 16, np.random.default_rng(5)).items()}
    moms = {}
    for e in (1, 3):
        p = tree_map(torch.clone, base)
        m = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32), p)
        fn, _ = steps.make_fl_train_step(cfg, shape, lr=1e-2, local_passes=e)
        _, moms[e], _, _ = fn(p, m, batch)
    for a, b_ in zip(leaves(moms[1]), leaves(moms[3])):
        assert torch.equal(a, b_)
    g = [x.to(torch.bfloat16) for x in leaves(moms[1])]
    in_bf16 = [((x + x) + x).to(torch.float32) / 3 for x in g]
    assert any(not torch.equal(a, b_) for a, b_ in zip(in_bf16, leaves(moms[1])))


def _serve_cfgs(arch):
    # a 16,384-token vocabulary makes the embedding (and gemma2's tied
    # head) 2^21 elements: quantisable, so the int8 serve dequantises it
    return _cfgs(arch, 2, vocab=16384)


def _jquantize(jp):
    """The reference's ``quantize_params`` leaf by leaf: on the stacked
    tree itself it fails, because its ``is_leaf`` takes the tree's own
    tuples (the cycles' slices) for its (int8, scale) pairs."""
    flat, treedef = jax.tree.flatten(jp)
    pairs = [jsteps.quantize_params({"w": x}) for x in flat]
    return (jax.tree.unflatten(treedef, [q["w"] for q, _ in pairs]),
            jax.tree.unflatten(treedef, [sc["w"] for _, sc in pairs]))


@pytest.mark.parametrize("arch", [GEMMA, RG])
@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_prefill_and_serve_steps_bf16_match_reference(arch, quantize):
    """``make_prefill_step`` then three ``make_serve_step`` tokens at bf16
    (int8 weights when asked) against the reference's steps: the logits
    within 3e-2 of their max-abs at every step."""
    cfg, jcfg = _serve_cfgs(arch)
    b, prompt, max_len = 2, 24, 32
    p, jp = _params_bf16(cfg, jcfg, seed=1)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (b, prompt)).astype(np.int32)
    jpre, _ = jsteps.make_prefill_step(
        jcfg, _jmesh(), JShape("p", seq_len=max_len, global_batch=b,
                               kind="prefill"), dtype=BF)
    pre, (ps, tok_struct) = steps.make_prefill_step(
        cfg, InputShape("p", seq_len=max_len, global_batch=b,
                        kind="prefill"))
    assert tok_struct.shape == (b, max_len)
    with _jmesh():
        jlog, jcache = jpre(jp, jnp.asarray(toks))
    log, cache = pre(p, torch.from_numpy(toks))
    assert log.shape == (b, cfg.vocab_size)
    assert _rel(log, jlog) <= LOGIT_TOL
    dshape = dict(seq_len=max_len, global_batch=b, kind="decode")
    jserve, jargs = jsteps.make_serve_step(
        jcfg, _jmesh(), JShape("d", **dshape), dtype=BF,
        quantize_weights=quantize)
    serve, args = steps.make_serve_step(cfg, InputShape("d", **dshape),
                                        quantize_weights=quantize)
    assert len(args) == len(jargs)
    extra, jextra = (), ()
    if quantize:
        jq, js_ = _jquantize(jp)
        tq, ts_ = steps.quantize_params(p)
        assert any(s_ is not None for s_ in leaves(ts_))
        jp_use, p_use, jextra, extra = jq, tq, (js_,), (ts_,)
    else:
        jp_use, p_use = jp, p
    tok = np.argmax(_f(jlog), axis=-1).astype(np.int32)
    for i in range(3):
        pos = prompt + i
        with _jmesh():
            jlog, jcache = jserve(jp_use, jcache, jnp.asarray(tok),
                                  jnp.int32(pos), *jextra)
        log, cache = serve(p_use, cache, torch.from_numpy(tok), pos, *extra)
        assert log.shape == (b, cfg.vocab_size)
        assert _rel(log, jlog) <= LOGIT_TOL, (arch, quantize, i)
        tok = np.argmax(_f(jlog), axis=-1).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_bitwise(dtype):
    """``quantize_params``: int8 values and f32 scales bit for bit the
    reference's (its eager division by 127), only leaves of >= 2^20
    elements and >= 2 dims; ``dequantize_params`` bitwise; the structs
    split the same way."""
    rng = np.random.default_rng(12)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    big = (rng.standard_normal((1024, 1030))
           * rng.uniform(1e-3, 4.0, (1024, 1))).astype(np.float32)
    big[3] = 0.0                                   # a row of zeros: 1e-8
    small = rng.standard_normal((64, 64)).astype(np.float32)
    vec = rng.standard_normal((1 << 21,)).astype(np.float32)
    jtree = {"big": jnp.asarray(big, jdt), "small": jnp.asarray(small, jdt),
             "vec": jnp.asarray(vec, jdt)}
    ttree = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(tdt)
             for k, v in jtree.items()}
    jq, js_ = jsteps.quantize_params(jtree)
    tq, ts_ = steps.quantize_params(ttree)
    assert ts_["small"] is None and ts_["vec"] is None
    assert tq["big"].dtype == torch.int8 and ts_["big"].shape == (1024, 1)
    assert np.array_equal(tq["big"].numpy(), np.asarray(jq["big"]))
    assert np.array_equal(ts_["big"].numpy(), np.asarray(js_["big"]))
    assert torch.equal(tq["small"], ttree["small"])
    jd = jsteps.dequantize_params(jq, js_, BF)
    td = steps.dequantize_params(tq, ts_, torch.bfloat16)
    assert np.array_equal(_f(td["big"]), _f(jd["big"]))
    structs = {k: torch.empty(v.shape, dtype=tdt, device="meta")
               for k, v in ttree.items()}
    sq, ss = steps.quantize_param_structs(structs)
    assert sq["big"].dtype == torch.int8 and ss["big"].shape == (1024, 1)
    assert sq["small"].dtype == tdt and ss["small"] is None
