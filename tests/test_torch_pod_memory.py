"""The pod steps' memory a rank: the owners that held more than the
reference's compiled peak, repaired, on the CPU.

  * the token lookup on a mesh keeps the table split over ``model`` on the
    vocabulary (``lm._SplitVocabLookup``): on (2, 2) and (2, 3) meshes of
    gloo ranks, with a vocabulary ``model`` divides and one it does not,
    the rows are one device's bit for bit, the table's gradient is within
    1e-5 of one device's and of the reference's lookup on the same XLA
    mesh, the gradient comes back in the table's own placement, and no op
    on a rank makes a tensor as large as the whole table; on a (1, 1) mesh
    rows and gradient are one device's bit for bit;
  * dbrx-132b (2 layers) trained for 2 rounds with the dense MoE
    (``moe_mode="dense"``, each rank's products of its own experts on its
    own tokens) on a (2, 2) mesh, against the reference's mesh step on 4
    XLA devices and against one device;
  * ``moe_ffn_dense`` and ``mlstm_chunkwise`` on plain tensors, forward
    and gradients, bit for bit the bodies they replaced (kept here as
    their witnesses);
  * dry runs on ``meta`` (rank 0 of a ``fake`` 16x16 group, one
    subprocess): recurrentgemma-9b ``decode_32k`` at full depth peaks
    below one whole (V, d) table; command-r-35b ``train_4k`` at 1 layer
    below one table and one table gradient; recurrentgemma-9b
    ``prefill_32k`` at 3 layers frees each RG-LRU scan output with its
    layer; dbrx-132b and xlstm-350m ``train_4k`` at 2 layers peak below
    the parent tree's figures less the bytes this repair removed;
    xlstm-350m ``decode_32k`` at full depth writes each layer's new state
    into its cache as it goes.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import ffn, lm, stacked, xlstm  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.tree import leaves, tree_map, unflatten_like  # noqa: E402
from repro_torch.weights import (params_from_mesh,  # noqa: E402
                                 params_from_numpy, params_to_mesh)

REPO = Path(__file__).resolve().parents[1]
MODULE_TOL = 1e-5       # tests/test_torch_mesh.py's
MODEL_TOL = 1e-4
D, B, S = 16, 4, 6
# mesh: {case: vocab}; 240 splits over 2 and 3 model ranks, 241 and 242
# over neither
LOOKUPS = {(2, 2): {"split": 240, "whole": 241},
           (2, 3): {"split": 240, "whole": 242}}
DBRX, TRAIN_B, TRAIN_S = "dbrx-132b", 8, 64
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def _env(devices: int) -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")


def _rel(got, want) -> float:
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    num = np.abs(g - w).max() if w.size else 0.0
    return 0.0 if num == 0.0 else num / max(np.abs(w).max(), 1e-30)


# ---------------------------------------------------------------------------
# the token lookup
# ---------------------------------------------------------------------------

def _lookup_inputs(vocab: int, seed: int):
    """table (V, D), tokens (B, S) covering both ends of the vocabulary,
    the rows' cotangent (B, S, D)."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((vocab, D)).astype(np.float32)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    tokens[0, :3] = [0, vocab - 1, vocab // 2]
    tokens[1, 1] = tokens[2, 4]     # a token twice: its rows' sum
    r = rng.standard_normal((B, S, D)).astype(np.float32)
    return table, tokens, r


def _cfg(vocab: int):
    import dataclasses
    return dataclasses.replace(get_config("gemma2-2b"), d_model=D,
                               vocab_size=vocab)


def _one_device_lookup(vocab: int, seed: int):
    table, tokens, r = _lookup_inputs(vocab, seed)
    e = torch.from_numpy(table).requires_grad_(True)
    x = lm._embed_tokens({"embed": e}, _cfg(vocab), torch.from_numpy(tokens))
    (x * torch.from_numpy(r)).sum().backward()
    return x.detach().numpy(), e.grad.numpy()


class _Largest(torch.utils._python_dispatch.TorchDispatchMode):
    """The most elements of any tensor a local op makes (DTensor's ops go
    on to DTensor, whose local ops come back here; the fake tensors of its
    sharding propagation hold nothing)."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        from torch._subclasses.fake_tensor import FakeTensor
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor):
                self.most = max(self.most, t.numel())
        return out


def _mesh_lookup(mesh, vocab: int, seed: int) -> dict:
    """The lookup's rows and the table's gradient on ``mesh`` (the table
    placed by the train rules, tokens and cotangent on the batch's axes),
    gathered; the gradient's placement and local shape against the
    table's; the largest tensor a local op made."""
    rules = sh.train_rules(False)
    table, tokens, r = _lookup_inputs(vocab, seed)
    p = sh.place_params({"embed": torch.from_numpy(table)}, mesh, rules)
    p["embed"].requires_grad_(True)
    t = sh.place_batch(torch.from_numpy(tokens), mesh, rules)
    rr = sh.place_batch(torch.from_numpy(r), mesh, rules)
    with _Largest() as seen:
        x = lm._embed_tokens(p, _cfg(vocab), t)
        (x * rr).sum().backward()
    g = p["embed"].grad
    return {"x": x.full_tensor().detach(), "g": g.full_tensor(),
            "split": p["embed"].placements[-1].is_shard(),
            "own_placement": tuple(g.placements) == tuple(
                p["embed"].placements) or not g.placements[-1].is_shard(),
            "local_shape": tuple(g.to_local().shape) == tuple(
                p["embed"].to_local().shape),
            "most": seen.most}


# ---------------------------------------------------------------------------
# the dense MoE's mesh step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dbrx_inputs():
    """The reference's stacked init params of the 2-layer dbrx-132b and 2
    rounds' batches."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import lm as jlm
    from repro.models import stacked as jstacked
    jcfg = jreduced(jget_config(DBRX), n_layers=2)
    jp = jstacked.stack_params(jlm.init_params(jcfg, jax.random.PRNGKey(0)),
                               jcfg)
    flat = [np.asarray(x) for x in jax.tree.leaves(jp)]
    rng = np.random.default_rng(90)
    v = jcfg.vocab_size
    batches = [{"tokens": rng.integers(0, v, (TRAIN_B, TRAIN_S)).astype(
                    np.int32),
                "labels": rng.integers(-1, v, (TRAIN_B, TRAIN_S)).astype(
                    np.int32),
                "weight": rng.uniform(0.5, 4.0, TRAIN_B).astype(np.float32)}
               for _ in range(2)]
    return flat, batches


def _dbrx_train(flat, batches, mesh=None):
    """2 rounds of the dense-MoE train step from ``flat``: losses, params
    and momentum (gathered)."""
    cfg = reduced(get_config(DBRX), n_layers=2)
    from repro_torch.models import build_model
    tmpl = stacked.stack_params(build_model(cfg).init(0, "cpu"), cfg)
    if mesh is None:
        p = params_from_numpy(unflatten_like(tmpl, flat), "cpu",
                              template=tmpl)
    else:
        p = params_to_mesh(unflatten_like(tmpl, flat), mesh,
                           steps.train_step_rules(), "cpu", template=tmpl)
    m = tree_map(torch.zeros_like, p)
    fn, _ = steps.make_fl_train_step(
        cfg, InputShape("t", seq_len=TRAIN_S, global_batch=TRAIN_B,
                        kind="train"),
        mesh=mesh, lr=1e-2, dtype=torch.float32, moe_mode="dense")
    losses = []
    for bt in batches:
        p, m, loss, _ = fn(p, m, {k: torch.from_numpy(np.array(v))
                                  for k, v in bt.items()})
        losses.append(float(loss))
    if mesh is not None:
        p, m = params_from_mesh(p), params_from_mesh(m)
    def arr(x):
        return x.detach().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    return {"losses": losses, "params": [arr(x) for x in leaves(p)],
            "momentum": [arr(x) for x in leaves(m)]}


# ---------------------------------------------------------------------------
# the ranks, the reference, the dry runs
# ---------------------------------------------------------------------------

def _rank_pod(cm, shape, inputs_path):
    """This shape's lookups, and on (2, 2) the dbrx dense train step."""
    mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
    out = {name: _mesh_lookup(mesh, vocab, seed)
           for seed, (name, vocab) in enumerate(LOOKUPS[shape].items())}
    if shape == (2, 2):
        data = np.load(inputs_path)
        n = len([k for k in data.files if k.startswith("dbrx_p")])
        out["dbrx"] = _dbrx_train(
            [data[f"dbrx_p{i}"] for i in range(n)],
            [{k: data[f"dbrx_r{r}_{k}"] for k in ("tokens", "labels",
                                                   "weight")}
             for r in range(2)], mesh)
    return out


def _rank_one(cm):
    """The ``split`` lookup of (2, 2) on a (1, 1) mesh of this group, and
    how many times it took ``_SplitVocabLookup``."""
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), "cpu")
    calls = []
    fn = getattr(lm, "_SplitVocabLookup", None)
    if fn is not None:
        split = fn.apply
        fn.apply = lambda *a: calls.append(1) or split(*a)
    return dict(_mesh_lookup(mesh, LOOKUPS[(2, 2)]["split"], 0),
                split_lookups=len(calls))


_JAX_REF = r"""
import dataclasses, json, sys
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP
from repro.configs import get_config, reduced
from repro.configs.shapes import InputShape
from repro.launch import steps
from repro.models import lm, stacked
from repro.sharding.specs import fit_spec
data = np.load(sys.argv[1])
lookups = json.loads(sys.argv[2])
fast = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
out = {}
for key, vocab in lookups.items():
    shape = tuple(int(v) for v in key.split("_")[:2])
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
    table = jnp.asarray(data[f"lk_{key}_table"])
    tok = jnp.asarray(data[f"lk_{key}_tokens"])
    r = jnp.asarray(data[f"lk_{key}_r"])
    cfg = dataclasses.replace(get_config("gemma2-2b"),
                              d_model=table.shape[1], vocab_size=vocab)

    def grad(e, t, rr):
        rows, vjp = jax.vjp(lambda e_: lm._embed_inputs({"embed": e_}, cfg,
                                                        t, None), e)
        return rows, vjp(rr)[0]

    sd = lambda s, x: NamedSharding(mesh, fit_spec(s, x.shape, mesh))
    fn = jax.jit(grad, in_shardings=(sd(JP("model", "data"), table),
                                     sd(JP("data", None), tok),
                                     sd(JP("data", None, None), r)))
    rows, g = fn.lower(table, tok, r).compile(compiler_options=fast)(
        table, tok, r)
    out[f"{key}_rows"], out[f"{key}_g"] = np.asarray(rows), np.asarray(g)

mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
cfg = reduced(get_config("dbrx-132b"), n_layers=2)
fn, _ = steps.make_fl_train_step(
    cfg, mesh, InputShape("t", seq_len=64, global_batch=8, kind="train"),
    dtype=jnp.float32, lr=1e-2, moe_mode="dense")
t = jax.eval_shape(lambda: stacked.stack_params(
    lm.init_params(cfg, jax.random.PRNGKey(0)), cfg))
p = jax.tree.unflatten(jax.tree.structure(t), [
    jnp.asarray(data[f"dbrx_p{i}"]) for i in range(len(jax.tree.leaves(t)))])
m = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p)
for r in range(2):
    batch = {k: jnp.asarray(data[f"dbrx_r{r}_{k}"])
             for k in ("tokens", "labels", "weight")}
    with mesh:
        if r == 0:
            fn = fn.lower(p, m, batch).compile(compiler_options=fast)
        p, m, loss, _ = fn(p, m, batch)
    out[f"dbrx_loss{r}"] = np.asarray(loss)
for i, x in enumerate(jax.tree.leaves(p)):
    out[f"dbrx_p{i}"] = np.asarray(x)
for i, x in enumerate(jax.tree.leaves(m)):
    out[f"dbrx_m{i}"] = np.asarray(x)
np.savez(sys.argv[3], **out)
"""

# (arch, shape, layers): None is full depth
DRY_CASES = [("recurrentgemma-9b", "decode_32k", None),
             ("command-r-35b", "train_4k", 1),
             ("recurrentgemma-9b", "prefill_32k", 3),
             ("dbrx-132b", "train_4k", 2),
             ("xlstm-350m", "train_4k", 2),
             ("xlstm-350m", "decode_32k", None)]

_DRY = r"""
import json, sys, weakref
import torch
torch.set_num_threads(1)
from repro_torch.kernels import ops
from repro_torch.launch import dryrun

# each RG-LRU scan output's storage, and at each scan the most earlier
# ones still alive
live, most = set(), [0]
scan = ops.rglru_scan


def counted(a, b):
    most[0] = max(most[0], len(live))
    h = scan(a, b)
    st = h.untyped_storage()
    live.add(st._cdata)
    weakref.finalize(st, live.discard, st._cdata)
    return h


ops.rglru_scan = counted
out = {}
for arch, shape, layers in json.loads(sys.argv[1]):
    live.clear()
    most[0] = 0
    rec = dryrun.run_one(arch, shape, False, verbose=False, save=False,
                         layers=layers)
    out[f"{arch}/{shape}"] = {
        "peak": rec["peak_memory_bytes"], "scans_alive": most[0],
        "arguments": rec["memory_analysis"]["argument_size"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def pod_runs(tmp_path_factory):
    """(the reference's results, the dry runs' records, each mesh's rank
    0 results, the (1, 1) rank's): the reference on 6 XLA devices and the
    dry runs on ``meta``, each in a subprocess, run while the gloo ranks
    run."""
    tmp = tmp_path_factory.mktemp("pod")
    arrays, lookups = {}, {}
    for shape, cases in LOOKUPS.items():
        for seed, (name, vocab) in enumerate(cases.items()):
            key = f"{shape[0]}_{shape[1]}_{name}"
            lookups[key] = vocab
            table, tokens, r = _lookup_inputs(vocab, seed)
            arrays.update({f"lk_{key}_table": table,
                           f"lk_{key}_tokens": tokens, f"lk_{key}_r": r})
    flat, batches = _dbrx_inputs()
    arrays.update({f"dbrx_p{i}": x for i, x in enumerate(flat)})
    for r, bt in enumerate(batches):
        arrays.update({f"dbrx_r{r}_{k}": v for k, v in bt.items()})
    in_path, ref_path = tmp / "inputs.npz", tmp / "reference.npz"
    np.savez(in_path, **arrays)
    ref = subprocess.Popen(
        [sys.executable, "-c", _JAX_REF, str(in_path), json.dumps(lookups),
         str(ref_path)], env=_env(6), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    dry = subprocess.Popen(
        [sys.executable, "-c", _DRY, json.dumps(DRY_CASES)],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = {shape: mesh_mod.run_ranks(
            _rank_pod, shape[0] * shape[1], device="cpu",
            init_file=str(tmp / f"rendezvous_{shape[0]}x{shape[1]}"),
            args=(shape, str(in_path))) for shape in LOOKUPS}
        (one,) = mesh_mod.run_ranks(_rank_one, 1, device="cpu",
                                    init_file=str(tmp / "rendezvous_1"))
    finally:
        _, ref_err = ref.communicate(timeout=900)
        dry_out, dry_err = dry.communicate(timeout=900)
    assert ref.returncode == 0, ref_err[-3000:]
    assert dry.returncode == 0, dry_err[-3000:]
    return (dict(np.load(ref_path)),
            json.loads(dry_out.strip().splitlines()[-1]), ranks, one)


# ---------------------------------------------------------------------------
# the lookup's tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,name", [(s, n) for s in LOOKUPS
                                        for n in LOOKUPS[s]],
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else v)
def test_lookup_keeps_the_table_split_and_is_one_devices(pod_runs, shape,
                                                         name):
    """Rows bitwise one device's on every rank, and the reference's on the
    same mesh of XLA devices; the table's gradient within 1e-5 of both,
    the size of the rank's shard, in the table's own placement where
    ``model`` splits the vocabulary; and no local op on any rank makes a
    tensor of the whole table's size, forward or backward (before, every
    rank gathered the whole table)."""
    ref, _, ranks, _ = pod_runs
    seed = list(LOOKUPS[shape]).index(name)
    vocab = LOOKUPS[shape][name]
    want_x, want_g = _one_device_lookup(vocab, seed)
    key = f"{shape[0]}_{shape[1]}_{name}"
    assert np.array_equal(want_x, ref[f"{key}_rows"])
    for got in ranks[shape]:
        assert np.array_equal(got[name]["x"].numpy(), want_x)
        assert _rel(got[name]["g"].numpy(), want_g) <= MODULE_TOL
        assert _rel(got[name]["g"].numpy(), ref[f"{key}_g"]) <= MODULE_TOL
        assert got[name]["most"] < vocab * D
        assert got[name]["local_shape"] and got[name]["own_placement"]
    # the vocabulary is split over model exactly where model divides it
    assert ranks[shape][0][name]["split"] == (vocab % shape[1] == 0)


def test_lookup_on_a_1x1_mesh_is_one_devices_bitwise(pod_runs):
    """A mesh of one rank takes the split lookup (phase 15a's (1, 1) NCCL
    mesh holds the train step bitwise) and gives one device's rows and
    gradient bit for bit."""
    _, _, _, one = pod_runs
    want_x, want_g = _one_device_lookup(LOOKUPS[(2, 2)]["split"], 0)
    assert one["split_lookups"] == 1
    assert np.array_equal(one["x"].numpy(), want_x)
    assert np.array_equal(one["g"].numpy(), want_g)


# ---------------------------------------------------------------------------
# the dense MoE on the mesh
# ---------------------------------------------------------------------------

def _close_leaves(got, want, tol, what):
    assert len(got) == len(want), what
    top = max(np.abs(np.asarray(w)).max() for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        if np.abs(np.asarray(w)).max() <= 1e-6 * top:   # zero by the maths
            assert np.abs(g).max() <= 1e-6 * top, f"{what}: leaf {i}"
        else:
            assert _rel(g, w) <= tol, f"{what}: leaf {i} off by {_rel(g, w)}"


def test_dense_moe_train_step_matches_reference_and_one_device(pod_runs):
    """dbrx-132b (2 layers) with ``moe_mode="dense"`` for 2 rounds on the
    (2, 2) mesh: losses within 1e-5 and params and momentum within 1e-4
    of the reference's mesh step and of one device's step."""
    ref, _, ranks, _ = pod_runs
    got = ranks[(2, 2)][0]["dbrx"]
    n = len(got["params"])
    want = _dbrx_train(*_dbrx_inputs())
    for r in range(2):
        assert _rel(got["losses"][r], ref[f"dbrx_loss{r}"]) <= MODULE_TOL
        assert _rel(got["losses"][r], want["losses"][r]) <= MODULE_TOL
    _close_leaves(got["params"], [ref[f"dbrx_p{i}"] for i in range(n)],
                  MODEL_TOL, "params vs reference")
    _close_leaves(got["momentum"], [ref[f"dbrx_m{i}"] for i in range(n)],
                  MODEL_TOL, "momentum vs reference")
    _close_leaves(got["params"], want["params"], MODEL_TOL,
                  "params vs one device")
    _close_leaves(got["momentum"], want["momentum"], MODEL_TOL,
                  "momentum vs one device")
    assert all(rk["dbrx"]["losses"] == got["losses"]
               for rk in ranks[(2, 2)])


# ---------------------------------------------------------------------------
# plain tensors: the replaced bodies as witnesses
# ---------------------------------------------------------------------------

def _witness_moe_ffn_dense(params, x, moe, act_name="silu"):
    """``moe_ffn_dense`` as it was before its mesh products went through
    ``_expert_matmul`` (its plain-tensor path)."""
    import torch.nn.functional as F
    from repro_torch.models.common import activation
    b, s, d = x.shape
    e = moe.n_experts
    t = b * s
    xf = x.reshape(t, d)
    gate_vals, expert_ids, aux = ffn._route(params, xf, moe)
    combine = (F.one_hot(expert_ids, e).to(torch.float32)
               * gate_vals[..., None]).sum(dim=1)
    act = activation(act_name)
    h = act(torch.matmul(xf, params["we_gate"]))
    h = h * torch.matmul(xf, params["we_up"])
    y_e = torch.matmul(h, params["we_down"])
    y = torch.einsum("etd,te->td", y_e, combine.to(y_e.dtype))
    return y.reshape(b, s, d), aux.to(x.dtype)


def _witness_mlstm_chunkwise(q, k, v, i_pre, f_pre, *, chunk=128):
    """``mlstm_chunkwise`` as it was before its chunks ran under a
    checkpoint (f32 inputs)."""
    bsz, nh, s, hd = q.shape
    l = min(chunk, s)
    nc = s // l
    logf = xlstm._log_sigmoid(f_pre)
    c_st = torch.zeros((bsz, nh, hd, hd), dtype=torch.float32)
    n_st = torch.zeros((bsz, nh, hd), dtype=torch.float32)
    m_st = torch.full((bsz, nh), float("-inf"), dtype=torch.float32)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool))
    zero = torch.zeros((), dtype=torch.float32)
    hs = []
    for j in range(nc):
        cut = slice(j * l, (j + 1) * l)
        qc, kc, vc = q[:, :, cut], k[:, :, cut], v[:, :, cut]
        ic, lfc = i_pre[:, :, cut], logf[:, :, cut]
        b_cum = torch.cumsum(lfc, 2)
        u = ic - b_cum
        m_run = torch.maximum(m_st[..., None], torch.cummax(u, 2).values)
        w_decay = torch.exp(u[:, :, None, :] - m_run[..., None])
        w_decay = torch.where(tri, w_decay, zero)
        sc = torch.matmul(qc, kc.transpose(-1, -2)) * w_decay
        num_intra = torch.matmul(sc, vc)
        den_intra = sc.sum(dim=-1)
        scale_in = torch.exp(m_st[..., None] - m_run)
        num_inter = (torch.matmul(qc, c_st.transpose(-1, -2))
                     * scale_in[..., None])
        den_inter = torch.matmul(qc, n_st[..., None])[..., 0] * scale_in
        m_t = b_cum + m_run
        denom = torch.maximum(torch.abs(den_intra + den_inter),
                              torch.exp(-m_t))
        hs.append((num_intra + num_inter) / denom[..., None])
        m_end = torch.maximum(m_st, u.max(dim=-1).values)
        w_end = torch.exp(u - m_end[..., None])
        decay = torch.exp(m_st - m_end)
        c_st = (decay[..., None, None] * c_st
                + torch.matmul((vc * w_end[..., None]).transpose(-1, -2),
                               kc))
        n_st = (decay[..., None] * n_st
                + torch.matmul(w_end[..., None, :], kc)[..., 0, :])
        m_st = b_cum[..., -1] + m_end
    h = hs[0] if nc == 1 else torch.cat(hs, dim=2)
    return h, (c_st, n_st, m_st)


def _grads(fn, arrays, cot_seed):
    """fn's outputs and the gradients of every input under a seeded
    cotangent of each floating output."""
    ins = [torch.from_numpy(a.copy()).requires_grad_(
        a.dtype == np.float32) for a in arrays]
    outs = [o for o in torch.utils._pytree.tree_leaves(fn(*ins))
            if o.is_floating_point()]
    rng = np.random.default_rng(cot_seed)
    loss = sum((o * torch.from_numpy(rng.standard_normal(
        tuple(o.shape)).astype(np.float32))).sum() for o in outs)
    loss.backward()
    return [o.detach() for o in outs] + [t.grad for t in ins
                                         if t.grad is not None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_dense_is_its_plain_body_bitwise(dtype):
    from repro_torch.configs.base import MoEConfig
    moe = MoEConfig(4, 2, 24)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    shapes = {"router": (16, 4), "we_gate": (4, 16, 24),
              "we_up": (4, 16, 24), "we_down": (4, 24, 16)}
    p = {k: torch.from_numpy((0.3 * rng.standard_normal(s)).astype(
        np.float32)).to(dt).requires_grad_(True) for k, s in shapes.items()}
    x0 = torch.from_numpy(rng.standard_normal((2, 10, 16)).astype(
        np.float32)).to(dt)
    out = []
    for fn in (ffn.moe_ffn_dense, _witness_moe_ffn_dense):
        x = x0.clone().requires_grad_(True)
        y, aux = fn(p, x, moe)
        ((y.float() * torch.linspace(-1, 1, y.numel()).reshape(y.shape))
         .sum() + 3.0 * aux.float()).backward()
        out.append([y, aux, x.grad] + [p[k].grad.clone() for k in shapes])
        for k in shapes:
            p[k].grad = None
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 128)])
def test_mlstm_chunkwise_is_its_plain_body_bitwise(s, chunk):
    """The checkpointed chunks recompute the same ops: h, the final (C,
    n, m) and every input's gradient bitwise the witness's."""
    rng = np.random.default_rng(s)
    arrays = [rng.standard_normal((2, 3, s, 8)).astype(np.float32)
              for _ in range(3)] + [
        rng.standard_normal((2, 3, s)).astype(np.float32) for _ in range(2)]
    got = _grads(functools.partial(xlstm.mlstm_chunkwise, chunk=chunk),
                 arrays, 1)
    want = _grads(functools.partial(_witness_mlstm_chunkwise, chunk=chunk),
                  arrays, 1)
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the dry runs
# ---------------------------------------------------------------------------

GIB = 2 ** 30
# the parent tree's peaks a rank (B) at these depths, this sandbox's torch
PARENT_PEAK = {"dbrx-132b/train_4k": 10_682_348_114,
               "xlstm-350m/train_4k": 11_246_100_102}


def test_decode_peaks_below_one_whole_table(pod_runs):
    """recurrentgemma-9b ``decode_32k``, full depth: every rank gathered
    the whole (256,000 x 4,096) bf16 table for its 8 tokens' rows (4.11
    GiB a rank against 1.95 for the table)."""
    _, dry, _, _ = pod_runs
    cfg = get_config("recurrentgemma-9b")
    table = cfg.vocab_size * cfg.d_model * 2
    assert dry["recurrentgemma-9b/decode_32k"]["peak"] < table


def test_train_step_holds_no_whole_table_nor_its_gradient(pod_runs):
    """command-r-35b ``train_4k`` at 1 layer peaks below one whole bf16
    (256,000 x 8,192) table plus one gradient of it: the lookup's gathered
    table and its pending whole gradient set the peak before."""
    _, dry, _, _ = pod_runs
    cfg = get_config("command-r-35b")
    table = cfg.vocab_size * cfg.d_model * 2
    assert dry["command-r-35b/train_4k"]["peak"] < 2 * table


def test_prefill_frees_each_scan_output_with_its_layer(pod_runs):
    """recurrentgemma-9b ``prefill_32k`` at 3 layers: when a layer's scan
    runs, no earlier layer's (B, S, W) f32 scan output is alive (the
    state's h was a view of it, which kept it whole)."""
    _, dry, _, _ = pod_runs
    assert dry["recurrentgemma-9b/prefill_32k"]["scans_alive"] == 0


def test_dense_moe_train_peak_falls_by_its_products(pod_runs):
    """dbrx-132b ``train_4k`` at 2 layers: each rank's three forward
    products were all 16 experts' for its 8,192 tokens of a microbatch,
    (16, 8,192, 10,752) bf16 each; a rank's share is one expert's."""
    _, dry, _, _ = pod_runs
    cfg = get_config("dbrx-132b")
    e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
    tokens = 32 * 4_096 // 16               # a microbatch's a data rank
    removed = 3 * (e - e // 16) * tokens * f * 2
    assert removed == 7_927_234_560
    got = dry["dbrx-132b/train_4k"]["peak"]
    assert got <= PARENT_PEAK["dbrx-132b/train_4k"] - removed


def test_mlstm_train_peak_falls_by_its_chunk_intermediates(pod_runs):
    """xlstm-350m ``train_4k`` at 2 layers, the rank's 16 of 256
    sequences: the f32 q, k and v (now cast a chunk at a time), the
    carry's first zeros made at the global batch, and the three head
    products' weights broadcast over the global batch are gone."""
    _, dry, _, _ = pod_runs
    cfg = get_config("xlstm-350m")
    w = int(cfg.d_model * cfg.xlstm_proj_factor)
    h, hd = cfg.n_heads, w // cfg.n_heads
    b, b_all, s = 16, 256, 4_096
    qkv_f32 = 3 * b * h * s * hd * 4
    zeros = (b_all - b) * h * hd * hd * 4
    broadcast = 3 * (b_all - b) * h * hd * hd * 2
    removed = qkv_f32 + zeros + broadcast
    got = dry["xlstm-350m/train_4k"]["peak"]
    assert got <= PARENT_PEAK["xlstm-350m/train_4k"] - removed


def test_serve_step_writes_each_state_as_it_goes(pod_runs):
    """xlstm-350m ``decode_32k`` at full depth: the serve step writes each
    layer's new state into its slice of the stacked cache as soon as the
    layer is done, so above its arguments (params and cache) a rank holds
    less than four layers' (C, n, m) at once; before, every mLSTM layer's
    new state waited for the end of the step beside the cache, and each
    head product broadcast its weight over the global batch."""
    _, dry, _, _ = pod_runs
    cfg = get_config("xlstm-350m")
    w = int(cfg.d_model * cfg.xlstm_proj_factor)
    h, hd = cfg.n_heads, w // cfg.n_heads
    b = 128 // 16                            # the rank's rows of the batch
    state = b * h * (hd * hd + hd + 1) * 4
    rec = dry["xlstm-350m/decode_32k"]
    assert rec["peak"] - rec["arguments"] < 4 * state
