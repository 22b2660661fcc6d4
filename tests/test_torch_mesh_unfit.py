"""The port's LM steps on a mesh whose ``model`` axis does not divide the
heads, on the CPU.

The production meshes put 4-, 8-, 14- and 28-head configs on a 16-wide
``model`` axis.  Here a (2, 3) mesh of 6 gloo ranks does the same to the
reduced configs at ``d_model`` 96: their 4 heads do not divide 3, while
their widths (96, 384, the xLSTM's 192) do, so the weights are split on
``model`` and the heads are not.  That runs every path the head split
takes there: ``attention._head_proj``'s rows of x against the whole
weight (its weight gradient a sum over the ranks' rows),
``sharding.ctx.split_dim`` and ``common.map_grad`` in the xLSTM forward
and backward, the sLSTM steps on each rank's rows, the mLSTM's local
``cumsum`` and ``cummax``, and cross-attention's decode with its heads
gathered.

  * the train step, 2 rounds, for gemma2-2b, xlstm-350m and
    seamless-m4t-medium (frames from the seed): the losses within 1e-5
    and params and momentum within MODEL_TOL of the reference's mesh
    step on 6 XLA CPU devices (a subprocess) and of the port's
    one-device step; every replicated leaf bitwise the same on every
    rank;
  * prefill and 4 decode steps of the same three: the logits within
    MODEL_TOL of the reference's mesh steps and of one device;
  * the same for seamless-m4t-medium on a (3, 2) mesh of the same ranks
    (B = 6), where its heads do divide ``model``: cross-attention's decode
    then gathers the split heads before its scores.

The reference's mesh runs on Auto axes (``jax.sharding.Mesh``), as in
``tests/test_torch_mesh.py``, whose helpers this file shares.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from test_torch_mesh import (DECODE_STEPS, MODEL_TOL, MODULE_TOL,  # noqa: E402
                             S, SERVE_LEN, _close_leaves, _env, _np, _rel,
                             _replicated_digests)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model, stacked  # noqa: E402
from repro_torch.tree import leaves, tree_map, unflatten_like  # noqa: E402
from repro_torch.weights import (params_from_mesh,  # noqa: E402
                                 params_from_numpy, params_to_mesh)

D_MODEL = 96
LAYERS = 2
RANKS = 6
# name: (arch, mesh, batch, train); the heads fit "model" only in the last
CASES = {
    "gemma2-2b": ("gemma2-2b", (2, 3), 4, True),
    "xlstm-350m": ("xlstm-350m", (2, 3), 4, True),
    "seamless-m4t-medium": ("seamless-m4t-medium", (2, 3), 4, True),
    "seamless_heads_fit": ("seamless-m4t-medium", (3, 2), 6, False),
}
TRAIN = sorted(k for k, c in CASES.items() if c[3])

_JAX_STEPS = r"""
import json, sys
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config, reduced
from repro.configs.shapes import InputShape
from repro.launch import steps
from repro.models import lm, stacked
cases, d_model, layers, s = json.loads(sys.argv[2])
data = np.load(sys.argv[1])
fast = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
out = {}


def tree(cfg, prefix):
    t = jax.eval_shape(lambda: stacked.stack_params(
        lm.init_params(cfg, jax.random.PRNGKey(0)), cfg))
    flat = [jnp.asarray(data[f"{prefix}_p{i}"])
            for i in range(len(jax.tree.leaves(t)))]
    return jax.tree.unflatten(jax.tree.structure(t), flat)


for name, (arch, (rows, cols), b, train) in cases.items():
    mesh = Mesh(np.array(jax.devices()).reshape(rows, cols),
                ("data", "model"))
    cfg = reduced(get_config(arch), n_layers=layers, d_model=d_model)
    fe = [f"{name}_frontend"] if cfg.frontend is not None else []
    if train:
        fn, _ = steps.make_fl_train_step(
            cfg, mesh, InputShape("t", seq_len=s, global_batch=b,
                                  kind="train"), dtype=jnp.float32, lr=1e-2)
        p = tree(cfg, name)
        m = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p)
        for r in range(2):
            batch = {k: jnp.asarray(data[f"{name}_r{r}_{k}"])
                     for k in ("tokens", "labels", "weight")}
            if fe:
                batch["frontend"] = jnp.asarray(data[fe[0]])
            with mesh:
                if r == 0:
                    fn = fn.lower(p, m, batch).compile(compiler_options=fast)
                p, m, loss, _ = fn(p, m, batch)
            out[f"{name}_loss{r}"] = np.asarray(loss)
        for i, x in enumerate(jax.tree.leaves(p)):
            out[f"{name}_p{i}"] = np.asarray(x)
        for i, x in enumerate(jax.tree.leaves(m)):
            out[f"{name}_m{i}"] = np.asarray(x)

    shape = InputShape("s", seq_len=s + 8, global_batch=b, kind="prefill")
    pf, _ = steps.make_prefill_step(cfg, mesh, shape, dtype=jnp.float32)
    sv, _ = steps.make_serve_step(
        cfg, mesh, InputShape("d", seq_len=s + 8, global_batch=b,
                              kind="decode"), dtype=jnp.float32)
    p = tree(cfg, name)
    args = (p, jnp.asarray(data[f"{name}_r0_tokens"]),
            *(jnp.asarray(data[k]) for k in fe))
    with mesh:
        pf = pf.lower(*args).compile(compiler_options=fast)
        logits, cache = pf(*args)
        outs = [np.asarray(logits)]
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for i in range(4):
            if i == 0:
                sv = sv.lower(p, jax.device_get(cache), tok,
                              jnp.int32(s)).compile(compiler_options=fast)
            logits, cache = sv(p, jax.device_get(cache), tok,
                               jnp.int32(s + i))
            outs.append(np.asarray(logits))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out[f"{name}_logits"] = np.stack(outs)
np.savez(sys.argv[3], **out)
"""


def _cfg(name):
    return reduced(get_config(CASES[name][0]), n_layers=LAYERS,
                   d_model=D_MODEL)


def _template(cfg):
    return stacked.stack_params(build_model(cfg).init(0, "cpu"), cfg)


def _inputs(name, seed) -> dict:
    """The reference's stacked init params, 2 rounds' batches and, for an
    encoder, the frames, as numpy arrays under ``<name>_`` keys."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import lm as jlm
    from repro.models import stacked as jstacked
    b = CASES[name][2]
    jcfg = jreduced(jget_config(CASES[name][0]), n_layers=LAYERS,
                    d_model=D_MODEL)
    jp = jstacked.stack_params(jlm.init_params(jcfg, jax.random.PRNGKey(0)),
                               jcfg)
    out = {f"{name}_p{i}": np.asarray(x)
           for i, x in enumerate(jax.tree.leaves(jp))}
    rng = np.random.default_rng(seed)
    v = jcfg.vocab_size
    for r in range(2):
        out[f"{name}_r{r}_tokens"] = rng.integers(0, v, (b, S)).astype(
            np.int32)
        out[f"{name}_r{r}_labels"] = rng.integers(-1, v, (b, S)).astype(
            np.int32)
        out[f"{name}_r{r}_weight"] = rng.uniform(0.5, 4.0, b).astype(
            np.float32)
    if jcfg.frontend is not None:
        f = jcfg.frontend
        out[f"{name}_frontend"] = rng.standard_normal(
            (b, f.seq_len, f.feature_dim)).astype(np.float32)
    return out


def _params(cfg, data, name):
    tmpl = _template(cfg)
    flat = [data[f"{name}_p{i}"] for i in range(len(leaves(tmpl)))]
    return tmpl, unflatten_like(tmpl, flat)


def _batch(data, name, r):
    bt = {k: torch.from_numpy(np.array(data[f"{name}_r{r}_{k}"]))
          for k in ("tokens", "labels", "weight")}
    if f"{name}_frontend" in data:
        bt["frontend"] = torch.from_numpy(np.array(data[f"{name}_frontend"]))
    return bt


def _train(cfg, p, data, name, mesh=None):
    m = tree_map(torch.zeros_like, p)
    fn, _ = steps.make_fl_train_step(
        cfg, InputShape("t", seq_len=S, global_batch=CASES[name][2],
                        kind="train"), mesh=mesh, lr=1e-2,
        dtype=torch.float32)
    losses = []
    for r in range(2):
        p, m, loss, _ = fn(p, m, _batch(data, name, r))
        losses.append(float(loss))
    return losses, p, m


def _serve(cfg, p, data, name, mesh=None):
    b = CASES[name][2]
    pf, _ = steps.make_prefill_step(
        cfg, InputShape("s", seq_len=SERVE_LEN, global_batch=b,
                        kind="prefill"), mesh=mesh, dtype=torch.float32)
    sv, _ = steps.make_serve_step(
        cfg, InputShape("d", seq_len=SERVE_LEN, global_batch=b,
                        kind="decode"), mesh=mesh, dtype=torch.float32)
    bt = _batch(data, name, 0)
    logits, cache = pf(p, bt["tokens"], *(
        [bt["frontend"]] if "frontend" in bt else []))
    outs = [logits]
    tok = logits.argmax(-1).to(torch.int32)
    for i in range(DECODE_STEPS):
        logits, cache = sv(p, cache, tok, S + i)
        outs.append(logits)
        tok = logits.argmax(-1).to(torch.int32)
    return _np(torch.stack(outs))


def _rank_steps(cm, inputs_path):
    """Every case's train and serve steps on its mesh of this group."""
    from torch.distributed.tensor import Shard
    data = np.load(inputs_path)
    out = {}
    for name, (_, shape, _, train) in CASES.items():
        mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
        cfg = _cfg(name)
        out[name] = {}
        if train:
            tmpl, p = _params(cfg, data, name)
            p = params_to_mesh(p, mesh, steps.train_step_rules(), "cpu",
                               template=tmpl)
            split = sum(isinstance(x.placements[1], Shard)
                        for x in leaves(p))
            losses, p, m = _train(cfg, p, data, name, mesh)
            out[name] = dict(
                losses=losses, split_on_model=split,
                digests=_replicated_digests(p) + _replicated_digests(m),
                params=leaves(params_from_mesh(p)),
                momentum=leaves(params_from_mesh(m)))
        tmpl, p = _params(cfg, data, name)
        p = params_from_numpy(p, "cpu", template=tmpl)
        out[name]["logits"] = _serve(cfg, p, data, name, mesh)
    return out


@pytest.fixture(scope="module")
def unfit_runs(tmp_path_factory):
    """(inputs, the reference's mesh results, each rank's results): the
    reference runs in a subprocess on 6 XLA devices while the port's 6
    gloo ranks run."""
    tmp = tmp_path_factory.mktemp("unfit")
    data = {}
    for i, name in enumerate(CASES):
        data.update(_inputs(name, seed=80 + i))
    in_path, ref_path = tmp / "inputs.npz", tmp / "reference.npz"
    np.savez(in_path, **data)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_STEPS, str(in_path),
         json.dumps([CASES, D_MODEL, LAYERS, S]), str(ref_path)],
        env=_env(RANKS), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ranks = mesh_mod.run_ranks(_rank_steps, RANKS, device="cpu",
                                   init_file=str(tmp / "rendezvous"),
                                   args=(str(in_path),))
    finally:
        _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    return data, dict(np.load(ref_path)), ranks


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_heads_fit_the_model_axis_only_where_meant(unfit_runs, name):
    """The premise: 4 heads on 3 ranks, while weights split on "model";
    on the (3, 2) mesh the heads divide."""
    _, _, ranks = unfit_runs
    cfg, model = _cfg(name), CASES[name][1][1]
    fits = cfg.n_heads % model == 0 and cfg.n_kv_heads % model == 0
    assert fits == (name == "seamless_heads_fit")
    if not fits:
        assert cfg.n_heads % model and cfg.n_kv_heads % model
        assert ranks[0][name]["split_on_model"] > 0


@pytest.mark.parametrize("name", TRAIN)
def test_unfit_train_step_matches_reference_and_one_device(unfit_runs, name):
    data, ref, ranks = unfit_runs
    got = ranks[0][name]
    n = len(got["params"])
    for r in range(2):
        assert _rel(got["losses"][r], ref[f"{name}_loss{r}"]) <= MODULE_TOL
    _close_leaves(got["params"], [ref[f"{name}_p{i}"] for i in range(n)],
                  MODEL_TOL, f"{name} params vs reference")
    _close_leaves(got["momentum"], [ref[f"{name}_m{i}"] for i in range(n)],
                  MODEL_TOL, f"{name} momentum vs reference")
    cfg = _cfg(name)
    tmpl, p = _params(cfg, data, name)
    losses, p1, m1 = _train(cfg, params_from_numpy(p, "cpu", template=tmpl),
                            data, name)
    for r in range(2):
        assert _rel(got["losses"][r], losses[r]) <= MODULE_TOL
    _close_leaves(got["params"], [_np(x) for x in leaves(p1)], MODEL_TOL,
                  f"{name} params vs 1 dev")
    _close_leaves(got["momentum"], [_np(x) for x in leaves(m1)], MODEL_TOL,
                  f"{name} momentum vs 1 dev")


@pytest.mark.parametrize("name", TRAIN)
def test_unfit_replicated_leaves_are_bitwise_equal_on_every_rank(unfit_runs,
                                                                 name):
    _, _, ranks = unfit_runs
    digests = [rk[name]["digests"] for rk in ranks]
    assert digests[0] and all(d == digests[0] for d in digests[1:])
    assert all(rk[name]["losses"] == ranks[0][name]["losses"]
               for rk in ranks)


@pytest.mark.parametrize("name", sorted(CASES))
def test_unfit_prefill_and_serve_match_reference_and_one_device(unfit_runs,
                                                                name):
    """The prompt's last logits and 4 greedy decode steps."""
    data, ref, ranks = unfit_runs
    got = ranks[0][name]["logits"]
    want = ref[f"{name}_logits"]
    assert got.shape == want.shape == (DECODE_STEPS + 1, CASES[name][2],
                                       got.shape[-1])
    cfg = _cfg(name)
    tmpl, p = _params(cfg, data, name)
    one = _serve(cfg, params_from_numpy(p, "cpu", template=tmpl), data, name)
    for i in range(DECODE_STEPS + 1):
        assert _rel(got[i], want[i]) <= MODEL_TOL, (name, i)
        assert _rel(got[i], one[i]) <= MODEL_TOL, (name, i)
    assert all(np.array_equal(rk[name]["logits"], got) for rk in ranks)
