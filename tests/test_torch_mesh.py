"""The port's LM steps on ``("data", "model")`` device meshes, on the CPU.

``repro_torch.sharding`` against ``repro.sharding`` and the mesh steps
against the reference's, on the same numpy inputs (the reference's
``init_params`` carried across):
  * specs: ``param_specs`` of all ten configs, stacked and not, under the
    train and decode rules (both ``multi_pod``, both ``shard_seq``), and
    ``cache_specs`` of each config's prefill cache equal the reference's;
    the seven cases of ``tests/test_sharding.py``;
  * the production meshes: on a ``fake`` process group of 256 and of 512
    ranks, every gemma2-2b and dbrx-132b param's local shape and global
    offset at ranks 0, 17 and the last equal the reference's
    ``NamedSharding(..., fit_spec(...)).devices_indices_map`` on 256/512
    XLA host devices (one subprocess each side for both sizes);
  * ``moe_ffn_hierarchical`` at rows 1, 4 and 16 with capacity drops, and
    both fallbacks to the dense path, against the reference's function;
  * the train step on a (2, 2) mesh of 4 gloo ranks (``run_ranks``) for
    gemma2-2b (also with ``quantize_comm``), recurrentgemma-9b (its MQA
    replicated on "model"; ``microbatches=2``) and dbrx-132b with the
    hierarchical MoE, 2 rounds: loss within 1e-5 and params and momentum
    within MODEL_TOL of the reference's mesh step on 4 XLA CPU devices (a
    subprocess) and of the port's one-device step; every replicated leaf
    bitwise the same on all ranks;
  * prefill and 4 decode steps on the (2, 2) mesh for gemma2-2b (also at
    B=1 < data, where the cache's sequence is split) and recurrentgemma-9b,
    and dbrx-132b with ``resident_experts``: logits within MODEL_TOL of the
    reference's mesh steps;
  * ``launch.distributed_fl --mesh 4x2`` under ``torchrun`` (8 gloo ranks)
    prints the reference example's 3 losses within 1e-5, from its params
    and batches (``--inputs``); ``train --mode mesh`` reaches it.

The reference's mesh path runs with Auto mesh axes: under this JAX
``jax.make_mesh`` makes Explicit ones, which the reference's
``with_sharding_constraint`` refuses; ``jax.sharding.Mesh`` makes Auto ones
(the reference package is not changed).  The rank functions import no
JAX.
"""

import contextlib
import functools
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import ARCH_NAMES, get_config, reduced  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import ffn, stacked  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.sharding.ctx import PartitionSpec as P  # noqa: E402
from repro_torch.tree import leaves, tree_map, unflatten_like  # noqa: E402
from repro_torch.weights import (params_from_mesh,  # noqa: E402
                                 params_from_numpy, params_to_mesh)

REPO = Path(__file__).resolve().parents[1]
MODULE_TOL = 1e-5
MODEL_TOL = 1e-4
GEMMA, RG, DBRX = "gemma2-2b", "recurrentgemma-9b", "dbrx-132b"
B, S = 8, 64
SERVE_LEN, DECODE_STEPS = S + 8, 4
# XLA's cheapest compile for the reference's runs (the same functions)
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}

# name: (arch, layers, step kwargs)
TRAIN_CASES = {
    "gemma2": (GEMMA, 2, {}),
    "gemma2_int8": (GEMMA, 2, {"quantize_comm": True}),
    "recurrentgemma_micro2": (RG, 3, {"microbatches": 2}),
    "dbrx_hierarchical": (DBRX, 2, {"moe_mode": "hierarchical"}),
}
# name: (arch, layers, batch, serve kwargs)
SERVE_CASES = {
    "gemma2": (GEMMA, 2, 4, {}),
    "gemma2_b1": (GEMMA, 2, 1, {}),
    "recurrentgemma": (RG, 3, 4, {}),
    "dbrx_resident": (DBRX, 2, 4, {"resident_experts": True}),
}


def _env(devices: int) -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")


def _spec_leaves(tree) -> list:
    """A spec tree's PartitionSpecs as tuples, in ``jax.tree.leaves``
    order (dict keys sorted)."""
    if isinstance(tree, P):
        return [tuple(tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _spec_leaves(item)]
    return [tree]


def _jspec_leaves(tree) -> list:
    import jax
    from jax.sharding import PartitionSpec as JP
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _rules():
    """(name, port rules, reference rules) for every table."""
    from repro.sharding import specs as jsh
    out = []
    for mp in (False, True):
        out.append((f"train_mp{mp}", sh.train_rules(mp), jsh.train_rules(mp)))
        for ss in (False, True):
            out.append((f"decode_mp{mp}_seq{ss}",
                        sh.decode_rules(mp, shard_seq=ss),
                        jsh.decode_rules(mp, shard_seq=ss)))
    return out


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_the_reference(arch):
    """Every leaf's spec, full config, per-layer and stacked layouts, under
    every rule table."""
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.launch import steps as jsteps
    from repro.sharding import specs as jsh
    cfg, jcfg = get_config(arch), jget_config(arch)
    for stack in (False, True):
        port = steps.param_struct(cfg, torch.float32, stacked=stack)
        ref = jsteps.param_struct(jcfg, jnp.float32, stacked=stack)
        assert [tuple(x.shape) for x in leaves(port)] == \
            [tuple(x.shape) for x in __import__("jax").tree.leaves(ref)]
        for name, rules, jrules in _rules():
            assert rules == jrules, name
            got = _spec_leaves(sh.param_specs(port, rules))
            want = _jspec_leaves(jsh.param_specs(ref, jrules))
            assert got == want, (arch, stack, name)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_equal_the_reference(arch):
    """The stacked prefill cache (B=2, 64 positions) under every rule
    table."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models import stacked as jstacked
    from repro.sharding import specs as jsh
    cfg, jcfg = get_config(arch), jget_config(arch)
    port = stacked.init_cache_stacked(cfg, 2, 64, dtype=torch.float32,
                                      device="meta")
    ref = jax.eval_shape(lambda: jstacked.init_cache_stacked(
        jcfg, 2, 64, dtype=jnp.float32))
    for name, rules, jrules in _rules():
        got = _spec_leaves(sh.cache_specs(port, rules))
        want = _jspec_leaves(jsh.cache_specs(ref, jrules))
        assert got == want, (arch, name)


class FakeMesh:
    """Minimal mesh stand-in exposing .shape for fit_spec."""

    def __init__(self, **axes):
        self.shape = axes


def test_fit_spec_drops_non_dividing_axes():
    mesh = FakeMesh(data=16, model=16)
    assert sh.fit_spec(P("data", "model"), (32, 4), mesh) == P("data", None)
    assert sh.fit_spec(P("data",), (7,), mesh) == P(None)
    assert sh.fit_spec(P(("data", "model")), (256,), mesh) == \
        P(("data", "model"))
    # partial tuple fit: 16 divides, 256 doesn't
    assert sh.fit_spec(P(("data", "model")), (16,), mesh) == P("data")


def test_param_specs_train_rules():
    cfg = reduced(get_config("qwen2-7b"))
    struct = steps.param_struct(cfg, stacked=False)
    specs = sh.param_specs(struct, sh.train_rules(False))
    l0 = specs["layers"][0]
    assert l0["mixer"]["wq"] == P("data", "model", None)
    assert l0["ffn"]["w_gate"] == P("data", "model")
    assert l0["ffn"]["w_down"] == P("model", "data")
    assert l0["ln1"] == P()
    assert specs["embed"] == P("model", "data")


def test_param_specs_stacked_get_leading_none():
    struct = steps.param_struct(get_config(GEMMA), stacked=True)
    specs = sh.param_specs(struct, sh.train_rules(False))
    assert specs["stacked"][0]["mixer"]["wq"] == \
        P(None, "data", "model", None)


def test_moe_expert_weights_sharded_as_ep():
    struct = steps.param_struct(get_config(DBRX), stacked=True)
    specs = sh.param_specs(struct, sh.train_rules(False))
    assert specs["stacked"][0]["ffn"]["we_gate"] == \
        P(None, "model", "data", None)


def test_decode_rules_seq_shard_for_tiny_batch():
    r = sh.decode_rules(False, shard_seq=True)
    assert r["batch"] is None
    assert r["cache_seq"] == ("data", "model")
    assert sh.decode_rules(False, shard_seq=False)["cache_seq"] == "model"


def test_multipod_batch_spans_pod_and_data():
    assert sh.train_rules(True)["batch"] == ("pod", "data")


def test_logical_constraint_is_identity_outside_context():
    from repro_torch.sharding.ctx import activation_rules, logical_constraint
    x = torch.ones((4, 4))
    assert logical_constraint(x, ("batch", "embed")) is x
    # a plain tensor passes through inside a context too
    with activation_rules(FakeMesh(data=2, model=2), sh.train_rules(False)):
        assert logical_constraint(x, ("batch", "embed")) is x


def test_placements_follow_the_mesh_order():
    """A dim split over a tuple of axes is sharded on each, in the mesh's
    order (JAX's device order); a tuple out of mesh order raises; a mesh
    dim of one rank replicates."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.ctx import to_placements

    class M:
        mesh_dim_names = ("pod", "data", "model")
        mesh = np.zeros((2, 4, 2))

    class One(M):
        mesh = np.zeros((2, 1, 2))

    assert to_placements(P(("pod", "data"), None, "model"), M) == \
        (Shard(0), Shard(0), Shard(2))
    assert to_placements(P(None, "data"), M) == \
        (Replicate(), Shard(1), Replicate())
    # a one-rank mesh dim replicates: its one shard is the whole tensor
    assert to_placements(P(("pod", "data"), None, "model"), One) == \
        (Shard(0), Replicate(), Shard(2))
    with pytest.raises(ValueError, match="order"):
        to_placements(P(("data", "pod")), M)


# ---------------------------------------------------------------------------
# the production meshes: local shards against devices_indices_map
# ---------------------------------------------------------------------------

_PROD_RANKS = {256: (0, 17, 255), 512: (0, 17, 511)}

_JAX_PROD = r"""
import json, sys
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config
from repro.launch.steps import param_struct
from repro.sharding import specs as sh
runs = json.loads(sys.argv[1])
out = {}
for n, ranks in runs.items():
    n = int(n)
    mp = n == 512
    shape = (2, 16, 16) if mp else (16, 16)
    names = ("pod", "data", "model") if mp else ("data", "model")
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), names)
    flat = list(mesh.devices.flat)
    out[n] = {}
    for arch in ("gemma2-2b", "dbrx-132b"):
        struct = param_struct(get_config(arch), jnp.float32, stacked=True)
        rules = sh.train_rules(mp)
        specs = jax.tree_util.tree_leaves(
            sh.param_specs(struct, rules),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        rows = []
        for leaf, spec in zip(jax.tree.leaves(struct), specs):
            idx = NamedSharding(mesh, sh.fit_spec(spec, leaf.shape, mesh)
                                ).devices_indices_map(leaf.shape)
            row = []
            for r in ranks:
                sl = idx[flat[r]]
                row.append([[s.start or 0, (s.stop if s.stop is not None
                                            else dim) - (s.start or 0)]
                            for s, dim in zip(sl, leaf.shape)])
            rows.append(row)
        out[n][arch] = rows
print(json.dumps(out))
"""

_PORT_PROD = r"""
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.steps import param_struct
from repro_torch.sharding import specs as sh
from repro_torch.tree import leaves
runs = json.loads(sys.argv[1])
out = {}
for n, ranks in runs.items():
    n = int(n)
    mp = n == 512
    out[n] = {a: [[None] * len(ranks)
                  for _ in leaves(param_struct(get_config(a), stacked=True))]
              for a in ("gemma2-2b", "dbrx-132b")}
    for j, r in enumerate(ranks):
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=n)
        mesh = mesh_mod.make_production_mesh(multi_pod=mp, device="cpu")
        for arch in out[n]:
            struct = param_struct(get_config(arch), torch.float32,
                                  stacked=True)
            pls = []
            sh.tree_map_with_path(lambda p, x, pl: pls.append((x, pl)),
                                  struct, sh.param_shardings(
                                      struct, mesh, sh.train_rules(mp)))
            for i, x in enumerate(leaves(struct)):
                pl = [q for y, q in pls if y is x][0]
                shape, off = compute_local_shape_and_global_offset(
                    tuple(x.shape), mesh, pl)
                out[n][arch][i][j] = [[o, s] for o, s in zip(off, shape)]
        dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def production_shards():
    """{"ref"|"port": {n: {arch: rows}}}: both sides for 256 and 512 ranks,
    each in one subprocess (the reference on 512 XLA host devices, its
    256-device mesh their first 256), the two run side by side."""
    runs = json.dumps({str(n): list(r) for n, r in _PROD_RANKS.items()})
    env = _env(max(_PROD_RANKS))
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", script, runs], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, script in (("ref", _JAX_PROD), ("port", _PORT_PROD))}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("n", sorted(_PROD_RANKS))
def test_production_mesh_shards_equal_the_reference(production_shards, n):
    """Each param's local shard (offset, size per dim) at ranks 0, 17 and
    the last: the port's DTensor placements on a ``fake`` group against
    the reference's ``devices_indices_map``, gemma2-2b and dbrx-132b
    (full configs, stacked, train rules)."""
    port = production_shards["port"][str(n)]
    assert port == production_shards["ref"][str(n)]
    # the shards are real splits: the last rank's shard of some leaf
    # starts past the origin
    assert any(any(o for o, _ in row[-1]) for row in port["gemma2-2b"])


def test_production_mesh_needs_its_group():
    with pytest.raises(RuntimeError, match="256"):
        mesh_mod.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512"):
        mesh_mod.make_production_mesh(multi_pod=True, device="cpu")


# ---------------------------------------------------------------------------
# the hierarchical MoE
# ---------------------------------------------------------------------------

def _moe(e, k, f, d=64, seed=0):
    import jax
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.models import ffn as jffn
    from repro_torch.configs.base import MoEConfig
    moe, jmoe = MoEConfig(e, k, f), JMoEConfig(e, k, f)
    jp = jffn.init_moe_params(jax.random.PRNGKey(seed), d, jmoe)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return moe, jmoe, p, jp


def _rel(got, want) -> float:
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    num = np.abs(g - w).max() if w.size else 0.0
    return 0.0 if num == 0.0 else num / max(np.abs(w).max(), 1e-30)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# (rows, tokens per batch row, capacity factor): 1.25 fits or nearly, 0.25
# drops; (rows=16, 2x9 tokens) has T % rows != 0 and (rows=16, 2x40)
# T // rows = 5 < E = 8: both take the dense path
HIER_CASES = [(1, 40, 1.25), (4, 40, 1.25), (16, 64, 1.25), (4, 40, 0.25),
              (16, 256, 0.25), (16, 9, 1.25), (16, 40, 1.25)]


def _row_drops(jp, jmoe, x, rows, cf) -> int:
    """(token, slot)s over their row's capacity under the reference's
    router."""
    import jax
    import jax.numpy as jnp
    from repro.models import ffn as jffn
    t = x.shape[0] * x.shape[1]
    e, k = jmoe.n_experts, jmoe.top_k
    ids = np.asarray(jax.jit(lambda p_, x_: jffn._route(p_, x_, jmoe)[1])(
        jp, jnp.asarray(x.reshape(t, -1)))).reshape(rows, -1)
    cap = int(max(1, cf * (t // rows) * k / e))
    cap = (cap + 7) // 8 * 8
    return int(sum(np.maximum(np.bincount(r, minlength=e) - cap, 0).sum()
                   for r in ids))


@pytest.mark.parametrize("rows,s,cf", HIER_CASES)
def test_moe_ffn_hierarchical_matches_reference(rows, s, cf):
    """y, aux and the gradients of x and of every weight within 1e-5 of
    the reference's ``jax.vjp``."""
    import jax
    import jax.numpy as jnp
    from repro.models import ffn as jffn
    e = 8 if (rows, s) == (16, 40) else 4
    moe, jmoe, p, jp = _moe(e, 2, 48, seed=rows + s)
    rng = np.random.default_rng(rows * 100 + s)
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    r = rng.standard_normal((2, s, 64)).astype(np.float32)
    t = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = ffn.moe_ffn_hierarchical(t, tx, moe, "silu", rows=rows,
                                      capacity_factor=cf)

    def f(params, xx):
        return jffn.moe_ffn_hierarchical(params, xx, jmoe, "silu",
                                         rows=rows, capacity_factor=cf)

    def value_and_vjp(params, xx, rr):
        out, vjp = jax.vjp(f, params, xx)
        return out, vjp((rr, jnp.asarray(3.0, jnp.float32)))

    # one compiled call (op by op, JAX compiles every op of the vjp)
    (jy, jaux), (jg, jgx) = jax.jit(value_and_vjp).lower(
        jp, jnp.asarray(x), jnp.asarray(r)).compile(
        compiler_options=FAST_XLA)(jp, jnp.asarray(x), jnp.asarray(r))
    assert _rel(_np(y), jy) <= MODULE_TOL
    # the router's means sum in XLA's order: 1 ulp apart at some rows
    assert _rel(_np(aux), jaux) <= MODULE_TOL
    (y * torch.from_numpy(r)).sum().add(aux * 3.0).backward()
    assert _rel(_np(tx.grad), jgx) <= MODULE_TOL
    for k in p:
        assert _rel(_np(t[k].grad), jg[k]) <= MODULE_TOL, k
    if (rows, s) in ((16, 9), (16, 40)):        # the dense fallback
        assert torch.equal(y, ffn.moe_ffn_dense(t, tx, moe)[0])
    if cf < 1:                                   # tokens were dropped
        assert _row_drops(jp, jmoe, x, rows, cf) > 0


def test_moe_impl_hierarchical_takes_its_rows():
    moe, _, p, _ = _moe(4, 2, 48, seed=9)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 40, 64)).astype(np.float32))
    with ffn.moe_impl("hierarchical", rows=4):
        assert ffn.current_moe_impl() == ("hierarchical", 4)
        y = ffn.moe_ffn(p, x, moe)[0]
    assert torch.equal(y, ffn.moe_ffn_hierarchical(p, x, moe, rows=4)[0])
    assert ffn.current_moe_impl() == ("dispatch", 16)


# ---------------------------------------------------------------------------
# the mesh steps: inputs, the reference's mesh run, the port's ranks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_init(arch, layers, key):
    """The reference's stacked init params of the reduced config, as numpy
    leaves (cases of one config and key share them)."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import lm as jlm
    from repro.models import stacked as jstacked
    jcfg = jreduced(jget_config(arch), n_layers=layers)
    jp = jstacked.stack_params(jlm.init_params(jcfg, jax.random.PRNGKey(key)),
                               jcfg)
    return jcfg.vocab_size, [np.asarray(x) for x in jax.tree.leaves(jp)]


def _train_inputs(arch, layers, seed):
    """The reference's stacked init params and 2 rounds' batches."""
    vocab, flat = _reference_init(arch, layers, 0)
    rng = np.random.default_rng(seed)
    batches = [{"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
                "labels": rng.integers(-1, vocab, (B, S)).astype(np.int32),
                "weight": rng.uniform(0.5, 4.0, B).astype(np.float32)}
               for _ in range(2)]
    return flat, batches


def _serve_inputs(arch, layers, b, seed):
    vocab, flat = _reference_init(arch, layers, 1)
    toks = np.random.default_rng(seed).integers(
        0, vocab, (b, S)).astype(np.int32)
    return flat, toks


# the dispatch MoE on the mesh: E=4, top-2, d=64, f=48, 8 x 16 tokens at
# capacity factor 0.5 (its queues run over all 128 tokens and drop some)
MOE_DISPATCH = dict(e=4, k=2, d=64, f=48, b=8, s=16, cf=0.5)
MOE_KEYS = ("router", "we_gate", "we_up", "we_down")


def _moe_dispatch_inputs(seed=70) -> dict:
    c = MOE_DISPATCH
    rng = np.random.default_rng(seed)
    shapes = {"router": (c["d"], c["e"]), "we_gate": (c["e"], c["d"], c["f"]),
              "we_up": (c["e"], c["d"], c["f"]),
              "we_down": (c["e"], c["f"], c["d"]),
              "x": (c["b"], c["s"], c["d"]), "r": (c["b"], c["s"], c["d"])}
    return {f"moe_{k}": (rng.standard_normal(v) * (0.2 if k[0] == "w" or
                                                   k == "router" else 1.0)
                         ).astype(np.float32) for k, v in shapes.items()}


def _moe_dispatch(data, mesh=None) -> dict:
    """y, aux and every gradient of ``moe_ffn_dispatch`` on the inputs,
    on one device or with params and x placed on ``mesh`` under the train
    rules."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.sharding.ctx import activation_rules
    c = MOE_DISPATCH
    moe = MoEConfig(c["e"], c["k"], c["f"])
    t = {k: torch.from_numpy(np.array(data[f"moe_{k}"]))
         for k in MOE_KEYS + ("x", "r")}
    p, x, r = {k: t[k] for k in MOE_KEYS}, t["x"], t["r"]
    ctx = contextlib.nullcontext()
    if mesh is not None:
        rules = steps.train_step_rules()
        p = sh.place_params(p, mesh, rules)
        x, r = (sh.place_batch(v, mesh, rules) for v in (x, r))
        ctx = activation_rules(mesh, rules)
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    x.requires_grad_(True)
    with ctx:
        y, aux = ffn.moe_ffn_dispatch(p, x, moe, capacity_factor=c["cf"])
        ((y * r).sum() + aux * 3.0).backward()
    whole = sh.gather_tree
    out = {"y": y, "aux": aux, "gx": x.grad,
           **{f"g_{k}": p[k].grad for k in MOE_KEYS}}
    out = {k: _np(v) for k, v in whole(out).items()}
    if mesh is not None:       # the experts stayed split on "model"
        out["expert_placements"] = [repr(pl) for pl in p["we_gate"].placements]
    return out


_JAX_STEPS = r"""
import json, sys
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config, reduced
from repro.configs.shapes import InputShape
from repro.launch import steps
from repro.models import lm, stacked
assert jax.device_count() == 4
train, serve = json.loads(sys.argv[2]), json.loads(sys.argv[3])
data = np.load(sys.argv[1])
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
fast = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
out = {}


def tree(cfg, prefix, seed):
    t = jax.eval_shape(lambda: stacked.stack_params(
        lm.init_params(cfg, jax.random.PRNGKey(seed)), cfg))
    flat = [jnp.asarray(data[f"{prefix}_p{i}"])
            for i in range(len(jax.tree.leaves(t)))]
    return jax.tree.unflatten(jax.tree.structure(t), flat)


for name, (arch, layers, kw) in train.items():
    cfg = reduced(get_config(arch), n_layers=layers)
    fn, _ = steps.make_fl_train_step(
        cfg, mesh, InputShape("t", seq_len=64, global_batch=8, kind="train"),
        dtype=jnp.float32, lr=1e-2, **kw)
    p = tree(cfg, name, 0)
    m = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p)
    for r in range(2):
        batch = {k: jnp.asarray(data[f"{name}_r{r}_{k}"])
                 for k in ("tokens", "labels", "weight")}
        with mesh:
            if r == 0:
                fn = fn.lower(p, m, batch).compile(compiler_options=fast)
            p, m, loss, _ = fn(p, m, batch)
        out[f"{name}_loss{r}"] = np.asarray(loss)
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"{name}_p{i}"] = np.asarray(x)
    for i, x in enumerate(jax.tree.leaves(m)):
        out[f"{name}_m{i}"] = np.asarray(x)

for name, (arch, layers, b, kw) in serve.items():
    cfg = reduced(get_config(arch), n_layers=layers)
    shape = InputShape("s", seq_len=72, global_batch=b, kind="prefill")
    pf, _ = steps.make_prefill_step(cfg, mesh, shape, dtype=jnp.float32)
    sv, _ = steps.make_serve_step(
        cfg, mesh, InputShape("d", seq_len=72, global_batch=b,
                              kind="decode"), dtype=jnp.float32, **kw)
    p = tree(cfg, "s_" + name, 1)
    toks = jnp.asarray(data[f"s_{name}_tokens"])
    with mesh:
        pf = pf.lower(p, toks).compile(compiler_options=fast)
        logits, cache = pf(p, toks)
        outs = [np.asarray(logits)]
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for i in range(4):
            # the host copy lets the step place the cache by its own
            # in_shardings (its outputs come out placed otherwise)
            if i == 0:
                sv = sv.lower(p, jax.device_get(cache), tok,
                              jnp.int32(64)).compile(
                    compiler_options=fast)
            logits, cache = sv(p, jax.device_get(cache), tok,
                               jnp.int32(64 + i))
            outs.append(np.asarray(logits))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out[f"{name}_logits"] = np.stack(outs)
np.savez(sys.argv[4], **out)
"""


def _port_cfg(arch, layers):
    return reduced(get_config(arch), n_layers=layers)


def _template(cfg, seed=0):
    from repro_torch.models import build_model
    return stacked.stack_params(build_model(cfg).init(seed, "cpu"), cfg)


def _replicated_digests(tree) -> list:
    """A digest of each replicated DTensor leaf's bits on this rank."""
    from torch.distributed.tensor import Replicate
    out = []
    for x in leaves(tree):
        if all(isinstance(p, Replicate) for p in x.placements):
            out.append(hashlib.sha256(
                x.to_local().detach().contiguous().numpy().tobytes()
            ).hexdigest())
    return out


def _rank_steps(cm, inputs_path):
    """Every train and serve case on a (2, 2) mesh of this group."""
    data = np.load(inputs_path)
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for name, (arch, layers, kw) in TRAIN_CASES.items():
        cfg = _port_cfg(arch, layers)
        tmpl = _template(cfg)
        n = len(leaves(tmpl))
        p = params_to_mesh(unflatten_like(
            tmpl, [data[f"{name}_p{i}"] for i in range(n)]), mesh,
            steps.train_step_rules(), "cpu", template=tmpl)
        m = tree_map(torch.zeros_like, p)
        fn, _ = steps.make_fl_train_step(
            cfg, InputShape("t", seq_len=S, global_batch=B, kind="train"),
            mesh=mesh, lr=1e-2, dtype=torch.float32, **kw)
        losses = []
        for r in range(2):
            batch = {k: torch.from_numpy(np.array(data[f"{name}_r{r}_{k}"]))
                     for k in ("tokens", "labels", "weight")}
            p, m, loss, _ = fn(p, m, batch)
            losses.append(float(loss))
        out[name] = dict(
            losses=losses, digests=_replicated_digests(p) +
            _replicated_digests(m),
            params=leaves(params_from_mesh(p)),
            momentum=leaves(params_from_mesh(m)))
    for name, (arch, layers, b, kw) in SERVE_CASES.items():
        cfg = _port_cfg(arch, layers)
        tmpl = _template(cfg, 1)
        n = len(leaves(tmpl))
        p = params_from_numpy(unflatten_like(
            tmpl, [data[f"s_{name}_p{i}"] for i in range(n)]), "cpu",
            template=tmpl)
        out[f"serve_{name}"] = _np(_serve(
            cfg, p, b, kw, mesh,
            torch.from_numpy(np.array(data[f"s_{name}_tokens"]))))
    out["moe_dispatch"] = _moe_dispatch(data, mesh)
    return out


def _serve(cfg, p, b, kw, mesh, toks):
    pf, _ = steps.make_prefill_step(
        cfg, InputShape("s", seq_len=SERVE_LEN, global_batch=b,
                        kind="prefill"), mesh=mesh, dtype=torch.float32)
    sv, _ = steps.make_serve_step(
        cfg, InputShape("d", seq_len=SERVE_LEN, global_batch=b,
                        kind="decode"), mesh=mesh, dtype=torch.float32, **kw)
    logits, cache = pf(p, toks)
    outs = [logits]
    tok = logits.argmax(-1).to(torch.int32)
    for i in range(DECODE_STEPS):
        logits, cache = sv(p, cache, tok, S + i)
        outs.append(logits)
        tok = logits.argmax(-1).to(torch.int32)
    return torch.stack(outs)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """(inputs, the reference's mesh results, each rank's results): the
    reference runs in a subprocess on 4 XLA devices while the port's 4
    gloo ranks run."""
    tmp = tmp_path_factory.mktemp("mesh")
    inputs, arrays = {}, {}
    for i, (name, (arch, layers, _)) in enumerate(TRAIN_CASES.items()):
        flat, batches = _train_inputs(arch, layers, seed=40 + i)
        inputs[name] = (flat, batches)
        arrays.update({f"{name}_p{j}": x for j, x in enumerate(flat)})
        for r, bt in enumerate(batches):
            arrays.update({f"{name}_r{r}_{k}": v for k, v in bt.items()})
    for i, (name, (arch, layers, b, _)) in enumerate(SERVE_CASES.items()):
        flat, toks = _serve_inputs(arch, layers, b, seed=60 + i)
        arrays.update({f"s_{name}_p{j}": x for j, x in enumerate(flat)})
        arrays[f"s_{name}_tokens"] = toks
    arrays.update(_moe_dispatch_inputs())
    in_path, ref_path = tmp / "inputs.npz", tmp / "reference.npz"
    np.savez(in_path, **arrays)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_STEPS, str(in_path),
         json.dumps(TRAIN_CASES), json.dumps(SERVE_CASES), str(ref_path)],
        env=_env(4), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ranks = mesh_mod.run_ranks(_rank_steps, 4, device="cpu",
                                   init_file=str(tmp / "rendezvous"),
                                   args=(str(in_path),))
    finally:
        _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    return inputs, dict(np.load(ref_path)), ranks


def _close_leaves(got, want, tol, what):
    assert len(got) == len(want), what
    top = max(np.abs(np.asarray(w)).max() for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        if np.abs(np.asarray(w)).max() <= 1e-6 * top:   # zero by the maths
            assert np.abs(g).max() <= 1e-6 * top, f"{what}: leaf {i}"
        else:
            assert _rel(g, w) <= tol, f"{what}: leaf {i} off by {_rel(g, w)}"


def _one_device_train(name, flat, batches):
    arch, layers, kw = TRAIN_CASES[name]
    cfg = _port_cfg(arch, layers)
    tmpl = _template(cfg)
    p = params_from_numpy(unflatten_like(tmpl, flat), "cpu", template=tmpl)
    m = tree_map(torch.zeros_like, p)
    fn, _ = steps.make_fl_train_step(
        cfg, InputShape("t", seq_len=S, global_batch=B, kind="train"),
        lr=1e-2, dtype=torch.float32, **kw)
    losses = []
    for bt in batches:
        p, m, loss, _ = fn(p, m, {k: torch.from_numpy(v)
                                  for k, v in bt.items()})
        losses.append(float(loss))
    return losses, [_np(x) for x in leaves(p)], [_np(x) for x in leaves(m)]


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_mesh_train_step_matches_reference_and_one_device(mesh_runs, name):
    inputs, ref, ranks = mesh_runs
    got = ranks[0][name]
    n = len(got["params"])
    for r in range(2):
        assert _rel(got["losses"][r], ref[f"{name}_loss{r}"]) <= MODULE_TOL
    _close_leaves(got["params"], [ref[f"{name}_p{i}"] for i in range(n)],
                  MODEL_TOL, f"{name} params vs reference")
    _close_leaves(got["momentum"], [ref[f"{name}_m{i}"] for i in range(n)],
                  MODEL_TOL, f"{name} momentum vs reference")
    if TRAIN_CASES[name][2].get("moe_mode") == "hierarchical":
        # its rows are the mesh's 2 data shards here and 16 on one device
        # (the reference's rule): another function, pinned above
        return
    losses, p1, m1 = _one_device_train(name, *inputs[name])
    for r in range(2):
        assert _rel(got["losses"][r], losses[r]) <= MODULE_TOL
    _close_leaves(got["params"], p1, MODEL_TOL, f"{name} params vs 1 dev")
    _close_leaves(got["momentum"], m1, MODEL_TOL, f"{name} momentum vs 1 dev")


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_replicated_leaves_are_bitwise_equal_on_every_rank(mesh_runs, name):
    _, _, ranks = mesh_runs
    digests = [rk[name]["digests"] for rk in ranks]
    assert digests[0] and all(d == digests[0] for d in digests[1:])
    assert all(rk[name]["losses"] == ranks[0][name]["losses"]
               for rk in ranks)


@pytest.mark.parametrize("name", sorted(SERVE_CASES))
def test_mesh_prefill_and_serve_match_reference(mesh_runs, name):
    """The prompt's last logits and 4 greedy decode steps."""
    _, ref, ranks = mesh_runs
    got = ranks[0][f"serve_{name}"]
    want = ref[f"{name}_logits"]
    assert got.shape == want.shape == (DECODE_STEPS + 1,
                                       SERVE_CASES[name][2], got.shape[-1])
    for i in range(DECODE_STEPS + 1):
        assert _rel(got[i], want[i]) <= MODEL_TOL, (name, i)
    assert all(np.array_equal(rk[f"serve_{name}"], got) for rk in ranks)


def test_mesh_moe_dispatch_matches_one_device(mesh_runs):
    """The dispatch MoE on the (2, 2) mesh (all tokens' queues on every
    rank, each rank's own experts' products) against one device: y, aux
    and every gradient within 1e-5, with tokens dropped, the expert
    weights left split on "model"."""
    _, _, ranks = mesh_runs
    got = ranks[0]["moe_dispatch"]
    data = _moe_dispatch_inputs()
    want = _moe_dispatch(data)
    for k, w in want.items():
        assert _rel(got[k], w) <= MODULE_TOL, k
    assert got["expert_placements"][1] == "Shard(dim=0)"
    c = MOE_DISPATCH
    cap = (int(c["cf"] * c["b"] * c["s"] * c["k"] / c["e"]) + 7) // 8 * 8
    ids = torch.from_numpy(data["moe_x"]).reshape(-1, c["d"]) @ \
        torch.from_numpy(data["moe_router"])
    top = torch.sort(torch.softmax(ids, -1), dim=-1, descending=True,
                     stable=True).indices[:, :c["k"]]
    assert int(torch.bincount(top.reshape(-1), minlength=c["e"]).max()) > cap


def test_mesh_step_rules():
    """The serve step splits the cache's sequence when the batch is smaller
    than its shards, and ``resident_experts`` moves the experts' d_ff dim
    onto "data" (the reference's rules)."""

    class M:
        mesh_dim_names = ("pod", "data", "model")
        mesh = np.zeros((2, 4, 2))

    assert steps.batch_rows(M) == 8
    r = steps.serve_step_rules(M, 4, multi_pod=True)
    assert r["batch"] is None and r["cache_seq"] == ("pod", "data", "model")
    r = steps.serve_step_rules(M, 8, multi_pod=True, resident_experts=True)
    assert r["cache_seq"] == "model" and r["batch"] == ("pod", "data")
    assert r["residual"] is None and r["moe_inner"] == "data"
    assert steps.train_step_rules(seq_parallel=False)["seq"] is None
    assert steps.prefill_step_rules()["batch"] == "data"


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_JAX_EXAMPLE = r"""
import functools, runpy, sys
import jax, numpy as np
from jax.sharding import Mesh
import repro.launch.steps as steps
out = {}


def auto_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def recording(make):
    def make_step(*a, **kw):
        fn, structs = make(*a, **kw)

        def step(params, momentum, batch):
            r = sum(k.startswith("loss") for k in out)
            if r == 0:
                for i, x in enumerate(jax.tree.leaves(params)):
                    out[f"p{i}"] = np.asarray(x)
            for k, v in batch.items():
                out[f"r{r}_{k}"] = np.asarray(v)
            res = fn(params, momentum, batch)
            out[f"loss{r}"] = np.asarray(res[2])
            return res
        return step, structs
    return make_step


jax.make_mesh = auto_mesh
steps.make_fl_train_step = recording(steps.make_fl_train_step)
sys.argv = ["distributed_fl", "--arch", "gemma2-2b"]
runpy.run_path(EXAMPLE, run_name="__main__")
np.savez(OUT, **out)
"""


def test_launcher_on_a_4x2_mesh_matches_the_reference_example(tmp_path):
    """``examples/distributed_fl.py`` as it is (Auto mesh axes, its step
    wrapped to record its inputs and full-precision losses) against
    ``torchrun --nproc-per-node 8 -m repro_torch.launch.distributed_fl
    --mesh 4x2 --device cpu --inputs`` of those inputs."""
    ref = tmp_path / "example.npz"
    script = (_JAX_EXAMPLE.replace("EXAMPLE", repr(str(
        REPO / "examples" / "distributed_fl.py"))).replace(
        "OUT", repr(str(ref))))
    env = _env(8)
    env["XLA_FLAGS"] += "".join(f" --{k}={str(v).lower()}"
                                for k, v in FAST_XLA.items())
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(ref)
    assert [k for k in want.files if k.startswith("loss")] == \
        ["loss0", "loss1", "loss2"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m", "repro_torch.launch.distributed_fl",
         "--arch", GEMMA, "--mesh", "4x2", "--device", "cpu",
         "--inputs", str(ref)], env=env, capture_output=True, text=True,
        timeout=900, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if "weighted FL loss=" in ln]
    assert len(lines) == 3, proc.stdout      # rank 0 alone prints
    assert "mesh 4x2" in proc.stdout
    for r, ln in enumerate(lines):
        loss = float(ln.split("loss=")[1].split()[0])
        assert abs(loss - float(want[f"loss{r}"])) <= MODULE_TOL * max(
            1.0, abs(float(want[f"loss{r}"]))), (r, loss)


def test_train_mode_mesh_reaches_the_launcher(capsys):
    from repro_torch.launch import distributed_fl
    from repro_torch.launch import train as t_train
    t_train.main(["--mode", "mesh", "--arch", RG, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "federated LM round executed" in out and f"arch={RG}" in out
    distributed_fl.main(["--arch", RG, "--device", "cpu"])
    again = capsys.readouterr().out
    pick = [ln.split("loss=")[1].split()[0] for ln in out.splitlines()
            if "loss=" in ln]
    assert len(pick) == 3 and pick == [
        ln.split("loss=")[1].split()[0] for ln in again.splitlines()
        if "loss=" in ln]
