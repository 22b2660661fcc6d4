"""The port's per-rank analysis of a step (``repro_torch.roofline.analysis``)
against the reference's analysis of a compiled program
(``repro.roofline.analysis``) and against hand counts.

  * ``RooflineReport`` fed the reference's numbers gives its terms,
    bottleneck, useful ratio, row and JSON keys;
  * a row-sharded matmul on a ``fake`` 4-rank group counts the rank's
    local product only (a DTensor op and the local op it runs are one
    op), and the same product jitted over 4 XLA CPU devices gives the
    reference's ``analyze_compiled`` the same dot FLOPs, bytes and
    all-gather bytes;
  * a column- then row-parallel MLP's collectives, kinds, counts and
    bytes, equal a hand count; so do the peak, output, alias and temp
    bytes of a small program that updates an argument in place;
  * one-device train and prefill steps of reduced gemma2-2b,
    recurrentgemma-9b and xlstm-350m count the same FLOPs, bytes, peak
    and memory split on ``meta`` as on the CPU: the kernel entry points
    are one op each, and the loops ``sharding.ctx.steps`` cuts on
    ``meta`` count their middle step for the steps it stands for;
  * a windowed attention core counts the kernel's formula (live pairs x
    4 D) and never holds the S x T scores;
  * the kernels' formulas (``roofline.kernels``) are those of PERF.md's
    bounds.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.roofline import analysis as j_analysis  # noqa: E402
from repro.roofline.hardware import Chip as JChip  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention, stacked  # noqa: E402
from repro_torch.roofline import analysis, kernels  # noqa: E402
from repro_torch.roofline.hardware import H100  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
F32 = 4


def _analyze(step, args, **kw):
    return analysis.analyze_traced(step, args, arch="a", shape="s", mesh="m",
                                   n_devices=kw.pop("n_devices", 1), **kw)


@pytest.fixture
def fake4():
    """A ``fake`` group of 4 ranks (this process is rank 0) and a 1-d mesh
    over it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (4,), mesh_dim_names=("d",))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("numbers", [
    (3.1e14, 2.2e12, 4.0e10, 1.6e17, 6.1e10),    # compute-bound
    (1.0e9, 9.0e12, 1.0e9, 0.0, 1.0e9),          # memory, no model FLOPs
    (1.0e9, 1.0e9, 9.0e12, 5.0e11, 0.0),         # collective
])
def test_report_equals_the_references(numbers):
    flops, hbm, coll, model_flops, peak = numbers
    breakdown = {"all-gather": coll, "counts": {"all-gather": 3}}
    kw = dict(arch="gemma2-2b", shape="train_4k", mesh="16x16",
              n_devices=256, flops=flops, hbm_bytes=hbm, coll_bytes=coll,
              coll_breakdown=breakdown, model_flops=model_flops,
              peak_memory_bytes=peak)
    got = analysis.RooflineReport(**kw).finalize(H100)
    want = j_analysis.RooflineReport(**kw).finalize(JChip(**vars(H100)))
    for name in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "useful_ratio"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.row() == want.row()
    assert json.loads(got.to_json()) == json.loads(want.to_json())


def test_collective_table_is_the_references():
    assert analysis._COLLECTIVES == j_analysis._COLLECTIVES
    assert analysis._MULT == j_analysis._MULT
    assert set(analysis._KIND.values()) == set(j_analysis._COLLECTIVES)


# ---------------------------------------------------------------------------
# local work and collectives on a fake group
# ---------------------------------------------------------------------------

M, K, N = 1024, 512, 256

_JAX_MATMUL = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.roofline.analysis import analyze_compiled
m, k, n = 1024, 512, 256
mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
fn = jax.jit(lambda x, w: x @ w,
             in_shardings=(NamedSharding(mesh, P("d", None)),
                           NamedSharding(mesh, P())),
             out_shardings=NamedSharding(mesh, P()))
compiled = fn.lower(jax.ShapeDtypeStruct((m, k), jnp.float32),
                    jax.ShapeDtypeStruct((k, n), jnp.float32)).compile()
rep = analyze_compiled(compiled, arch="mm", shape="s", mesh="4",
                       n_devices=4)
print(json.dumps({"flops": rep.flops, "hbm_bytes": rep.hbm_bytes,
                  "coll_breakdown": rep.coll_breakdown}))
"""


def _reference_matmul():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _JAX_MATMUL], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_row_sharded_matmul_counts_the_local_product(fake4, device):
    """(M, K) split on rows times a replicated (K, N), gathered whole: the
    rank's FLOPs are its own 2 (M/4) K N, not the global product's as
    well, and its one all-gather moves the (M, N) result."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = distribute_tensor(torch.ones(M, K, device=device), fake4, [Shard(0)],
                          src_data_rank=None)
    w = distribute_tensor(torch.ones(K, N, device=device), fake4,
                          [Replicate()], src_data_rank=None)
    rep, mem = _analyze(lambda a, b: (a @ b).full_tensor(), (x, w),
                        n_devices=4)
    assert rep.flops == 2 * (M // 4) * K * N
    assert rep.coll_breakdown["all-gather"] == M * N * F32
    assert rep.coll_breakdown["counts"]["all-gather"] == 1
    assert rep.coll_bytes == M * N * F32
    # the local product (its operands and result) and the gather's
    assert rep.hbm_bytes == F32 * ((M // 4) * K + K * N + (M // 4) * N) \
        + F32 * ((M // 4) * N + M * N)
    assert mem["argument_size"] == F32 * ((M // 4) * K + K * N)
    assert mem["output_size"] == F32 * M * N


def test_row_sharded_matmul_equals_the_references_compiled_program(fake4):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    want = _reference_matmul()
    x = distribute_tensor(torch.empty(M, K, device="meta"), fake4,
                          [Shard(0)], src_data_rank=None)
    w = distribute_tensor(torch.empty(K, N, device="meta"), fake4,
                          [Replicate()], src_data_rank=None)
    rep, _ = _analyze(lambda a, b: (a @ b).full_tensor(), (x, w),
                      n_devices=4)
    # the compiled program is the dot and the all-gather alone
    assert rep.flops == want["flops"]
    assert rep.hbm_bytes == want["hbm_bytes"]
    assert rep.coll_breakdown["all-gather"] == \
        want["coll_breakdown"]["all-gather"]
    assert rep.coll_breakdown["counts"] == want["coll_breakdown"]["counts"]


def test_column_then_row_parallel_mlp_collectives_by_hand(fake4):
    """x (B, E) replicated, w1 (E, F) split on columns, w2 (F, E) on rows:
    the forward leaves y's sum pending and making it whole is one
    all-reduce of (B, E); the backward leaves dx's sum over the F shards
    pending, and making it whole is one more.  Each all-reduce moves twice
    its result (``_MULT``)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    b, e, f = 8, 64, 256
    x = distribute_tensor(torch.ones(b, e, device="meta"), fake4,
                          [Replicate()], src_data_rank=None)
    w1 = distribute_tensor(torch.ones(e, f, device="meta"), fake4,
                           [Shard(1)], src_data_rank=None)
    w2 = distribute_tensor(torch.ones(f, e, device="meta"), fake4,
                           [Shard(0)], src_data_rank=None)

    def step(x, w1, w2):
        x.requires_grad_(True)
        y = ((x @ w1) @ w2).redistribute(x.device_mesh, [Replicate()])
        y.to_local().sum().backward()
        return x.grad.redistribute(x.device_mesh, [Replicate()])

    rep, _ = _analyze(step, (x, w1, w2), n_devices=4)
    counts = rep.coll_breakdown.pop("counts")
    assert counts == {"all-gather": 0, "all-reduce": 2, "reduce-scatter": 0,
                      "all-to-all": 0, "collective-permute": 0}
    assert rep.coll_breakdown["all-reduce"] == 2 * 2.0 * b * e * F32
    assert rep.coll_bytes == 4 * b * e * F32
    # the local products: 2 forward, 2 for dx and dh (w's need no grad)
    assert rep.flops == 2 * 2 * b * e * (f // 4) * 2


def test_memory_split_of_an_in_place_program_by_hand():
    """Two (n,) f32 arguments; ``a`` is updated in place, and the step
    returns it beside a fresh scalar."""
    n = 1000
    a, b = torch.ones(n), torch.ones(n)

    def step(a, b):
        t = a * 2.0             # a temporary of n
        a.add_(t)               # the argument written in place
        del t
        return a, (b * b).sum()  # another temporary of n, a scalar out

    rep, mem = _analyze(step, (a, b))
    assert mem == {"argument_size": 2 * n * F32, "output_size": F32,
                   "alias_size": n * F32,
                   # peak - argument - output + alias
                   "temp_size": 2 * n * F32}
    assert rep.peak_memory_bytes == 3 * n * F32 + F32
    assert rep.flops == 0
    # mul: n read, n written; add_: t read, a written; b * b: 2 n read, n
    # written; sum: n read, a scalar written
    assert rep.hbm_bytes == F32 * (2 * n + 2 * n + 3 * n + n + 1)


# ---------------------------------------------------------------------------
# one-device steps: meta against the CPU
# ---------------------------------------------------------------------------

# arch, layers, sequence: xlstm's 640 positions are 5 mLSTM chunks and 640
# sLSTM steps, both cut on meta
STEP_CASES = [("gemma2-2b", 2, 64), ("recurrentgemma-9b", 3, 64),
              ("xlstm-350m", 2, 640)]


def _step_args(cfg, shape, device):
    if shape.kind == "train":
        fn, structs = steps.make_fl_train_step(cfg, shape,
                                               dtype=torch.float32)
    else:
        fn, structs = steps.make_prefill_step(cfg, shape,
                                              dtype=torch.float32)
    if device == "meta":
        return fn, structs
    g = torch.Generator().manual_seed(0)
    params = stacked.init_params_stacked(cfg, g, torch.float32)
    tokens = torch.randint(0, cfg.vocab_size,
                           (shape.global_batch, shape.seq_len), generator=g,
                           dtype=torch.int32)
    if shape.kind != "train":
        return fn, (params, tokens)
    momentum = tree_map(lambda x: torch.zeros_like(x), params)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
             "weight": torch.full((shape.global_batch,), 0.5)}
    return fn, (params, momentum, batch)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: c[0])
def test_meta_counts_what_the_cpu_counts(case, kind):
    arch, layers, seq = case
    cfg = reduced(get_config(arch), n_layers=layers)
    shape = InputShape("s", seq_len=seq, global_batch=2, kind=kind)
    got = {}
    for device in ("cpu", "meta"):
        fn, args = _step_args(cfg, shape, device)
        rep, mem = _analyze(fn, args)
        got[device] = (rep.flops, rep.hbm_bytes, rep.peak_memory_bytes, mem,
                       json.loads(rep.notes)["kernels"])
    assert got["meta"] == got["cpu"]
    flops, _, peak, mem, launched = got["cpu"]
    assert flops > 0 and peak > mem["argument_size"] > 0
    # each kernel entry point is one op (a train step's forward runs twice:
    # remat recomputes it in the backward)
    mixers = [spec.mixer for spec in cfg.layers]
    if arch == "xlstm-350m":        # both cut loops
        assert set(mixers) == {"mlstm", "slstm"}
    n_attn, n_rec = mixers.count("attn"), mixers.count("rglru")
    fwd = 2 if kind == "train" else 1
    assert launched.get("flash_attention", 0) == fwd * n_attn
    assert launched.get("rglru_scan", 0) == fwd * n_rec
    if kind == "train":
        assert launched.get("flash_attention_bwd", 0) == n_attn
        assert launched.get("rglru_scan_bwd", 0) == n_rec
        assert mem["alias_size"] > 0        # params and momentum
    else:
        assert mem["alias_size"] == 0 and mem["output_size"] > 0


def test_a_cut_loop_counts_its_middle_step_for_the_rest():
    """A loop of n like steps on ``meta`` runs 3 of them and counts the
    n of the full loop; what each step keeps counts n times."""
    from repro_torch.sharding.ctx import steps as loop_steps
    n, w = 10, 32

    def step(x, wt):
        outs = []
        for i in loop_steps(n, x.device):
            outs.append(x[i] @ wt)
        outs += [outs[-1].detach() for _ in range(n - len(outs))]
        return torch.stack(outs)

    got = {}
    for device in ("cpu", "meta"):
        x, wt = torch.ones(n, w, w, device=device), torch.ones(w, w,
                                                               device=device)
        rep, mem = _analyze(step, (x, wt))
        got[device] = (rep.flops, rep.hbm_bytes, rep.peak_memory_bytes, mem)
    assert got["meta"] == got["cpu"]
    assert got["cpu"][0] == n * 2 * w ** 3
    # the args, n kept products and the stack
    assert got["cpu"][2] == F32 * (n * w * w + w * w + 2 * n * w * w)


# ---------------------------------------------------------------------------
# the attention kernel's scope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_windowed_core_counts_the_kernel_not_the_scores(device):
    b, s, kh, g, d, window = 2, 256, 2, 2, 32, 64
    q = torch.randn(b, s, kh, g, d, device=device)
    k = torch.randn(b, s, kh, d, device=device)
    v = torch.randn(b, s, kh, d, device=device)
    pos = torch.arange(s, device=device)

    def core(q, k, v):
        return attention._attend(q, k, v, pos, pos, causal=True,
                                 window=window, cap=None)

    rep, mem = _analyze(core, (q, k, v))
    h = kh * g
    assert rep.flops == 4 * d * b * h * kernels.live_pairs(s, s, True,
                                                           window)
    assert json.loads(rep.notes)["kernels"] == {"flash_attention": 1}
    args = F32 * d * (b * h * s + 2 * b * kh * s)
    scratch = kernels.attention_scratch_bytes(b, h, kh, s, s, d, esize=F32)
    scores = F32 * b * h * s * s
    # the output beside the kernel's scratch (q, k and v are read as laid
    # out: no copies)
    assert rep.peak_memory_bytes == args + F32 * b * h * s * d + scratch
    assert rep.peak_memory_bytes < args + scores
    assert mem["output_size"] == F32 * b * h * s * d


def test_the_cpu_core_outside_the_analysis_is_the_plain_path():
    """Only the analysis routes the CPU through the kernel's entry point;
    elsewhere the CPU takes the plain path, and both compute the same."""
    from repro_torch.kernels import flash_attention as fl
    torch.manual_seed(0)
    b, s, kh, g, d = 1, 64, 2, 2, 16
    q, k, v = (torch.randn(b, s, kh, g, d), torch.randn(b, s, kh, d),
               torch.randn(b, s, kh, d))
    pos = torch.arange(s)
    kw = dict(causal=True, window=16, cap=30.0)
    plain = attention._attend(q, k, v, pos, pos, **kw)
    traced = []
    _analyze(lambda *a: traced.append(attention._attend(*a, pos, pos, **kw)),
             (q, k, v))
    assert not analysis.active()
    assert torch.allclose(traced[0], plain, rtol=1e-5, atol=1e-5)
    out = fl.flash_attention(q.reshape(b, s, kh * g, d).transpose(1, 2),
                             k.transpose(1, 2), v.transpose(1, 2), **kw)
    assert out.stride() == q.reshape(b, s, kh * g, d).transpose(1, 2) \
        .stride()


# ---------------------------------------------------------------------------
# the kernels' formulas
# ---------------------------------------------------------------------------

def _pairs_by_loop(s, t, causal, window):
    total = 0
    for i in range(s):
        qk = i + t - s
        hi = min(t - 1, qk) if causal else t - 1
        lo = max(0, qk - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def test_live_pairs_in_closed_form_equals_the_loop():
    import random
    r = random.Random(0)
    cases = [(4096, 4096, True, 2048), (4000, 4000, True, 2048),
             (512, 1024, False, None), (2304, 2304, True, None),
             (1, 1, True, 1), (7, 3, True, None), (7, 3, False, 2)]
    cases += [(r.randint(1, 80), r.randint(1, 80), r.random() < 0.5,
               None if r.random() < 0.3 else r.randint(1, 90))
              for _ in range(3000)]
    for case in cases:
        assert kernels.live_pairs(*case) == _pairs_by_loop(*case), case


def test_the_kernel_formulas_are_the_bounds_of_perf_md():
    """PERF.md section 6's bound column: gemma2-2b's global layer
    (B=2, H=8, Kh=4, S=T=4096, D=256, causal) and recurrentgemma-9b's
    scan (B=2, T=4096, W=4096), as ``chip_smoke.py`` counted them inline
    before the formulas moved here."""
    b, h, kh, s, d = 2, 8, 4, 4096, 256
    pairs = _pairs_by_loop(s, s, True, None) * b * h
    for esize in (4, 2):
        fwd = kernels.attention_traffic(b, h, kh, s, s, d, causal=True,
                                        window=None, esize=esize)
        assert (fwd.flops, fwd.bytes_hbm) == \
            (4 * d * pairs, esize * d * (2 * b * h * s + 2 * b * kh * s))
        bwd = kernels.attention_traffic(b, h, kh, s, s, d, causal=True,
                                        window=None, esize=esize,
                                        backward=True)
        assert (bwd.flops, bwd.bytes_hbm) == \
            (10 * d * pairs, esize * d * (4 * b * h * s + 4 * b * kh * s)
             + 4 * b * h * s)
    n = 2 * 4096 * 4096
    assert (kernels.rglru_scan_traffic(2, 4096, 4096, esize=4).bytes_hbm,
            kernels.rglru_scan_traffic(2, 4096, 4096, esize=2).bytes_hbm,
            kernels.rglru_scan_traffic(2, 4096, 4096, esize=4,
                                       backward=True).bytes_hbm) == \
        (12 * n, 6 * n, 20 * n)
    assert kernels.fed_reduce_launch_traffic(32, 169_462, 2, quant=True) \
        .bytes_hbm == kernels.fed_reduce_traffic(
            32, 169_462, 2, quant=True).bytes_hbm + 8 * 32 + 32
    assert kernels.fed_aggregate_traffic(48, 169_462).bytes_hbm == \
        4 * (48 * 169_462 + 48 + 2 * 169_462)
