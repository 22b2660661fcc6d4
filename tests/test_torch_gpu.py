"""The port's Hopper kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where no CUDA device is present (decided in
the ``cuda`` fixture, never at import).  On a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The shapes cover every row alignment the kernels meet (N divisible by 4
and N = 1, 2 and 3 mod 4, so that packed rows start on 16-, 8- and 4-byte
boundaries, and a masked tail), a misaligned row pointer, interleaved and
empty segments, more rows than one batch in flight, more rows than a block
lists at a time (no row limit), and the int8 round trip.  ``fed_reduce``
and ``fed_aggregate`` must be bitwise equal to the plain version.
``rglru_scan`` must be bitwise equal (W not a multiple of the
block, T = 1, T not a multiple of the time chunk, both copy widths);
``flash_attention`` within rtol = atol = 2e-5 (the reference's tolerance
for its kernel) over MQA, GQA with the soft-cap, ragged and unaligned
lengths (S not a multiple of the 16-key tile at every head dim), many kv
tiles through the K/V ring, non-causal windows and the model's strided
layout.  The serving tests drive a staggered sync + async + buffered
queue through ``serve`` on the card (both kernels launch; the records keep
the CPU drain's (M, E), costs and logs) and restore a killed drain's
snapshot onto the card.  This file imports no JAX, so it runs where only
torch is.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fed_aggregate as fa_mod  # noqa: E402
from repro_torch.kernels import fed_reduce as fr_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(m, n, t, seed, dev):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, t, m).astype(np.int32)
    if t > 2:
        seg[seg == 1] = 0                              # segment 1 empty
    w = rng.uniform(1.0, 100.0, m).astype(np.float32)
    w[0] = 0.0                                         # a zero-weight row
    rows = rng.standard_normal((m, n)).astype(np.float32)
    base = rng.standard_normal((t, n)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (w, rows, seg, base)]


@pytest.mark.parametrize("n", [4096, 4098, 4099])
@pytest.mark.parametrize("mode", ["plain", "normalize", "base", "quant"])
def test_fed_reduce_kernel_is_bitwise(cuda, n, mode):
    m, t = 19, 4
    w, rows, seg, base = _case(m, n, t, seed=n, dev=cuda)
    kw = {"normalize": mode != "plain"}
    if mode == "quant":
        kw.update(leaf_sizes=(n // 3, n - n // 3), quant_ref=base,
                  quant_enabled=torch.arange(m, device=cuda) % 3 != 0)
    b = base if mode in ("base", "quant") else None
    before = fr_mod.launches
    got = fr_mod.fed_reduce(w, rows, seg, t, b, **kw)
    torch.cuda.synchronize()
    assert fr_mod.launches == before + 1
    assert torch.equal(got, ref.fed_reduce_ref(w, rows, seg, t, b, **kw))


def test_fed_reduce_kernel_misaligned_rows(cuda):
    """A view that starts one float into its storage takes the scalar
    path and gives the same bits."""
    m, n, t = 6, 1024, 2
    w, rows, seg, base = _case(m, n + 1, t, seed=1, dev=cuda)
    view = rows.reshape(-1)[1:1 + m * n].reshape(m, n)
    got = fr_mod.fed_reduce(w, view, seg, t, base[:, :n].contiguous(),
                            normalize=True)
    want = ref.fed_reduce_ref(w, view, seg, t, base[:, :n].contiguous(),
                              normalize=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [4097, 4098, 4099])
@pytest.mark.parametrize("t", [1, 3])
def test_fed_reduce_kernel_every_row_alignment(cuda, n, t):
    """N = 1, 2, 3 mod 4: packed rows start on every alignment the loads
    choose between, and the last quad is a masked tail; M = 37 is more
    rows than a thread keeps in flight at once."""
    m = 37
    w, rows, seg, base = _case(m, n, t, seed=n + t, dev=cuda)
    for b in (None, base):
        got = fr_mod.fed_reduce(w, rows, seg, t, b, normalize=True)
        want = ref.fed_reduce_ref(w, rows, seg, t, b, normalize=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("t,layout", [(5, "interleaved"), (1, "dense"),
                                      (3, "skewed")])
@pytest.mark.parametrize("normalize", [True, False])
def test_fed_reduce_kernel_has_no_row_limit(cuda, t, layout, normalize):
    """M = 4,100 rows, past the 2,048 a block lists at a time: interleaved
    segments with one empty and one zero-weight row (T = 5), every row in
    one segment (T = 1), and one segment of about 3,000 rows interleaved
    with two small ones, so its rows are listed and folded in pieces."""
    m, n = 4100, 4098
    rng = np.random.default_rng(m + t)
    if layout == "interleaved":
        seg = rng.integers(0, t, m).astype(np.int32)
        seg[seg == 3] = 4                              # segment 3 empty
    elif layout == "dense":
        seg = np.zeros(m, np.int32)
    else:
        seg = np.where(rng.uniform(size=m) < 0.75, 0,
                       rng.integers(1, t, m)).astype(np.int32)
    w = rng.uniform(1.0, 100.0, m).astype(np.float32)
    w[5] = 0.0                                         # a zero-weight row
    rows = rng.standard_normal((m, n)).astype(np.float32)
    base = rng.standard_normal((t, n)).astype(np.float32)
    w, rows, seg, base = (torch.from_numpy(a).to(cuda)
                          for a in (w, rows, seg, base))
    before = fr_mod.launches
    got = fr_mod.fed_reduce(w, rows, seg, t, base, normalize=normalize)
    torch.cuda.synchronize()
    assert fr_mod.launches == before + 1
    want = ref.fed_reduce_ref(w, rows, seg, t, base, normalize=normalize)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,n", [(1, 4096), (1, 4097), (1, 4098), (1, 4099),
                                 (16, 4098), (40, 4097)])
def test_fed_aggregate_kernel(cuda, m, n):
    """Bitwise, also at M > 1: the plain version folds the rows in order
    as the kernel does.  M = 40 is more rows than a thread keeps in flight
    at once."""
    rng = np.random.default_rng(m + n)
    w, d, base = (torch.from_numpy(a).to(cuda) for a in (
        rng.uniform(0.0, 1.0, m).astype(np.float32),
        rng.standard_normal((m, n)).astype(np.float32),
        rng.standard_normal(n).astype(np.float32)))
    before = fa_mod.launches
    got = fa_mod.fed_aggregate(w, d, base)
    want = ref.fed_aggregate_ref(w, d, base)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(fa_mod.fed_aggregate(w, d), ref.fed_aggregate_ref(w, d))


# ---------------------------------------------------------------------------
# the LM zoo's kernels: rglru_scan bitwise, flash_attention within 2e-5
# ---------------------------------------------------------------------------

from repro_torch.kernels import flash_attention as fl_mod  # noqa: E402
from repro_torch.kernels import rglru_scan as sc_mod  # noqa: E402


@pytest.mark.parametrize("b,t,w", [(2, 64, 4096), (1, 37, 4099), (3, 1, 130),
                                   (2, 300, 64),
                                   (3, 75, 1000),   # T % 32 != 0, 16-byte copies
                                   (3, 75, 4099)])  # the same, 4-byte copies
def test_rglru_scan_kernel_is_bitwise(cuda, b, t, w):
    rng = np.random.default_rng(b * t + w)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (b, t, w)).astype(
        np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((b, t, w)).astype(
        np.float32)).to(cuda)
    before = sc_mod.launches
    got = sc_mod.rglru_scan(a, x)
    torch.cuda.synchronize()
    assert sc_mod.launches == before + 1
    assert torch.equal(got, ref.rglru_scan_ref(a, x))


def _qkv_cuda(b, h, kh, s, t, d, seed, dev):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev) for shape in ((b, h, s, d), (b, kh, t, d),
                                           (b, kh, t, d))]


@pytest.mark.parametrize("b,h,kh,s,t,d,causal,window,cap", [
    (2, 16, 1, 300, 300, 256, True, 128, None),    # recurrentgemma, MQA
    (1, 8, 4, 200, 200, 256, True, None, 50.0),    # gemma2 global
    (1, 8, 4, 130, 130, 256, True, 64, 50.0),      # gemma2 local
    (2, 4, 2, 77, 200, 64, True, None, None),      # S < T: aligned to T
    (1, 4, 1, 1, 97, 128, True, 16, None),         # one query
    (1, 6, 2, 100, 70, 32, False, None, 30.0),     # non-causal, S > T
    (1, 2, 2, 65, 65, 128, False, 9, None),        # non-causal window
    (1, 16, 1, 1024, 1024, 256, True, 512, None),  # many kv tiles, MQA
    (2, 4, 1, 100, 100, 32, True, None, None),     # S % 16 != 0 at D=32
    (1, 8, 2, 201, 201, 64, True, 50, 30.0),       # ... at D=64
    (2, 4, 4, 333, 333, 128, True, 100, None),     # ... at D=128
])
def test_flash_attention_kernel_matches_plain(cuda, b, h, kh, s, t, d,
                                              causal, window, cap):
    q, k, v = _qkv_cuda(b, h, kh, s, t, d, seed=s * d + t, dev=cuda)
    before = fl_mod.launches
    got = fl_mod.flash_attention(q, k, v, causal=causal, window=window,
                                 cap=cap)
    torch.cuda.synchronize()
    assert fl_mod.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_kernel_reads_strided_layout(cuda):
    """(B,S,H,D) tensors viewed as (B,H,S,D): no copy in, output in q's
    layout, same values."""
    from repro_torch.models.attention import flash_core, naive_attention

    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda) for shape in ((2, 150, 1, 16, 256),
                                            (2, 150, 1, 256),
                                            (2, 150, 1, 256)))
    got = flash_core(q, k, v, window=64, cap=None)
    assert got.is_contiguous()
    pos = torch.arange(150, device=cuda)
    want = naive_attention(q, k, v, q_pos=pos, k_pos=pos, window=64)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv_cuda(1, 2, 1, 32, 32, 64, seed=0, dev=cuda)
    with pytest.raises(ValueError, match="float32"):
        fl_mod.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="no key"):
        fl_mod.flash_attention(q, k[:, :, :16], v[:, :, :16])
    with pytest.raises(ValueError, match="head dim"):
        fl_mod.flash_attention(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               v[..., :48].contiguous())


# ---------------------------------------------------------------------------
# the sweep engine's packed paths on the card
# ---------------------------------------------------------------------------

def _sweep_spec(**kw):
    from repro_torch.experiments import TrialSpec
    base = dict(dataset="emnist", aggregator="fedavg", tuner="fedtune",
                m0=3, e0=1.0, rounds=3, target_accuracy=0.99, batch_size=5,
                eval_points=128)
    base.update(kw)
    return TrialSpec(**base)


def test_cohort_scan_on_cuda_matches_cpu(cuda):
    """A packed cohort of 8 lanes, each from its own global params, over
    16 steps with ragged step masks: the card within 1e-5 of the CPU."""
    from repro_torch.experiments import runner
    from repro_torch.runtime.batched import _stack_streams, to_device
    from repro_torch.tree import leaves, tree_map

    srv = runner.build_server(_sweep_spec(), "cpu")
    rng = np.random.default_rng(3)
    params = [srv.model.init(s, "cpu") for s in range(8)]
    streams = []
    for k in range(8):
        x, y = srv.dataset.client_data(k)
        streams.append(list(runner.materialize_streams(
            [(x, y)], 5, 1.0, rng)[0][0])[:16])
    arrays = _stack_streams(streams, 5, 16)
    out = {}
    for dev in ("cpu", cuda):
        run = runner._multi_cohort_fn(srv.model, srv.optimizer, 0.01)
        global_b = runner.tree_stack(
            [tree_map(lambda p: p.to(dev), p) for p in params])
        out[str(dev)] = run(global_b, *to_device(dev, *arrays))
    (p_cpu, l_cpu), (p_gpu, l_gpu) = out["cpu"], out[str(cuda)]
    for a, b in zip(leaves(p_cpu), leaves(p_gpu)):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5)
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=0, atol=1e-5)


def test_fused_sync_reduce_is_bitwise_against_plain(cuda, monkeypatch):
    """``_fused_sync_reduce`` over 5 FedAvg trials (T=8), two of them with
    int8 lanes, one with a zero-step client: one kernel launch, each
    trial's new params bitwise equal to the plain version on the same
    packed rows."""
    from repro_torch.experiments import runner
    from repro_torch.federated.aggregation import _flatten

    calls = []
    real = runner.kernel_ops.fed_reduce

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    monkeypatch.setattr(runner.kernel_ops, "fed_reduce", spy)
    rng = np.random.default_rng(11)
    live = []
    for s in range(5):
        tr = runner._make_live(_sweep_spec(
            seed=s, compression="int8" if s in (1, 3) else None), cuda, None)
        m = 3 + s
        gflat = _flatten(tr.params)[0]
        rows = [gflat + torch.from_numpy(rng.standard_normal(
            gflat.shape[0]).astype(np.float32) * 0.01).to(cuda)
            for _ in range(m)]
        if s == 2:
            rows[1] = None                         # a zero-step client
        tr.cohort = runner._Cohort(
            cids=list(range(m)), streams=[], n_steps=[1] * m,
            sizes=[int(v) for v in rng.integers(1, 300, m)],
            flat_rows=rows)
        live.append(tr)
    before = fr_mod.launches
    runner._fused_sync_reduce(live)
    torch.cuda.synchronize()
    assert fr_mod.launches - before == 1 and len(calls) == 1
    (w, rows, seg, t), kw = calls[0]
    assert t == 8 and rows.shape[0] == 32 and kw["quant_ref"] is not None
    want = ref.fed_reduce_ref(w, rows, seg, t, **kw)
    for s, tr in enumerate(live):
        assert torch.equal(_flatten(tr.cohort.agg_params)[0], want[s])


def test_served_queue_on_cuda_launches_both_kernels(cuda, tmp_path):
    """A staggered sync + async + buffered queue through ``serve`` on the
    card with 2 lanes: every trial finishes its rounds with params on the
    card, ``fed_reduce`` launches (the FedAvg group's fused reduce, the
    FedBuff flushes) and ``fed_aggregate`` launches (FedAsync mixes), and
    the records keep the CPU drain's (M, E), costs and logs."""
    from repro_torch.experiments import serve
    from repro_torch.tree import leaves

    specs = ([_sweep_spec(seed=s, rounds=1 + s % 2,
                          compression="int8" if s == 1 else None)
              for s in range(3)]
             + [_sweep_spec(seed=3, rounds=3, mode="async"),
                _sweep_spec(seed=4, rounds=2, mode="buffered")])
    fr_mod.launches = fa_mod.launches = 0
    got = serve(specs, max_lanes=2, device=cuda)
    torch.cuda.synchronize()
    assert fr_mod.launches > 0 and fa_mod.launches > 0
    cpu = {r.spec.key(): r for r in serve(specs, max_lanes=2, device="cpu")}
    assert len(got) == len(specs)
    for r in got:
        c = cpu[r.spec.key()]
        assert r.rounds == r.spec.rounds
        assert all(t.device.type == "cuda" for t in leaves(r.params))
        assert (r.history_m, r.history_e) == (c.history_m, c.history_e)
        assert r.cost == c.cost
        assert r.dispatch_log == c.dispatch_log
        assert r.staleness_log == c.staleness_log


def test_snapshot_restores_onto_cuda(cuda, tmp_path):
    """A drain killed after one macro-step and restored on the card ends
    with the uninterrupted card drain's store rows (wall aside), its
    tensors on the card; a bf16 checkpoint round-trips there bitwise."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.experiments import (ResultStore, TrialQueue,
                                         TrialScheduler)
    from repro_torch.tree import leaves

    specs = [_sweep_spec(seed=0, rounds=2),
             _sweep_spec(seed=1, rounds=2, mode="async")]

    def rows(store):
        return [{k: v for k, v in r.items() if k != "wall"}
                for r in store.load()]

    ref = ResultStore(str(tmp_path / "ref.jsonl"))
    TrialScheduler(TrialQueue(specs=specs), max_lanes=2, store=ref,
                   device=cuda).drain()
    store = ResultStore(str(tmp_path / "kill.jsonl"))
    snap = str(tmp_path / "s.snap")
    TrialScheduler(TrialQueue(specs=specs), max_lanes=2, store=store,
                   snapshot_path=snap, device=cuda).drain(max_steps=1)
    resumed = TrialScheduler.restore(snap, store=store, device=cuda)
    assert resumed.pool.n_live == 2
    for tr in resumed._sync_live:
        assert all(t.device.type == "cuda" for t in leaves(tr.params))
    for tr in resumed._event_live:
        assert all(t.device.type == "cuda" for t in leaves(tr.st.params))
    resumed.drain()
    assert rows(store) == rows(ref)

    tree = {"w": torch.randn(4, 6, device=cuda),
            "h": torch.randn(9, device=cuda).to(torch.bfloat16)}
    save_checkpoint(str(tmp_path / "ck"), tree)
    like = {"w": torch.zeros(4, 6, device=cuda),
            "h": torch.zeros(9, device=cuda, dtype=torch.bfloat16)}
    back, _ = load_checkpoint(str(tmp_path / "ck"), like)
    for a, b in zip(leaves(back), leaves(tree)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
