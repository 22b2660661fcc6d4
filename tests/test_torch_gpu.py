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
tiles through the K/V ring, non-causal windows, the model's strided
layout and the rest of the LM zoo's shapes scaled down (G = 2, 6 and 7,
non-causal encoder and cross-attention with S < T); a reduced MoE config
and a reduced encoder-decoder serve on the card with every full-sequence
attention through the kernel.  The serving tests drive a staggered sync + async + buffered
queue through ``serve`` on the card (both kernels launch; the records keep
the CPU drain's (M, E), costs and logs) and restore a killed drain's
snapshot onto the card.  The training kernels: the forward's lse, the
attention backward within 1e-4 of each gradient's max-abs and bitwise
equal to itself run twice (also at its tiles' edges: T not a multiple of
the 32-key tile, S G not of the 64-row tile, a window inside one tile,
G = 6 at D = 128, MQA walks of 150 steps, and a strided dout), the scan's
reverse scan bitwise, and a reduced stacked loss's gradients on the card
within 1e-4 of the CPU's.  This file
imports no JAX, so it runs where only torch is.
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
    # the rest of the LM zoo, scaled down
    (2, 16, 8, 300, 300, 64, True, None, None),    # granite-moe, G=2
    (1, 48, 8, 130, 130, 128, True, None, None),   # dbrx, G=6
    (2, 16, 16, 200, 200, 64, False, None, None),  # seamless encoder, G=1
    (2, 16, 16, 96, 200, 64, False, None, None),   # seamless cross, S < T
    (1, 14, 2, 272, 272, 64, True, None, None),    # internvl2 prefix, G=7
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


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "seamless-m4t-medium"])
def test_serve_zoo_on_cuda_launches_the_kernel(cuda, arch):
    """A reduced MoE config and a reduced encoder-decoder served on the
    card: every full-sequence attention of the prefill launches the kernel
    (seamless: the encoder's, the decoder's and the cross-attention), and
    the logits agree with the CPU's within 1e-4 (``chip_smoke.py`` phase
    6b's rule) for 4 steps fed the CPU's tokens."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import frontend_input, generate
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    cfg = reduced(get_config(arch), n_layers=2)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    gen = torch.Generator().manual_seed(1)
    b, s, steps = 2, 48, 4
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    fe = frontend_input(cfg, b, gen, "cpu")
    cpu = generate(model, params, prompt, steps, frontend=fe)
    want = cfg.n_layers + (cfg.encoder.n_layers + cfg.n_layers
                           if cfg.is_encoder_decoder else 0)
    params_c = tree_map(lambda p: p.to(cuda), params)
    fe_c = None if fe is None else fe.to(cuda)
    cache = model.init_cache(b, max_len=s + steps + 1, device=cuda)
    before = fl_mod.launches
    logits, cache = model.prefill(params_c, prompt.to(cuda), cache,
                                  frontend=fe_c)
    torch.cuda.synchronize()
    assert fl_mod.launches == before + want
    torch.testing.assert_close(logits.cpu(), cpu["prefill_logits"],
                               rtol=1e-4, atol=1e-4)
    for i in range(steps):
        logits, cache = model.decode_step(params_c, cpu["ids"][:, i].to(cuda),
                                          s + i, cache)
        torch.testing.assert_close(logits.cpu(), cpu["step_logits"][i],
                                   rtol=1e-4, atol=1e-4)
    assert fl_mod.launches == before + want


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


# ---------------------------------------------------------------------------
# the backward kernels (training)
# ---------------------------------------------------------------------------

def _max_rel(got, want) -> float:
    """max |got - want| over max |want|."""
    den = float(want.abs().max())
    return float((got - want).abs().max()) / max(den, 1e-30)


@pytest.mark.parametrize("b,h,kh,s,t,d,causal,window,cap", [
    (2, 16, 1, 300, 300, 256, True, 128, None),    # recurrentgemma, MQA
    (1, 8, 4, 200, 200, 256, True, None, 50.0),    # gemma2 global
    (1, 8, 4, 130, 130, 256, True, 64, 50.0),      # gemma2 local
    (2, 4, 2, 77, 200, 64, True, None, None),      # S < T: aligned to T
    (1, 6, 2, 100, 70, 32, False, None, 30.0),     # non-causal, S > T
    (2, 16, 16, 96, 200, 64, False, None, None),   # cross-attention S < T
    (1, 2, 2, 65, 65, 128, False, 9, None),        # non-causal window
    (2, 4, 1, 100, 100, 32, True, None, None),     # ragged tiles at D=32
    (1, 14, 2, 272, 272, 64, True, None, None),    # G=7
    (1, 4, 2, 100, 100, 64, True, None, None),     # T not a multiple of 32
    (1, 6, 2, 50, 50, 128, True, None, 20.0),      # S G = 150, not of 64
    (2, 4, 4, 90, 90, 64, True, 5, None),          # window < one key tile
    (1, 12, 2, 120, 120, 128, True, None, None),   # D=128, G=6 (dbrx)
    (1, 16, 1, 600, 600, 256, True, 300, None),    # MQA G=16: 150-step walks
])
def test_flash_attention_bwd_kernel_matches_plain(cuda, b, h, kh, s, t, d,
                                                  causal, window, cap):
    """The forward kernel's lse against the plain one; the backward kernel
    from the same (q, k, v, out, lse, dout) within 1e-4 of each
    gradient's max-abs, and a second call gives the same bits."""
    q, k, v = _qkv_cuda(b, h, kh, s, t, d, seed=s * d + t + 1, dev=cuda)
    dout = torch.randn_like(q)
    kw = dict(causal=causal, window=window, cap=cap)
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    k_out, k_lse = fl_mod.flash_attention(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(k_out, out, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(k_lse, lse, rtol=1e-5, atol=1e-5)
    before = fl_mod.bwd_launches
    got = fl_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = fl_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert fl_mod.bwd_launches == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert _max_rel(g, w) <= 1e-4


def test_flash_attention_bwd_kernel_reads_strided_dout(cuda):
    """A (B, S, H, D) ``dout`` viewed as (B, H, S, D), as the model's
    layout hands it over: the kernel reads it through its strides and
    matches the plain version on the same view."""
    q, k, v = _qkv_cuda(2, 8, 2, 140, 140, 128, seed=21, dev=cuda)
    dout = torch.randn(2, 140, 8, 128, device=cuda).transpose(1, 2)
    assert not dout.is_contiguous()
    kw = dict(causal=True, window=70, cap=None)
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    got = fl_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    for g, w in zip(got, want):
        assert _max_rel(g, w) <= 1e-4


def test_flash_attention_autograd_on_cuda_launches_both_kernels(cuda):
    """``ops.flash_attention`` under autograd on a strided (B,S,H,D)
    layout: one forward and one backward launch, gradients within 1e-4 of
    autograd through the plain version."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda).requires_grad_(True)
        for shape in ((2, 150, 8, 64), (2, 150, 4, 64), (2, 150, 4, 64)))
    dout = torch.randn(2, 150, 8, 64, device=cuda)
    kw = dict(causal=True, window=40, cap=20.0)
    f0, b0 = fl_mod.launches, fl_mod.bwd_launches
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), **kw)
    got = torch.autograd.grad(out.transpose(1, 2), (q, k, v), dout)
    torch.cuda.synchronize()
    assert (fl_mod.launches, fl_mod.bwd_launches) == (f0 + 1, b0 + 1)
    want = torch.autograd.grad(ref.flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        **kw).transpose(1, 2), (q, k, v), dout)
    for g, w in zip(got, want):
        assert _max_rel(g, w) <= 1e-4


@pytest.mark.parametrize("b,t,w", [(2, 64, 4096), (1, 37, 4099), (3, 1, 130),
                                   (3, 75, 1000), (3, 75, 4099)])
def test_rglru_scan_bwd_kernel_is_bitwise(cuda, b, t, w):
    rng = np.random.default_rng(b * t + w + 1)
    a, x, dh = (torch.from_numpy(arr.astype(np.float32)).to(cuda) for arr in (
        rng.uniform(0.5, 0.999, (b, t, w)), rng.standard_normal((b, t, w)),
        rng.standard_normal((b, t, w))))
    h = ref.rglru_scan_ref(a, x)
    before = sc_mod.bwd_launches
    got = sc_mod.rglru_scan_bwd(a, h, dh)
    torch.cuda.synchronize()
    assert sc_mod.bwd_launches == before + 1
    want = ref.rglru_scan_bwd_ref(a, h, dh)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_train_step_grads_on_cuda_match_cpu(cuda):
    """One reduced stacked loss (gemma2-2b, 4 layers: two local/global
    cycles, head dim 32) on the card and on the CPU from the same params:
    the loss and every gradient leaf within 1e-4 of its max-abs; the card
    launched each attention layer's forward twice (remat) and its backward
    once."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model, stacked
    from repro_torch.tree import leaves, tree_map

    cfg = reduced(get_config("gemma2-2b"), n_layers=4)
    params = stacked.stack_params(build_model(cfg).init(0, "cpu"), cfg)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 160))),
             "labels": torch.from_numpy(rng.integers(-1, cfg.vocab_size,
                                                     (2, 160))),
             "weight": torch.tensor([1.0, 2.0])}

    def run(p, bt):
        for x in leaves(p):
            x.requires_grad_(True)
        loss, _ = stacked.loss_fn(p, cfg, bt, remat=True)
        loss.backward()
        return loss.detach(), [x.grad for x in leaves(p)]

    want_loss, want = run(params, batch)
    params_c = tree_map(lambda x: x.detach().to(cuda), params)
    f0, b0 = fl_mod.launches, fl_mod.bwd_launches
    loss, got = run(params_c, {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert (fl_mod.launches - f0, fl_mod.bwd_launches - b0) == (8, 4)
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    for g, w in zip(got, want):
        assert _max_rel(g.cpu(), w) <= 1e-4


# ---------------------------------------------------------------------------
# the paper's ResNets on the card
# ---------------------------------------------------------------------------

def test_resnet10_on_cuda_with_tf32_default_matches_cpu(cuda, monkeypatch):
    """ResNet-10 (32x32x1, 35 classes, B=16) with torch's default
    ``cudnn.allow_tf32 = True`` set here: the model's own guard keeps every
    convolution in f32, its backward included.  The logits and loss agree
    with the CPU within 1e-4, each backward convolution's data and weight
    gradients with the same call in f64 within 1e-4 of their max-abs
    (TF32 misses that by ~10x), two card backward passes are bitwise
    equal, and the caller's flag is left as it was."""
    from repro_torch.configs.paper_models import RESNET10
    from repro_torch.models import build_model
    from repro_torch.models import resnet as resnet_mod
    from repro_torch.tree import leaves, unflatten_like

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    errs = []
    bwd0 = resnet_mod._Conv2d.backward

    def bwd(ctx, grad):
        gx, gw, a, b = bwd0(ctx, grad)
        if grad.is_cuda:
            x, w = ctx.saved_tensors
            want = torch.ops.aten.convolution_backward(
                grad.double().cpu(), x.double().cpu(), w.double().cpu(),
                None, list(ctx.stride), list(ctx.padding), [1, 1], False,
                [0, 0], 1, [gx is not None, True, False])
            errs.extend(_max_rel(g.double().cpu(), r) for g, r in
                        zip((gx, gw), want[:2]) if g is not None)
        return gx, gw, a, b

    monkeypatch.setattr(resnet_mod._Conv2d, "backward", staticmethod(bwd))
    model = build_model(RESNET10)
    params = model.init(0, "cpu")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((16, 32, 32, 1))
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 35, 16))

    def run(dev):
        flat = [t.to(dev).requires_grad_(True) for t in leaves(params)]
        p = unflatten_like(params, flat)
        logits = model.forward(p, x.to(dev))
        loss, _ = model.loss_fn(p, {"x": x.to(dev), "y": y.to(dev)})
        return (logits.detach().cpu(), float(loss),
                [g.cpu() for g in torch.autograd.grad(loss, flat)])

    want_logits, want_loss, _ = run("cpu")
    logits, loss, got = run(cuda)
    assert len(errs) == 2 * 12 - 1         # the stem has no data gradient
    assert max(errs) <= 1e-4
    _, _, again = run(cuda)
    assert torch.backends.cudnn.allow_tf32
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=1e-4)
    assert abs(loss - want_loss) <= 1e-4
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_resnet_trial_on_cuda_launches_both_kernels(cuda):
    """A 2-round ResNet-10 FedTune trial over the reduced speech federation
    on the card: sync rounds through ``fed_reduce``, async aggregations
    through ``fed_aggregate``; final params on the card."""
    from repro_torch.configs.paper_models import ResNetConfig
    from repro_torch.core import CostModel
    from repro_torch.data import speech_command_like
    from repro_torch.federated import FLConfig, FLServer, get_aggregator
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.runtime import RuntimeConfig, sample_fleet
    from repro_torch.tree import leaves

    ds = speech_command_like(reduced=True)
    model = build_model(ResNetConfig(
        name="resnet10", stage_blocks=(1, 1, 1, 1), width=8, n_classes=10,
        image_size=16))
    for mode, fleet, counter in (("sync", None, fr_mod),
                                 ("async", "stragglers", fa_mod)):
        srv = FLServer(
            model, ds, get_aggregator("fedavg"),
            get_optimizer("sgd", 0.05, momentum=0.9),
            CostModel(flops_per_example=model.flops_per_example,
                      param_count=79_259),
            FLConfig(m=3, e=1.0, batch_size=5, target_accuracy=0.99,
                     max_rounds=2, eval_points=128),
            fleet=None if fleet is None else sample_fleet(fleet, 128),
            runtime_config=RuntimeConfig(mode=mode), device=cuda)
        before = counter.launches
        res = srv.run()
        torch.cuda.synchronize()
        assert res.rounds == 2
        assert counter.launches - before >= 2
        assert all(p.device.type == "cuda" for p in leaves(res.params))
