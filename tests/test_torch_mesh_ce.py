"""The CE on a device mesh (``lm.chunked_ce`` over DTensors), on the CPU.

On a mesh each rank cuts its chunks from its own tokens and keeps the
chunk's logits split over ``model`` on the vocabulary; the logsumexp, the
target logit and the argmax are made from each shard's pieces with
collectives of (rows,) vectors.  Where the vocabulary does not divide
``model`` it stays whole and the ``model`` ranks split the rows instead.
Against one device, on the same numpy inputs:

  * (2, 2) and (2, 3) meshes of gloo ranks (``run_ranks``), the stream
    placed as the residual stream (batch on ``data``, sequence on
    ``model``) and the head by the train rules: ce within 1e-6, acc
    exactly, the gradients of x and of the head (tied embedding or
    ``lm_head``) within 1e-5 of their max-abs;
  * tokens a rank that are not a multiple of the chunk, labels of -1,
    per-sequence weights, a vocabulary the ``model`` axis divides and one
    it does not;
  * an argmax tie planted across two vocabulary shards (two head columns
    alike with one nonzero entry, so their logits are bitwise equal):
    the lower id wins on the mesh, on one device and in the reference's
    ``chunked_ce``;
  * on a (1, 1) mesh (a ``model`` axis of one rank) ce, acc and both
    gradients are one device's, bit for bit;
  * ``roofline.analysis`` of the CE alone at gemma2-2b's full width on
    rank 0 of a ``fake`` 16x16 group (``train_4k``'s stream): its
    all-gathers are the sequence gather of the rank's own tokens and the
    head's shard gathered over ``data``, no more, where each chunk once
    gathered the whole stream and its logits over the vocabulary.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CE_TOL = 1e-6
GRAD_TOL = 1e-5
B, S, D = 4, 10, 16
ARCH = "gemma2-2b"
# name: (vocab, tied head, chunk tokens, planted tie (low id, high id));
# each data rank holds 2 x 10 = 20 tokens, not a multiple of 8 or 7
CASES = {
    (2, 2): {"split": (48, False, 8, None), "whole": (47, True, 8, None),
             "tie": (48, False, 8, (5, 30))},
    (2, 3): {"split": (48, True, 7, None), "whole": (50, False, 7, None),
             "tie": (48, True, 7, (10, 40))},
}
TIE_DIM, TIE_SCALE = 3, 3.0


def _cfg(tie: bool):
    return dataclasses.replace(get_config(ARCH), tie_embeddings=tie)


def _inputs(vocab, tie, planted, seed):
    """x (B, S, D), the head leaf, labels with -1s, token weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    head = (0.5 * rng.standard_normal((D, vocab))).astype(np.float32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    labels[3, 7] = -1
    if planted is not None:
        lo, hi = planted
        # columns lo and hi alike with one nonzero entry, on a dim no other
        # column reads: their logits are the same product, bitwise, and the
        # largest of the row, by a margin that keeps the softmax's other
        # mass (and the gradients) well conditioned
        head[:, lo] = head[:, hi] = head[TIE_DIM] = 0.0
        head[TIE_DIM, lo] = head[TIE_DIM, hi] = TIE_SCALE
        x[..., TIE_DIM] = np.abs(x[..., TIE_DIM]) + 3.0
        labels[:2] = lo
        labels[2:] = hi
        labels[0, :3] = -1
    w = np.asarray([1.0, 2.0, 0.5, 3.0], np.float32)
    tok_w = (labels >= 0).astype(np.float32) * w[:, None]
    head_leaf = head.T.copy() if tie else head
    return x, head_leaf, labels, tok_w


def _params(head_leaf, tie):
    norm = torch.zeros(D)
    h = torch.from_numpy(head_leaf)
    return {"final_norm": norm, "embed" if tie else "lm_head": h}


def _one_device(vocab, tie, chunk, planted, seed):
    x, head_leaf, labels, tok_w = _inputs(vocab, tie, planted, seed)
    p = _params(head_leaf, tie)
    key = "embed" if tie else "lm_head"
    p[key].requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ce, acc = lm.chunked_ce(p, _cfg(tie), tx, torch.from_numpy(labels),
                            torch.from_numpy(tok_w), chunk_tokens=chunk)
    ce.backward()
    return {"ce": float(ce.detach()), "acc": float(acc),
            "gx": tx.grad.numpy(), "ghead": p[key].grad.numpy()}


def _rank_ce(cm, shape):
    """Every case of ``shape``'s mesh on this rank: ce, acc and the
    gathered gradients."""
    from torch.distributed.tensor import distribute_tensor
    mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
    rules = sh.train_rules(False)
    out = {}
    for i, (name, (vocab, tie, chunk, planted)) in enumerate(
            CASES[shape].items()):
        x, head_leaf, labels, tok_w = _inputs(vocab, tie, planted, i)
        key = "embed" if tie else "lm_head"
        p = sh.place_params(_params(head_leaf, tie), mesh, rules)
        p[key].requires_grad_(True)
        xs = sh.fit_spec(sh.P("data", "model", None), x.shape, mesh)
        tx = distribute_tensor(torch.from_numpy(x), mesh,
                               sh.to_placements(xs, mesh),
                               src_data_rank=None).requires_grad_(True)
        ce, acc = lm.chunked_ce(
            p, _cfg(tie), tx,
            sh.place_batch(torch.from_numpy(labels), mesh, rules),
            sh.place_batch(torch.from_numpy(tok_w), mesh, rules),
            chunk_tokens=chunk)
        ce.backward()
        out[name] = {"ce": float(ce.full_tensor()),
                     "acc": float(acc.full_tensor()),
                     "gx": tx.grad.full_tensor().numpy(),
                     "ghead": p[key].grad.full_tensor().numpy(),
                     "split": p[key].placements[1].is_shard()}
    return out


@pytest.fixture(scope="module", params=sorted(CASES), ids=lambda s: "x".join(
    map(str, s)))
def mesh_ce(request, tmp_path_factory):
    shape = request.param
    tmp = tmp_path_factory.mktemp("ce")
    ranks = mesh_mod.run_ranks(_rank_ce, shape[0] * shape[1], device="cpu",
                               init_file=str(tmp / "rendezvous"),
                               args=(shape,))
    return shape, ranks


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", ["split", "whole", "tie"])
def test_mesh_ce_matches_one_device(mesh_ce, name):
    shape, ranks = mesh_ce
    i = list(CASES[shape]).index(name)
    vocab, tie, chunk, planted = CASES[shape][name]
    want = _one_device(vocab, tie, chunk, planted, i)
    # the vocabulary is split over model exactly where model divides it
    assert ranks[0][name]["split"] == (vocab % shape[1] == 0)
    for got in ranks:
        assert abs(got[name]["ce"] - want["ce"]) <= CE_TOL * abs(want["ce"])
        assert got[name]["acc"] == want["acc"]
        assert _rel(got[name]["gx"], want["gx"]) <= GRAD_TOL
        assert _rel(got[name]["ghead"], want["ghead"]) <= GRAD_TOL


def _rank_ce_one(cm):
    """The ``split`` case's inputs on a (1, 1) mesh of this 1-rank group."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), "cpu")
    vocab, tie, chunk, planted = CASES[(2, 2)]["split"]
    x, head_leaf, labels, tok_w = _inputs(vocab, tie, planted, 0)
    rules = sh.train_rules(False)
    key = "embed" if tie else "lm_head"
    p = sh.place_params(_params(head_leaf, tie), mesh, rules)
    p[key].requires_grad_(True)
    tx = distribute_tensor(torch.from_numpy(x), mesh, [Replicate()] * 2,
                           src_data_rank=None).requires_grad_(True)
    ce, acc = lm.chunked_ce(
        p, _cfg(tie), tx, sh.place_batch(torch.from_numpy(labels), mesh,
                                         rules),
        sh.place_batch(torch.from_numpy(tok_w), mesh, rules),
        chunk_tokens=chunk)
    ce.backward()
    return {"ce": ce.to_local().detach(), "acc": acc.to_local(),
            "gx": tx.grad.to_local(), "ghead": p[key].grad.to_local()}


def test_mesh_ce_on_a_1x1_mesh_is_one_devices_bitwise(tmp_path):
    """A ``model`` axis of one rank splits nothing: the mesh CE runs one
    device's chunks on the local tensors, bit for bit."""
    (got,) = mesh_mod.run_ranks(_rank_ce_one, 1, device="cpu",
                                init_file=str(tmp_path / "rendezvous"))
    vocab, tie, chunk, planted = CASES[(2, 2)]["split"]
    want = _one_device(vocab, tie, chunk, planted, 0)
    assert got["ce"].item() == want["ce"]
    assert got["acc"].item() == want["acc"]
    assert np.array_equal(got["gx"].numpy(), want["gx"])
    assert np.array_equal(got["ghead"].numpy(), want["ghead"])


def test_planted_argmax_tie_goes_to_the_lower_id(mesh_ce):
    """Rows labelled with the lower id count as correct, those labelled
    with the higher one do not, on the mesh as on one device and in the
    reference's ``chunked_ce``."""
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import lm as jlm
    shape, ranks = mesh_ce
    i = list(CASES[shape]).index("tie")
    vocab, tie, chunk, planted = CASES[shape]["tie"]
    lo, hi = planted
    assert lo < vocab // shape[1] <= (shape[1] - 1) * vocab // shape[1] <= hi
    x, head_leaf, labels, tok_w = _inputs(vocab, tie, planted, i)
    counted = int((labels >= 0).sum())
    lower = int((labels == lo).sum())
    jp = {"final_norm": jnp.zeros(D),
          "embed" if tie else "lm_head": jnp.asarray(head_leaf)}
    jcfg = dataclasses.replace(j_get_config(ARCH), tie_embeddings=tie)
    _, jacc = jlm.chunked_ce(jp, jcfg, jnp.asarray(x), jnp.asarray(labels),
                             jnp.asarray(tok_w), chunk_tokens=chunk)
    want = _one_device(vocab, tie, chunk, planted, i)
    assert want["acc"] == pytest.approx(lower / counted, abs=1e-7)
    assert float(jacc) == pytest.approx(want["acc"], abs=1e-7)
    for got in ranks:
        assert got["tie"]["acc"] == want["acc"]


# the CE alone on rank 0 of a fake 16x16 group, gemma2-2b at full width
# and train_4k's stream, analysed on ``meta``
_ANALYSIS = r"""
import json
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.configs.shapes import get_shape
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.roofline.analysis import analyze_traced
from repro_torch.sharding import specs as sh

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
cfg, shape = get_config("gemma2-2b"), get_shape("train_4k")
mesh = make_production_mesh(device="cpu")
rules = steps.train_step_rules()
b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
p_struct = steps.param_struct(cfg, torch.bfloat16, stacked=True)
params = sh.place_params({"embed": p_struct["embed"],
                          "final_norm": p_struct["final_norm"]}, mesh, rules)
x = distribute_tensor(
    torch.empty((b, s, d), dtype=torch.bfloat16, device="meta"), mesh,
    sh.to_placements(sh.P("data", "model", None), mesh), src_data_rank=None)
labels = sh.place_batch(torch.empty((b, s), dtype=torch.int32,
                                    device="meta"), mesh, rules)
tok_w = sh.place_batch(torch.empty((b, s), dtype=torch.float32,
                                   device="meta"), mesh, rules)


def step(params, x, labels, tok_w):
    params["embed"].requires_grad_(True)
    x.requires_grad_(True)
    ce, _ = lm.chunked_ce(params, cfg, x, labels, tok_w)
    ce.backward()
    return ce


rep, mem = analyze_traced(step, (params, x, labels, tok_w),
                          arch="gemma2-2b", shape="train_4k", mesh="16x16",
                          n_devices=256)
print(json.dumps({"coll": rep.coll_breakdown,
                  "peak": rep.peak_memory_bytes, "b": b, "s": s, "d": d,
                  "vocab": cfg.vocab_size}))
dist.destroy_process_group()
"""


def test_mesh_ce_gathers_no_more_than_a_ranks_own_tokens():
    proc = subprocess.run(
        [sys.executable, "-c", _ANALYSIS],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rec = json.loads(proc.stdout.splitlines()[-1])
    b, s, d, vocab = rec["b"], rec["s"], rec["d"], rec["vocab"]
    own_tokens = (b // 16) * s * d * 2          # the rank's batch shard
    head_shard = d * (vocab // 16) * 2          # gathered over data
    counts = rec["coll"]["counts"]
    assert counts["all-gather"] == 2
    assert rec["coll"]["all-gather"] == own_tokens + head_shard
    # before: every chunk gathered the whole stream and its logits
    whole_stream = b * s * d * 2
    assert rec["coll"]["all-gather"] < whole_stream
    # no chunk's logits whole over the vocabulary on the rank
    assert rec["peak"] < 16_384 * vocab * 4
