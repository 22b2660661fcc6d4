"""The port's production-mesh dry run (``repro_torch.launch.dryrun``).

Each case joins a ``fake`` process group of 256 ranks in a subprocess of
its own and runs the steps on ``meta`` structs over the 16x16 mesh:

  * the head counts that 16 does not divide (gemma2-2b's 8 query and kv
    heads, qwen2-7b's 28, xlstm-350m's 4, granite-moe's 8 kv heads) and
    the RG-LRU and MoE blocks run through ``train_4k`` and
    ``prefill_32k``, each at one cycle of its layer pattern (widths,
    heads and experts full), and gemma2-2b through ``decode_32k``: every
    one of these stopped before the repair;
  * gemma2-2b's ``train_4k`` at full depth: one rank's arguments (bf16
    params, f32 momentum, the batch) are the reference's
    ``memory_analysis().argument_size_in_bytes``, and so are its
    ``decode_32k`` arguments (params, cache, token, position); every
    field of its memory analysis is measured (``roofline.analysis``) and
    they split the peak as the reference's do;
  * the records' roofline fields are the analysis of the step the rank
    runs, and the analytic model's terms on the H100 sit under
    ``analytic``;
  * gemma2-2b's full-depth ``train_4k`` fits a card's 80 GB a rank and
    gathers at least 2.0e12 B less than when each CE chunk gathered the
    whole stream; two layers of its ``prefill_32k`` peak below one whole
    global layer's k and v (the cache made sharded, written in place);
    its full-depth ``decode_32k`` outputs no second cache; where the
    vocabulary stays whole (seamless-m4t-medium, two layers) the CE's
    rows and chunk split over ``model`` keep a rank's peak below two
    chunks' logits of its rows;
  * a weight placed whole where its rule shards it raises the rank's
    FLOPs and peak, which the analytic model cannot see;
  * a combination that fails exits 1 and names the op that stopped it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.shapes import get_shape as j_get_shape  # noqa: E402
from repro.roofline import analytic as j_analytic  # noqa: E402
from repro_torch.roofline.hardware import H100  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# The reference's ``run_one`` on a 16x16 ``jax.sharding.Mesh`` of 256 XLA
# CPU devices (Auto axes, in place of ``jax.make_mesh``'s Explicit ones,
# which its sharding constraints refuse under this JAX): gemma2-2b's
# ``compiled.memory_analysis().argument_size_in_bytes`` per device.
REF_ARGUMENT_SIZE = {"train_4k": 191_917_632, "decode_32k": 1_045_384_740}

# (arch, shape, layers): one cycle of each pattern, gemma2-2b at full depth
# (the last two)
CASES = [
    ("gemma2-2b", "train_4k", 2), ("gemma2-2b", "prefill_32k", 2),
    ("qwen2-7b", "train_4k", 1), ("qwen2-7b", "prefill_32k", 1),
    ("xlstm-350m", "train_4k", 2), ("xlstm-350m", "prefill_32k", 2),
    ("granite-moe-1b-a400m", "train_4k", 1),
    ("granite-moe-1b-a400m", "prefill_32k", 1),
    ("recurrentgemma-9b", "train_4k", 3),
    ("recurrentgemma-9b", "prefill_32k", 3),
    ("seamless-m4t-medium", "train_4k", 2),
    ("gemma2-2b", "train_4k", None), ("gemma2-2b", "decode_32k", None),
]

_RUN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
out = []
for arch, shape, layers in json.loads(sys.argv[1]):
    try:
        out.append(dryrun.run_one(arch, shape, False, verbose=False,
                                  save=False, layers=layers))
    except dryrun.DryRunError as e:
        out.append({"arch": arch, "shape": shape, "status": "fail",
                    "error": str(e)})
print(json.dumps(out))
"""

# the parent's projection: DTensor's einsum over 8 heads on 16 ranks
_PLANTED = r"""
import sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
from repro_torch.models import attention
dryrun.OUT_DIR = __import__("pathlib").Path(sys.argv[1])
attention._head_proj = lambda x, w: torch.einsum("bse,ehd->bshd", x, w)
dryrun.main(["--arch", "gemma2-2b", "--shape", "prefill_32k"])
"""


# gemma2-2b's prefill with the MLP's weights (d_ff split over ``model`` by
# their rules) replicated before the products, as a rule that left them
# whole would place them
_WHOLE_WEIGHT = r"""
import json
import torch
torch.set_num_threads(1)
from torch.distributed.tensor import Replicate
from repro_torch.launch import dryrun
from repro_torch.models import ffn

mlp = ffn.mlp


def whole(params, x, act_name="silu"):
    return mlp({k: w.redistribute(w.device_mesh,
                                  [Replicate()] * w.device_mesh.ndim)
                for k, w in params.items()}, x, act_name)


ffn.mlp = whole
print(json.dumps(dryrun.run_one("gemma2-2b", "prefill_32k", False,
                                verbose=False, save=False, layers=2)))
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


def _halves(cases):
    return [cases[0::2], cases[1::2]]


@pytest.fixture(scope="module")
def records():
    """{(arch, shape, layers): record}, the cases split over two
    subprocesses run side by side."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RUN, json.dumps(half)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for half in _halves(CASES)]
    out = {}
    for proc, half in zip(procs, _halves(CASES)):
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-4000:]
        for case, rec in zip(half, json.loads(stdout.splitlines()[-1])):
            out[tuple(case)] = rec
    return out


@pytest.mark.parametrize("case", CASES[:-2], ids=lambda c: f"{c[0]}-{c[1]}")
def test_steps_run_through_on_the_16x16_mesh(records, case):
    rec = records[case]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["n_layers"] == case[2]
    assert rec["memory_analysis"]["argument_size"] > 0
    assert rec["t_run_s"] >= 0 and rec["t_build_s"] >= 0


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_full_depth_argument_size_equals_the_references(records, shape):
    rec = records[("gemma2-2b", shape, None)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_layers"] == 26
    mem = rec["memory_analysis"]
    assert mem["argument_size"] == REF_ARGUMENT_SIZE[shape]
    # measured by the analysis of the step (``roofline.analysis``): params
    # and momentum (train) and the cache's new entry (decode) are written
    # in place, and the fields split the peak as the reference's identity
    assert min(mem["output_size"], mem["temp_size"], mem["alias_size"],
               rec["peak_memory_bytes"]) > 0
    assert rec["peak_memory_bytes"] == mem["argument_size"] \
        + mem["output_size"] + mem["temp_size"] - mem["alias_size"]


# a card's memory, and the gemma2-2b train_4k all-gather bytes a rank
# before the CE's chunks came from each rank's own tokens (the card's
# torch), which the repair must cut by at least ALL_GATHER_CUT
CARD_BYTES = 80e9
EARLIER_ALL_GATHER, ALL_GATHER_CUT = 4.80e12, 2.0e12
# one whole global layer's keys and values at prefill_32k: B=32 x 32,768
# positions x 4 kv heads x 256 x bf16, k and v
WHOLE_GLOBAL_LAYER_KV = 32 * 32768 * 4 * 256 * 2 * 2


def test_full_depth_train_step_fits_a_card_a_rank(records):
    """gemma2-2b ``train_4k`` at full depth on 16x16: the CE's chunks cut
    from each rank's own tokens with the vocabulary kept split, so no
    chunk gathers the whole stream or its logits."""
    rec = records[("gemma2-2b", "train_4k", None)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["peak_memory_bytes"] < CARD_BYTES
    assert rec["coll_breakdown"]["all-gather"] <= \
        EARLIER_ALL_GATHER - ALL_GATHER_CUT


def test_prefill_holds_less_than_one_whole_global_layer(records):
    """The prefill's stacked cache is made sharded (each rank allocates
    its own shard) and written in place: two layers of gemma2-2b's
    ``prefill_32k`` peak below one whole global layer's k and v."""
    rec = records[("gemma2-2b", "prefill_32k", 2)]
    assert rec["status"] == "ok", rec.get("error")
    assert WHOLE_GLOBAL_LAYER_KV == 4_294_967_296
    assert rec["peak_memory_bytes"] < WHOLE_GLOBAL_LAYER_KV


# seamless-m4t-medium's train_4k: the 16 ``model`` ranks split a batch
# shard's 65,536 decoder tokens, 4,096 a rank, over a vocabulary of
# 256,206 that 16 does not divide (kept whole); f32 logits of all 4,096
SEAMLESS_ROWS_LOGITS = 4096 * 256_206 * 4


def test_rows_split_ce_holds_a_ranks_share_of_the_chunk(records):
    """Where the vocabulary stays whole the ``model`` ranks split the
    CE's rows and its chunk with them (1,024 of 16,384 rows a chunk), so
    a rank's peak (two layers) stays below two chunks' logits of its
    4,096 rows; a chunk of all of them held five at once."""
    rec = records[("seamless-m4t-medium", "train_4k", 2)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["peak_memory_bytes"] < 2 * SEAMLESS_ROWS_LOGITS


def test_serve_step_makes_no_second_cache(records):
    """gemma2-2b ``decode_32k`` at full depth on 16x16: the serve step
    writes its stacked cache in place and returns it, so the cache is
    aliased (written in place) and the step's output, the logits, is
    smaller than it; a step that restacked the cache would output a
    second one."""
    rec = records[("gemma2-2b", "decode_32k", None)]
    assert rec["status"] == "ok", rec.get("error")
    mem = rec["memory_analysis"]
    assert mem["alias_size"] > 0.9e9
    assert mem["output_size"] < mem["alias_size"]


def test_roofline_fields_are_the_analysis_and_the_analytic_models_beside(
        records):
    for (arch, shape, layers), rec in records.items():
        assert rec["status"] == "ok", rec.get("error")
        counts = rec["coll_breakdown"]["counts"]
        assert rec["flops"] > 0 and rec["hbm_bytes"] > 0
        assert rec["coll_bytes"] == sum(
            v for k, v in rec["coll_breakdown"].items() if k != "counts")
        assert rec["coll_bytes"] > 0 and sum(counts.values()) > 0
        terms = {"compute": rec["flops"] / H100.peak_flops_bf16,
                 "memory": rec["hbm_bytes"] / H100.hbm_bandwidth,
                 "collective": rec["coll_bytes"] / (
                     H100.ici_links_per_chip * H100.ici_link_bandwidth)}
        assert (rec["t_compute"], rec["t_memory"], rec["t_collective"]) == \
            (terms["compute"], terms["memory"], terms["collective"])
        assert rec["bottleneck"] == max(terms, key=terms.get)
        if layers is not None:
            continue
        rep = j_analytic.analyze(j_get_config(arch), j_get_shape(shape),
                                 n_devices=256)
        a_terms = rep.terms(H100)
        cfg, s = j_get_config(arch), j_get_shape(shape)
        n = cfg.active_param_count()
        model_flops = {"train": 6.0 * n * s.global_batch * s.seq_len,
                       "decode": 2.0 * n * s.global_batch}[s.kind]
        assert rec["model_flops"] == model_flops
        assert rec["useful_ratio"] == model_flops / (rec["flops"] * 256)
        assert rec["analytic"] == {
            "flops": rep.flops, "hbm_bytes": rep.hbm_bytes,
            "coll_bytes": rep.coll_bytes, "t_compute": a_terms["compute"],
            "t_memory": a_terms["memory"],
            "t_collective": a_terms["collective"],
            "bottleneck": rep.bottleneck(H100),
            "useful_ratio": model_flops / (rep.flops * 256)}


def test_a_weight_placed_whole_raises_the_ranks_flops_and_peak(records):
    """A planted fault on the ``_PLANTED`` pattern: the prefill's MLP
    weights whole on every rank, so each rank computes the whole d_ff,
    which the analysis counts and the analytic model cannot."""
    proc = subprocess.run([sys.executable, "-c", _WHOLE_WEIGHT],
                          env=_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    planted = json.loads(proc.stdout.splitlines()[-1])
    rec = records[("gemma2-2b", "prefill_32k", 2)]
    assert rec["status"] == planted["status"] == "ok"
    assert planted["flops"] > rec["flops"]
    assert planted["peak_memory_bytes"] > rec["peak_memory_bytes"]
    assert planted["analytic"] == rec["analytic"]


def test_a_failing_combination_exits_1_and_names_its_op(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _PLANTED, str(tmp_path)],
                          env=_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 1, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "failures: 1" in proc.stdout
    rec = json.loads((tmp_path / "gemma2-2b__prefill_32k__16x16.json")
                     .read_text())
    assert rec["status"] == "fail"
    assert rec["op"] == "aten.view.default"
    assert "unevenly sharded" in rec["error"]
    assert "[FAIL] gemma2-2b prefill_32k 16x16 at aten.view.default" \
        in proc.stdout
