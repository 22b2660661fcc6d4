#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100, the CUDA
toolkit (``nvcc``) and a CUDA build of PyTorch.  Phases, each of which
exits non-zero on failure:

  1. Build the hand-written kernels from ``src/repro_torch/kernels/csrc``
     with nvcc (the four TPU kernels' ports and the two training
     backwards, each in f32 and, but the reverse scan, in bf16; printing
     the build seconds and ptxas's register report) and print the card's
     name and power limit.
  2. Hold each FedTune kernel against its plain PyTorch version on the card
     at the main path's shapes: ``fed_reduce`` bitwise (FedAvg, FedBuff
     flush, a packed T=8 cohort with the int8 round trip, and two packed
     sweeps of T=32 lanes at full width: ``packed_sweep`` with M=2,880 and
     ``rows_over_3000`` with M=3,200, 1.97 and 2.19 GB), ``fed_aggregate``
     bitwise at M=1 and M=16.  One JSON line per case with the kernel's,
     the plain version's and one PyTorch library call's median time (CUDA
     events, L2 flushed before each launch) and the bound: the larger of
     the bytes at 3.35 TB/s and the f32 operations at 67 TFLOP/s.  First,
     one line with the launch floor: the median time of a one-element
     PyTorch launch under the same harness.
  2b. The same for the LM kernels at the serving path's shapes:
     ``rglru_scan`` bitwise (B=2, T=4096, W=4096; W=4099; T=1) and
     ``flash_attention`` within rtol = atol = 2e-5 (recurrentgemma-9b's
     local layer B=2, H=16, Kh=1, S=4096, D=256, window 2048; gemma2-2b's
     global layer H=8, Kh=4, cap 50; a ragged S=4000; a small non-causal
     case), and the rest of the LM zoo's prefill shapes: granite-moe
     (H=16, Kh=8, S=T=4096, D=64), dbrx (H=48, Kh=8, S=T=2048, D=128),
     seamless-m4t's encoder (H=Kh=16, S=T=1024, D=64, non-causal) and
     cross-attention (S=512, T=1024, non-causal), internvl2's prefix plus
     prompt (H=14, Kh=2, S=T=2304, D=64), all at B=2.  The attention
     bound counts the live (query, key) pairs of this run's masks on the
     kernel's own route: its products run on the tensor cores as three
     TF32 passes (3xTF32), so ``bound_ms`` is 3 x flops at 495 TFLOP/s
     (``bound_route``), with the f32 SIMT figure (flops at 67 TFLOP/s)
     kept beside it as ``bound_f32_simt_ms``.  Its library
     yardstick is ``scaled_dot_product_attention`` with the window as an
     explicit mask (none where there is a cap); the scan has no one-call
     library equivalent.
  2c. The training kernels at the training path's shapes: the forward's
     log-sum-exp against the plain one; ``flash_attention_bwd`` from the
     same (q, k, v, out, lse, dout) within 1e-4 of each gradient's max-abs
     and bitwise equal to itself run twice (gemma2-2b's global layer, cap
     50, and its local one, window 4096; recurrentgemma-9b's local layer,
     window 2048, Kh=1; a ragged S=4000; seamless-m4t's non-causal
     cross-attention S=512, T=1024); the reverse scan ``rglru_scan_bwd``
     bitwise (B=2, T=4096, W=4096; W=4099; T=1).  Each case: card, plain
     and library ms (the backward of SDPA with the mask explicit, none
     under a cap or for the scan), the bound on the kernel's route (the
     attention backward runs its products as 3xTF32 on the tensor cores:
     3 x 10 D flops a live pair at 495 TFLOP/s; the f32 SIMT figure, 10 D
     at 67 TFLOP/s, beside it), its share of that bound, and the
     backward's launch from its C planner (``plan``: the scratch bytes,
     the prep pass's blocks, the kv-major and q-major blocks of the main
     launch and which kind goes first, its dynamic shared memory, the
     blocks an SM holds and the grid's waves) with ptxas's registers,
     shared memory and spills of both kernels (``attn_bwd_prep``,
     ``attn_bwd_main``).
  3. Drive the FedTune path on the card: ``FLServer`` with ``MLP_EMNIST``
     at full width (784-200-62, 169,462 params) over the full
     ``emnist_like`` federation, FedTune on, in sync (M=20, E=2, 5 rounds),
     async (M=10, 10 aggregations) and buffered (K=8, stragglers fleet, 2
     flushes) modes.  Each kernel's launch count is set to 0 just before
     each mode and read just after; every kernel must have launched.
  4. Run the first 3 sync rounds again on the CPU (plain kernels) from the
     same initial params: (M, E) per round and the cost totals must be
     identical and accuracy must agree within 0.01.
  5. Serve ``recurrentgemma-9b`` at full width and depth (38 layers, 8.52 B
     params, f32, drawn on the card from a seed) through
     ``repro_torch.launch.serve.generate``: batch 2, a 4096-token prompt
     (twice the window: the ring cache and the tile skipping both run), 32
     greedy tokens.  The counts are set to 0 just before and read just
     after: one prefill launches ``flash_attention`` 12 times and
     ``rglru_scan`` 26 times.  All logits must be finite, and decode must
     agree with prefill within 5e-3 (``prefill(prompt[:, :S-1])`` then one
     ``decode_step`` against the last logits of ``prefill(prompt)``).
     Prints prefill seconds and tokens/s, decode tokens/s and the peak
     device memory.
  6. ``reduced(recurrentgemma-9b, n_layers=3)`` from the same init params
     on the card and on the CPU, prompt 160, 8 decode steps fed the CPU
     run's tokens: the logits must agree within 1e-4 at every step.
  5b. The rest of the LM zoo at full width through ``generate`` (f32 params
     drawn on the card, batch 2, 32 greedy tokens; ``ZOO``): xlstm-350m (24
     layers, prompt 2048, no attention), granite-moe-1b-a400m (24, 4096),
     dbrx-132b (its first 2 of 40 layers, every width kept, 2048),
     seamless-m4t-medium (12 encoder + 12 decoder layers, 1024 audio frames
     x 1024, prompt 512) and internvl2-1b (24, 256 vision patches x 896
     before a 2048-token prompt).  Each: the parameter count of the
     reference's tree, ``flash_attention`` launched exactly 0, 24, 2, 36
     and 24 times by one prefill (counts set to 0 just before), finite
     logits, decode within 5e-3 of prefill (xLSTM at a 128-token prompt,
     one mLSTM chunk), prefill and decode tokens/s and peak memory.
  6b. Phase 6's rule for each of the five, reduced to 3 layers (prompt 64):
     logits within 1e-4 at every step; a MoE route that differs between
     the devices is printed with its top-k margin.

  7. The vectorized sweep engine at paper scale through ``run_sweep`` on
     the card (``launch/profile_sweep.full_width_grid``): 48 sync trials
     (fedavg, fednova, fedadam x preferences 0, 3, 14 x seeds 0, 1 x
     compression none, int8; fixed baselines collapsed), (M0, E0) = (20,
     1.0), batch 10, 512 eval points, 5 rounds, over the full
     ``emnist_like`` federation with the sweep's 40,718-param MLP.  Every
     trial must finish its rounds with its params on the card and positive
     costs, and ``fed_reduce`` must launch exactly once per sweep round for
     the FedAvg group, int8 lanes in the same launch.  Prints lanes packed
     per round, the (T, M, N) of every ``fed_reduce`` launch, the wall
     seconds, trial-rounds/s and local steps/s.  Then the async/buffered
     grid (fedavg, preference 14, seeds 0, 1, stragglers fleet, 10
     aggregations): ``fed_aggregate`` and ``fed_reduce`` must launch.
  8. Four of phase 7's trials (two FedAvg, one of them int8; one FedAdam;
     one async), each also run alone through ``run_trial`` on the card from
     the same initial params: (M, E), costs and dispatch/staleness logs
     equal, accuracy within 0.01 (ROADMAP.md section 3, departure 7: a
     packed lane's params are not a standalone run's bits).  Prints both
     walls.
  8a. Phase 7's int8 FedAvg lane (seed 1), its final params evaluated two
     ways on the card: ``Evaluator`` (one forward per batch) and
     ``StackedEvaluator`` (the sweep's own last stacked evaluation); the
     eval points on which their argmaxes differ must be 0.  Prints them,
     the logits' difference, and the params' and predictions' difference
     from the same trial run alone.
  9. The reduced smoke preset (``launch/sweep.py --preset smoke --limit
     8``) on the card and on the CPU: the same (M, E) and costs, accuracy
     within 0.01.

After phase 9, ``fed_reduce`` is held against its plain version at the
sweep's own launch (phase 7's first FedAvg-group launch: its weights, rows,
segments and int8 lanes, T=16, N=40,718), with the int8 lanes (the plain
pre-pass and the kernel alone timed as well) and without.

  10. Trial serving at full width (``serve_phase``): a staggered queue of 16
     trials (10 sync, 6 async/buffered; the sweep's 40,718-param MLP over
     the full federation) through the continuous-batching scheduler with 6
     lanes on the card.  An uninterrupted drain with a snapshot before
     every step (wall, trials/s, trial-rounds/s, occupancy, snapshot bytes
     and ms, every ``fed_reduce`` (T, M, N) and ``fed_aggregate`` launch,
     both > 0); the same drain killed half-way and restored on the card
     (the store must equal the uninterrupted one row for row, at most one
     step replayed, restore under 1 s); every trial run alone (the same
     records, accuracy exact or within 0.01, eval points that differ
     counted); a traced drain with NVTX ranges (the same store, a trace
     valid against ``trace_schema.json``, the wall split by span); a
     bf16 checkpoint round trip on the card.
  11. Federated LM training through ``launch/steps.make_fl_train_step``
     (remat, f32, params drawn on the card from a seed): gemma2-2b at full
     width and depth (26 layers, 2.61 B params) and recurrentgemma-9b cut
     to its first 6 layers (two rg-lru/rg-lru/attn cycles, every width
     kept, 2.23 B params), each B=2 x S=4096 with FedAvg weights [1, 2],
     3 rounds.  The counts are set to 0 before each step and read after:
     a step launches ``flash_attention`` twice per attention layer (the
     pass and its recompute) and its backward once, ``rglru_scan`` twice
     per RG-LRU layer and its backward once (gemma2: 52 and 26;
     recurrentgemma: 4 and 2, 8 and 4).  Loss, params and momentum (so
     the gradients) must be finite.  Prints step seconds, training
     tokens/s (B x S x E over the step's wall), the loss per round and the
     peak memory.
  11a. The same step reduced to 3 layers (gemma2-2b, recurrentgemma-9b;
     B=2, S=256) on the card and on the CPU from the same init params:
     loss within 1e-4, every gradient leaf within 1e-4 of its max-abs, and
     one ``fl_train_step``'s params and momentum likewise.

  12. The paper's ResNets and its speech-command FedTune experiment.
     12a: ResNet-10/18/26/34 (32x32x1, 35 classes) and ResNet-10/18 in
     CIFAR-100's shape (3 channels, 100 classes), B=32, on the card and on
     the CPU from the same params, with torch's default
     ``cudnn.allow_tf32 = True`` in force: the tree's parameter count
     (79,259 / 177,659 / 276,059 / 336,411); every convolution of the
     card's forward and backward within 1e-4 of the same call in f64 on
     the CPU (of the result's max-abs); logits and loss within 1e-4; two
     card backward passes bitwise equal; the gradients' difference from
     the CPU's beside the CPU's own change under a 1e-6 nudge of the
     params (ReLU flips); forward+backward ms.  12b: ResNet-10 over the
     full ``speech_command_like`` federation (2,112 clients) with
     ``examples/fedtune_speech.py``'s settings, FedTune on, from one init:
     sync 5 rounds sequential and batched, async 10 aggregations and
     buffered K=8 2 flushes on the stragglers fleet, sync int8 3 rounds;
     per run rounds/s, local steps/s, the (M, E) trajectory, costs and
     both kernels' launches (each > 0 over the phase).  12c: the first 3
     sync rounds on the CPU against the card's, and batched against
     sequential on the card: (M, E) and cost totals equal, accuracy
     within 0.01.  12d: ``fed_reduce`` at ResNet's shapes (N = 79,259 at
     M = 5 and 20, N = 336,411 at M = 20, and the int8 round trip over
     32 and 104 leaves with the plain pre-pass and the kernel timed
     apart) and ``fed_aggregate`` at M=1, N=79,259, bitwise, with phase
     2's columns.

  13. The sharded FedTune path on the card: two ranks spawned by
     ``launch.mesh.run_ranks`` (after the build, so they load the built
     library), both on ``cuda:0`` over gloo with CUDA tensors, each
     reporting its device, its ``fed_reduce`` launches and its sharded
     rounds per case (each > 0: the sharded route ran, not its batched
     fallback) and a hash of its final params (the two must be equal).
     13a: ``sharded_fedavg_train`` with ``MLP_EMNIST`` over the full
     ``emnist_like`` federation, a fixed cohort of 64 clients, E=2, batch
     10, SGD lr 0.03 momentum 0.9: within 1e-4 of ``batched_local_train``
     + FedAvg run here on the card, and the same call once more in a
     1-rank NCCL group here.  13b: phase 3's sync trial with
     ``client_exec="sharded"``: phase 3's (M, E) and costs, accuracy within
     0.01; rounds/s beside phase 3's.  13c: the ResNet-10 speech trial,
     int8 uploads, 2 rounds, sharded, against a batched run here; every
     first-round ``fed_reduce`` partial of each rank (32 int8 leaves)
     bitwise the plain version's.  13d: phase 7's 48-trial grid with
     ``pack="sharded"``, 5 rounds, against phase 7's records.  Then
     ``fed_reduce`` at a rank's shape from 13a (``sharded_rank_fedavg``:
     T=1, M=32, N=169,462) with phase 2's columns.
  2e. (Run after 2c.)  The bf16 kernels against their plain versions on
     the same bf16 inputs: ``flash_attention`` within 8e-3 of the plain
     output's max-abs and, element by element, within 2 bf16 ulps plus
     1e-3 of its row's max-abs, at gemma2-2b's global layer (B=2, H=8,
     Kh=4, S=T=4096, D=256, cap 50) and local one (window 4096),
     recurrentgemma-9b's local layer (16/1, window 2048), a ragged S=4000
     and a 32k prefill (B=1, gemma2 global, S=T=32,768; checked on its
     first and last 512 rows, the plain version run in 512-row blocks);
     ``flash_attention_bwd`` within 2e-2 of each gradient's max-abs and
     of each row's (a query's dq, a key's dk and dv), and bitwise equal to
     itself (gemma2's two layers, recurrentgemma's local layer,
     seamless-m4t's non-causal cross-attention 16/16, S=512, T=1024,
     D=64); ``rglru_scan`` bitwise (B=2, T=4096, W=4096 and 4099; T=1).
     Each attention case also plants faults in the plain result and fails
     unless these limits reject them: the second half of the rows computed
     with one 64-key V tile read as zeros (the forward and dq), and dv's
     last quarter of keys written as zeros.  Each case: card, plain and library ms (SDPA in bf16 with the
     mask explicit; none under a cap or for the scan; timed in turns with
     the kernel, with the spread of its calls) and the bf16 bound (bytes
     at 3.35 TB/s, 4 D or 10 D flops a live pair at 989 TFLOP/s) with its
     share, ptxas's report of the kernel, and for the backward its launch
     plan and the device kernels of one call (``torch.profiler``; it fails
     on none or more than two).
  14. The production steps at bf16 (``launch/steps.py``'s default dtype).
     14a: phase 11's two training cells with bf16 params and f32 momentum,
     the same exact launch counts on the bf16 kernels (52 + 26 for
     gemma2-2b, every attention launch bf16; the scans stay f32), finite
     loss, params and momentum; step seconds, tokens/s and peak memory
     beside phase 11's from this run.  14b: the reduced step (3 layers,
     B=2 x S=256) at bf16 card vs CPU from the same params: loss within
     1e-2 relative, every gradient leaf within 3e-2 of its max-abs (each
     side's distance from the f32 gradient printed); then one step with
     microbatches=2, local_passes=2: momentum within 3e-2, params within
     2 bf16 ulps plus lr x 3e-2 x max |m|.  14c: ``make_prefill_step`` and
     ``make_serve_step`` for gemma2-2b and recurrentgemma-9b at full width
     and depth: a 4,096-token prompt at B=2 into a 32,768-position cache
     (exact bf16 launch counts), 32 serve steps at B=8 with bf16 weights,
     the last within 5e-2 of a re-prefill over prompt + tokens, and the
     same 32 steps from int8 weights within 5e-2 of the bf16 ones; prefill
     tokens/s from the median of three calls after one to warm up, decode
     tokens/s from the median step, and peak memory.
  15. The LM steps on ``("data", "model")`` device meshes (DTensor): 15a
     joins a 1-rank NCCL group in this process and makes a (1, 1) mesh;
     phase 14a's bf16 gemma2-2b step at full width and depth (B=2 x
     S=4,096, f32 momentum, the same init and batches) runs two rounds on
     one device and then two through ``make_fl_train_step(mesh=...)``:
     losses and params bitwise (else within 14b's limits, and the line
     says it), 52 + 26 bf16 attention launches a step on both, one more
     mesh step under ``torch.profiler`` seeing the forward and backward
     kernels, step seconds and peak beside the one-device run's and 14a's;
     then 14c's bf16 prefill (B=2, 4,096 tokens into 32,768 positions)
     and 8 serve steps on one device and through the mesh, logits bitwise
     (else within 5e-2), the median serve step and the decode's peak on
     each side.  A (1, 1) mesh shards nothing, so the kernels' sharded
     paths are not run here.  Two ranks sharing the card are not run:
     DTensor's all-gather of a CUDA tensor over gloo kills the rank
     (ROADMAP.md, departure 14).

The last three lines are the card's name and power limit (as nvidia-smi
gives them), the kernels' JSON summary (six entries: ``fed_reduce``,
``fed_aggregate``, ``flash_attention``, ``rglru_scan``,
``flash_attention_bwd`` and ``rglru_scan_bwd``; the launches are the main
path's, phase 11's training steps and phase 12's and 13's trials (both
ranks) included; each entry's ``launches_bf16`` counts its bf16 kernel's
launches in phases 14 and 15, and ``bf16`` holds that kernel's source, phase-2e
numbers and parity) and
``{"ok": true, "device": {...}}``.  Without a GPU, or without the port's sources beside this file,
it exits 1 and prints no result.

    python3 chip_smoke.py --baseline OLD/src/repro_torch/kernels/csrc

also builds another checkout's ``fed_reduce``, ``fed_aggregate``,
``flash_attention_bwd`` and, where it has them, bf16 attention kernels
(``flash_attention_bf16.cu``, ``flash_attention_bwd_bf16.cu`` with its
own ``attn_bf16.cuh``) and times them beside this checkout's on every
phase-2 case, every phase-2c attention case and every phase-2e attention
case, in turns (old, new, new, old), each through its own C entry point
(an older attention backward takes a (B, H, S) delta buffer where this one
takes the scratch its planner sizes); each case's line then carries
``old_ms`` and ``new_ms`` (two each) and whether the old kernel ran and
agreed (bitwise for the FedTune kernels, within 1e-4 of each gradient's
max-abs against the plain version for the f32 backward, within phase
2e's limits for the bf16 kernels).
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12             # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12           # H100 SXM TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12           # H100 SXM bf16 tensor cores, dense
N_PARAMS = 169_462                  # MLP_EMNIST: 784 -> 200 -> 62


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    """The least time (ms) the card could take, and what sets it: the
    bytes over HBM bandwidth or the operations over their peak rate (f32
    outside the tensor cores unless another rate is given)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def median_ms(torch, fn, flush, iters: int = 30, warmup: int = 3) -> float:
    """Median time of one ``fn()`` on the card.  Before each timed call a
    256 MB memset (``flush``; None skips it) evicts the 50 MB L2 and keeps
    the stream busy while the host enqueues ``fn``, so the event pair
    brackets the device work (and whatever host gaps ``fn`` itself leaves
    between its own launches)."""
    ms = times_ms(torch, fn, flush, iters, warmup)
    return ms[len(ms) // 2]


def times_ms(torch, fn, flush, iters: int = 30, warmup: int = 3):
    """``median_ms``'s timings of ``iters`` calls, sorted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in times)


def launch_floor_ms(torch, flush) -> float:
    """One one-element PyTorch kernel launch under ``median_ms``: the least
    that any launch costs in this harness."""
    one = torch.zeros(1, dtype=torch.float32, device="cuda")
    return median_ms(torch, lambda: one.add_(1.0), flush, iters=50)


def raw_call(torch, fn, *args):
    """A closure that launches a kernel through its C entry point on the
    current stream and raises on a CUDA error."""
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(*args, 0, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return run


def old_vs_new(torch, flush, old, new, check_old):
    """Times two launches of the same case in turns (old, new, new, old).
    An old kernel that refuses the case is reported, not timed."""
    try:
        old()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return dict(old_ran=False, old_error=str(e),
                    new_ms=[median_ms(torch, new, flush) for _ in range(2)])
    turns = [median_ms(torch, f, flush) for f in (old, new, new, old)]
    return dict(old_ran=True, old_equal=check_old(),
                old_ms=[turns[0], turns[3]], new_ms=[turns[1], turns[2]])


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def fed_reduce_case(torch, card, flush, floor, name, w, rows, seg, t_seg,
                    base, normalize, quant=None, leaf_sizes=None,
                    old_lib=None):
    """``fed_reduce`` on (w, rows, seg) held bitwise against its plain
    version, timed beside its plain version and one ``torch.index_add``,
    with its bound.  ``quant`` is (quant_ref, quant_enabled): the int8 round
    trip of compressed lanes, a plain pre-pass (``ref._quant_rows``) before
    the kernel, whose time and the kernel's alone are recorded too."""
    from repro_torch.kernels import build
    from repro_torch.kernels import fed_reduce as fr_mod
    from repro_torch.kernels import ref

    dev = rows.device
    m, n = rows.shape
    kw = dict(normalize=normalize)
    if quant is not None:
        kw.update(leaf_sizes=leaf_sizes, quant_ref=quant[0],
                  quant_enabled=quant[1])
    got = fr_mod.fed_reduce(w, rows, seg, t_seg, base, **kw)
    want = ref.fed_reduce_ref(w, rows, seg, t_seg, base, **kw)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    check(equal, f"fed_reduce {name}: kernel != plain version "
                 f"(max abs err {err})")
    # the library yardstick: the fold as one index_add of w~ * x
    w_n = ref._norm_weights(w, seg.tolist(), t_seg, normalize)
    x = rows if quant is None else ref._quant_rows(
        rows, seg, quant[0], quant[1], leaf_sizes)
    wx = w_n[:, None] * x
    acc0 = base if base is not None else torch.zeros(
        (t_seg, n), dtype=torch.float32, device=dev)
    seg_l = seg.long()
    nbytes = 4 * (m * n + 2 * m + t_seg * n * (2 if base is not None
                                               else 1))
    flops = 2 * m * n + (t_seg * n if base is not None else 0)
    if quant is not None:
        nbytes += 4 * t_seg * n + m         # quant_ref, quant mask
    bound_ms, bound_by = bound(nbytes, flops)
    rec = dict(
        phase="kernel_check", kernel="fed_reduce", case=name,
        shape=dict(M=m, N=n, T=t_seg), normalize=normalize,
        base=base is not None, quant=quant is not None,
        check="bitwise", equal=equal, max_abs_err=err,
        ms=median_ms(torch, lambda: fr_mod.fed_reduce(
            w, rows, seg, t_seg, base, **kw), flush),
        plain_ms=median_ms(torch, lambda: ref.fed_reduce_ref(
            w, rows, seg, t_seg, base, **kw), flush, iters=10),
        library_ms=median_ms(torch, lambda: torch.index_add(
            acc0, 0, seg_l, wx), flush),
        library_call="torch.index_add(base, 0, seg, w~*x) "
                     "(fold only, w~*x precomputed)",
        bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
        launch_floor_ms=floor, card=card)
    if quant is not None:
        plain_kw = dict(kw, leaf_sizes=None, quant_ref=None,
                        quant_enabled=None)
        rec.update(
            prepass_ms=median_ms(torch, lambda: ref._quant_rows(
                rows, seg, quant[0], quant[1], leaf_sizes), flush),
            kernel_alone_ms=median_ms(torch, lambda: fr_mod.fed_reduce(
                w, x, seg, t_seg, base, **plain_kw), flush))
    if old_lib is not None:
        seg_i = seg.to(torch.int32).contiguous()
        outs = {}

        def c_call(lib, key):
            out = torch.empty((t_seg, n), dtype=torch.float32, device=dev)
            outs[key] = out
            return raw_call(torch, lib.fed_reduce_f32, w.data_ptr(),
                            x.data_ptr(), seg_i.data_ptr(),
                            None if base is None else base.data_ptr(),
                            out.data_ptr(), m, n, t_seg, int(normalize))
        rec.update(old_vs_new(
            torch, flush, c_call(old_lib, "old"),
            c_call(build.library(), "new"),
            lambda: bool(torch.equal(outs["old"], want))))
    emit(rec)
    return rec


def fed_aggregate_case(torch, card, flush, floor, name, w, d, base,
                       old_lib=None):
    """``fed_aggregate`` on (w, d, base) held bitwise against its plain
    version, timed beside its plain version and one ``torch.addmv``, with
    its bound."""
    from repro_torch.kernels import build
    from repro_torch.kernels import fed_aggregate as fa_mod
    from repro_torch.kernels import ref

    m, n = d.shape
    got = fa_mod.fed_aggregate(w, d, base)
    want = ref.fed_aggregate_ref(w, d, base)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    check(equal, f"fed_aggregate {name}: kernel != plain version "
                 f"(max abs err {err})")
    nbytes = 4 * (m * n + m + 2 * n)
    flops = 2 * m * n + n
    bound_ms, bound_by = bound(nbytes, flops)
    dt = d.t()
    rec = dict(
        phase="kernel_check", kernel="fed_aggregate", case=name,
        shape=dict(M=m, N=n), check="bitwise", equal=equal,
        max_abs_err=err,
        ms=median_ms(torch, lambda: fa_mod.fed_aggregate(w, d, base),
                     flush),
        plain_ms=median_ms(torch, lambda: ref.fed_aggregate_ref(
            w, d, base), flush),
        library_ms=median_ms(torch, lambda: torch.addmv(base, dt, w),
                             flush),
        library_call="torch.addmv(base, deltas.T, w)",
        bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
        launch_floor_ms=floor, card=card)
    if old_lib is not None:
        outs = {}

        def c_call(lib, key):
            out = torch.empty((n,), dtype=torch.float32, device=d.device)
            outs[key] = out
            return raw_call(torch, lib.fed_aggregate_f32, w.data_ptr(),
                            d.data_ptr(), base.data_ptr(), out.data_ptr(),
                            m, n)
        rec.update(old_vs_new(
            torch, flush, c_call(old_lib, "old"),
            c_call(build.library(), "new"),
            lambda: bool(torch.equal(outs["old"], want))))
    emit(rec)
    return rec


def kernel_cases(torch, np, card, flush, old_lib=None):
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = N_PARAMS
    leaf_sizes = (200, 784 * 200, 62, 200 * 62)      # b0, w0, b1, w1
    floor = launch_floor_ms(torch, flush)
    emit(dict(phase="kernel_check", case="launch_floor",
              launch_floor_ms=floor,
              call="torch.zeros(1).add_(1.0) on the card", card=card))
    results = []

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    def reduce_case(name, m, t_seg, seg, w, rows, base, normalize,
                    quant=None):
        results.append(fed_reduce_case(
            torch, card, flush, floor, name, w, rows, seg, t_seg, base,
            normalize, quant, leaf_sizes, old_lib))

    # FedAvg: T=1, M=20 raw counts, normalize, no base
    m = 20
    reduce_case("fedavg", m, 1, t(np.zeros(m, np.int32)),
                t(rng.integers(1, 300, m).astype(np.float32)),
                t(rng.standard_normal((m, n)).astype(np.float32) * 0.05),
                None, True)
    # FedBuff flush: T=1, M=8 staleness weights, base, no normalize
    m = 8
    reduce_case("fedbuff_flush", m, 1, t(np.zeros(m, np.int32)),
                t(rng.uniform(0.05, 0.125, m).astype(np.float32)),
                t(rng.standard_normal((m, n)).astype(np.float32) * 1e-3),
                t(rng.standard_normal((1, n)).astype(np.float32) * 0.05),
                False)
    # packed cohort: T=8, M=64 interleaved, segment 5 empty, one zero
    # weight, int8 round trip with a per-row quant mask
    m, t_seg = 64, 8
    seg = rng.choice([0, 1, 2, 3, 4, 6, 7], m).astype(np.int32)
    w = rng.uniform(1.0, 300.0, m).astype(np.float32)
    w[17] = 0.0
    g = rng.standard_normal((t_seg, n)).astype(np.float32) * 0.05
    rows = g[seg] + rng.standard_normal((m, n)).astype(np.float32) * 1e-2
    reduce_case("packed_quant", m, t_seg, t(seg), t(w), t(rows), t(g),
                True, quant=(t(g), t(np.arange(m) % 3 != 0)))

    # packed sweeps at full width: T=32 lanes packed lane by lane (the sweep
    # engine's layout), raw counts normalised per lane, no base, no quant;
    # drawn on the card from a seed.  M=3,200 is more than three times the
    # rows a block of the kernel lists at a time.
    for name, per in (("packed_sweep", 90), ("rows_over_3000", 100)):
        t_seg = 32
        m = t_seg * per
        gen = torch.Generator(device=dev).manual_seed(m)
        rows = torch.randn((m, n), generator=gen, device=dev) * 0.05
        w = torch.rand(m, generator=gen, device=dev) * 299.0 + 1.0
        seg = torch.arange(t_seg, dtype=torch.int32,
                           device=dev).repeat_interleave(per)
        reduce_case(name, m, t_seg, seg, w, rows, None, True)
        del rows, w, seg
        torch.cuda.empty_cache()

    def aggregate_case(name, m):
        results.append(fed_aggregate_case(
            torch, card, flush, floor, name,
            t(rng.uniform(0.0, 1.0, m).astype(np.float32)),
            t(rng.standard_normal((m, n)).astype(np.float32) * 0.05),
            t(rng.standard_normal(n).astype(np.float32) * 0.05), old_lib))

    aggregate_case("fedasync_mix", 1)
    aggregate_case("m16", 16)
    return results, floor


# ---------------------------------------------------------------------------
# phase 2b: the LM kernels against their plain versions
# ---------------------------------------------------------------------------

def live_pairs(s: int, t: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps, query i at key i + (t - s)."""
    total = 0
    for i in range(s):
        qk = i + t - s
        hi = min(t - 1, qk) if causal else t - 1
        lo = max(0, qk - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def lm_kernel_cases(torch, np, card, flush):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fl_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as sc_mod

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    results = []

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    def scan_case(name, b, t_len, w):
        a = t(rng.uniform(0.9, 0.999, (b, t_len, w)).astype(np.float32))
        x = t((rng.standard_normal((b, t_len, w)) * 0.1).astype(np.float32))
        got = sc_mod.rglru_scan(a, x)
        want = ref.rglru_scan_ref(a, x)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        check(equal, f"rglru_scan {name}: kernel != plain version "
                     f"(max abs err {err})")
        n = b * t_len * w
        nbytes, flops = 12 * n, 2 * n
        bound_ms, bound_by = bound(nbytes, flops)
        rec = dict(
            phase="kernel_check", kernel="rglru_scan", case=name,
            shape=dict(B=b, T=t_len, W=w), check="bitwise", equal=equal,
            max_abs_err=err,
            ms=median_ms(torch, lambda: sc_mod.rglru_scan(a, x), flush),
            plain_ms=median_ms(torch, lambda: ref.rglru_scan_ref(a, x),
                               flush, iters=5, warmup=1),
            library_ms=None,
            library_call="none: PyTorch has no one-call linear recurrence",
            bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
            card=card)
        emit(rec)
        results.append(rec)

    scan_case("recurrentgemma_prefill", 2, 4096, 4096)
    scan_case("ragged_w4099", 2, 4096, 4099)
    scan_case("t1", 2, 1, 4096)

    def sdpa(q, k, v, causal, window, s_len, t_len):
        """The library yardstick: one SDPA call with the mask explicit."""
        qk = torch.arange(s_len, device=dev)[:, None] + (t_len - s_len)
        kp = torch.arange(t_len, device=dev)[None, :]
        mask = torch.ones((s_len, t_len), dtype=torch.bool, device=dev)
        if causal:
            mask &= kp <= qk
        if window is not None:
            mask &= kp > qk - window
        g = q.shape[1] // k.shape[1]
        kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        return lambda: F.scaled_dot_product_attention(q, kk, vv,
                                                      attn_mask=mask)

    def attn_case(name, b, h, kh, s_len, t_len, d, causal, window, cap):
        q = t(rng.standard_normal((b, h, s_len, d)).astype(np.float32))
        k = t(rng.standard_normal((b, kh, t_len, d)).astype(np.float32))
        v = t(rng.standard_normal((b, kh, t_len, d)).astype(np.float32))
        kw = dict(causal=causal, window=window, cap=cap)
        got = fl_mod.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5))
        check(ok, f"flash_attention {name}: kernel vs plain version beyond "
                  f"rtol=atol=2e-5 (max abs err {err})")
        pairs = live_pairs(s_len, t_len, causal, window) * b * h
        flops = 4 * d * pairs
        nbytes = 4 * d * (2 * b * h * s_len + 2 * b * kh * t_len)
        # the kernel's route: every product is three TF32 tensor-core passes
        bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
        simt_ms, _ = bound(nbytes, flops)
        lib = None if cap is not None else sdpa(q, k, v, causal, window,
                                                s_len, t_len)
        rec = dict(
            phase="kernel_check", kernel="flash_attention", case=name,
            shape=dict(B=b, H=h, Kh=kh, S=s_len, T=t_len, D=d),
            causal=causal, window=window, cap=cap,
            check="rtol=atol=2e-5", equal=bool(torch.equal(got, want)),
            max_abs_err=err,
            ms=median_ms(torch, lambda: fl_mod.flash_attention(q, k, v, **kw),
                         flush, iters=10),
            plain_ms=median_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, **kw), flush, iters=5, warmup=1),
            library_ms=None if lib is None else median_ms(torch, lib, flush,
                                                          iters=10),
            library_call=("none: scaled_dot_product_attention has no "
                          "soft-cap") if lib is None else
            "F.scaled_dot_product_attention(q, k, v, attn_mask=window mask)"
            " (k, v repeated to H heads outside the timing)",
            live_pairs=pairs, bytes=nbytes, flops=flops, bound_ms=bound_ms,
            bound_by=bound_by, bound_route="tf32x3: 3 x flops at 495 TFLOP/s",
            bound_f32_simt_ms=simt_ms, card=card)
        emit(rec)
        results.append(rec)
        del q, k, v, got, want
        torch.cuda.empty_cache()

    attn_case("recurrentgemma_local", 2, 16, 1, 4096, 4096, 256, True, 2048,
              None)
    attn_case("gemma2_global", 2, 8, 4, 4096, 4096, 256, True, None, 50.0)
    attn_case("ragged_s4000", 2, 16, 1, 4000, 4000, 256, True, 2048, None)
    attn_case("small_noncausal", 1, 4, 2, 256, 256, 64, False, None, None)
    # the rest of the LM zoo's shapes (phase 5b's prefills)
    attn_case("granite_moe", 2, 16, 8, 4096, 4096, 64, True, None, None)
    attn_case("dbrx", 2, 48, 8, 2048, 2048, 128, True, None, None)
    attn_case("seamless_encoder", 2, 16, 16, 1024, 1024, 64, False, None,
              None)
    attn_case("seamless_cross", 2, 16, 16, 512, 1024, 64, False, None, None)
    attn_case("internvl2_prefix", 2, 14, 2, 2304, 2304, 64, True, None,
              None)
    return results


# ---------------------------------------------------------------------------
# phase 2e: the bf16 kernels against their plain versions
# ---------------------------------------------------------------------------

def chunked_attention_ref(ref, q, k, v, rows, **kw):
    """The plain attention of causal self-attention (S == T) for query rows
    ``rows`` (a slice): the queries against the keys they can see, so that
    a 32k prefill is checked without its (S, T) score matrix."""
    return ref.flash_attention_ref(q[:, :, rows], k[:, :, :rows.stop],
                                   v[:, :, :rows.stop], **kw)


def bf16_kernel_cases(torch, np, card, flush, ptxas, old_lib=None):
    """Phase 2e: the bf16 kernels at the bf16 production steps' shapes, each
    held against its plain version on the same bf16 inputs (attention within
    8e-3 of the plain output's max-abs and within 2 bf16 ulps plus 1e-3 of
    its row's max-abs element by element; the backward within 2e-2 of each
    gradient's max-abs and of each row's, and bitwise equal to itself run
    twice; the scan bitwise), with card, plain and library ms and the bound
    at bf16: the larger of the bytes at 3.35 TB/s and the bf16 operations
    at 989 TFLOP/s (4 D flops a live pair forward, 10 D backward).  The
    whole-tensor measure alone is too coarse: a causal output's largest
    value is v[0] in row 0, about as large as a late row's whole spread.
    Every attention case plants faults in the plain result (a 64-key V
    tile read as zeros on the second half of the rows; dv's last quarter
    of keys zeroed) and fails unless the element and row limits reject
    them.  Each attention record carries ptxas's report of its kernel and,
    for the backward, its launch plan and the device kernels of one call
    (``torch.profiler``; one or two).  Where SDPA computes the function it
    is timed in turns with the kernel (kernel, SDPA, SDPA, kernel), each a
    median of as many calls, with the spread of its calls.  With
    ``old_lib`` (``--baseline``) an older checkout's bf16 kernels are timed
    beside these in turns (old, new, new, old), each through its own C
    entry point, and held to the same limits."""
    import ctypes

    import torch.nn.functional as F

    from repro_torch.kernels import build

    from repro_torch.kernels import flash_attention as fl_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as sc_mod
    from repro_torch.kernels.parity import (BF16_ROW_FLOOR, bf16_ulps,
                                            rel_err, row_floor, row_rel_err)

    dev = torch.device("cuda")
    bf = torch.bfloat16
    g_rng = torch.Generator(device="cuda").manual_seed(22)
    results = []
    t_phase = time.perf_counter()

    def randn(*shape):
        return torch.randn(*shape, generator=g_rng, device=dev).to(bf)

    def mask_of(causal, window, s_len, t_len):
        qk = torch.arange(s_len, device=dev)[:, None] + (t_len - s_len)
        kp = torch.arange(t_len, device=dev)[None, :]
        mask = torch.ones((s_len, t_len), dtype=torch.bool, device=dev)
        if causal:
            mask &= kp <= qk
        if window is not None:
            mask &= kp > qk - window
        return mask

    def late_tile_zeroed(q, k, v, want, kw):
        """The plain output with the second half of its rows computed from
        a V whose 64 keys before the middle are zeros: a kernel that read
        one stale tile on late rows."""
        t0 = max(k.shape[2] // 2 - 64, 0)
        vz = v.clone()
        vz[:, :, t0:t0 + 64] = 0
        bad = want.clone()
        half = q.shape[2] // 2
        bad[:, :, half:] = ref.flash_attention_ref(q, k, vz, **kw)[
            :, :, half:]
        return bad, vz

    outs = {}

    def library_turns(kernel_fn, lib):
        """The kernel and the library call in turns (kernel, library,
        library, kernel), medians of 10 calls each, and the library's
        spread over its 20 calls."""
        k1 = times_ms(torch, kernel_fn, flush, 10)
        l1 = times_ms(torch, lib, flush, 10)
        l2 = times_ms(torch, lib, flush, 10)
        k2 = times_ms(torch, kernel_fn, flush, 10)
        med = sorted(l1 + l2)
        return dict(library_ms=med[len(med) // 2],
                    library_turns_ms=[l1[5], l2[5]],
                    kernel_turns_ms=[k1[5], k2[5]],
                    library_spread_ms=[med[0], med[-1]])

    def fwd_call(lib_, key, q, k, v, kw):
        """The forward through a library's C entry point (its signature
        has not changed since the bf16 kernels came)."""
        o = torch.empty_like(q)
        outs[key] = o
        w, cap = kw["window"], kw["cap"]
        return raw_call(
            torch, lib_.flash_attention_bf16, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), None, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], q.shape[0],
            q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
            int(kw["causal"]), 0 if w is None else int(w),
            float(q.shape[3] ** -0.5), 0.0 if cap is None else float(cap))

    def fwd_agrees(o, q, k, v, kw, check_rows):
        """The phase's forward limits on an output."""
        s_len = q.shape[2]
        spans = [slice(0, s_len)] if check_rows is None else [
            slice(0, check_rows), slice(s_len - check_rows, s_len)]
        for rows in spans:
            want = chunked_attention_ref(ref, q, k, v, rows, **kw) \
                if check_rows else ref.flash_attention_ref(q, k, v, **kw)
            if rel_err(o[:, :, rows], want) > 8e-3 or bf16_ulps(
                    o[:, :, rows], want, row_floor(want, BF16_ROW_FLOOR)) > 2.0:
                return False
        return True

    def bwd_call(lib_, key, q, k, v, out, lse, dout, kw):
        """The backward through a library's C entry point: an older one
        takes a (B, H, S) delta buffer, this one the scratch its planner
        sizes."""
        b, h, s_len, d = q.shape
        kh, t_len = k.shape[1], k.shape[2]
        w, cap = kw["window"], kw["cap"]
        if hasattr(lib_, "flash_attention_bwd_plan_bf16"):
            info = (ctypes.c_longlong * 5)()
            nbytes = lib_.flash_attention_bwd_plan_bf16(
                b, h, kh, s_len, t_len, d, 0 if w is None else int(w), info)
            work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        else:
            work = torch.empty(b * h * s_len, dtype=torch.float32,
                               device=dev)
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
        outs[key] = grads
        strides = (ctypes.c_longlong * 24)(*(
            st for x in (q, k, v, out, dout, *grads) for st in x.stride()[:3]))
        return raw_call(
            torch, lib_.flash_attention_bwd_bf16, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            work.data_ptr(), *(x.data_ptr() for x in grads), strides, b, h,
            kh, s_len, t_len, d, int(kw["causal"]), 0 if w is None else int(w),
            float(d ** -0.5), 0.0 if cap is None else float(cap))

    def device_kernels(fn):
        """The names of the device kernels one call of ``fn`` runs."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    def attn_case(name, b, h, kh, s_len, t_len, d, causal, window, cap,
                  check_rows=None):
        q, k, v = randn(b, h, s_len, d), randn(b, kh, t_len, d), \
            randn(b, kh, t_len, d)
        kw = dict(causal=causal, window=window, cap=cap)
        got = fl_mod.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        fault = None
        if check_rows is None:
            plain = lambda: ref.flash_attention_ref(q, k, v, **kw)  # noqa
            want = plain()
            err = rel_err(got, want)
            ulps = bf16_ulps(got, want, row_floor(want, BF16_ROW_FLOOR))
            bad, _ = late_tile_zeroed(q, k, v, want, kw)
            fault = dict(what="late rows with one 64-key V tile read as 0",
                         rel_err=rel_err(bad, want),
                         bf16_ulps=bf16_ulps(bad, want, row_floor(
                             want, BF16_ROW_FLOOR)))
            check(fault["bf16_ulps"] > 2.0,
                  f"flash_attention bf16 {name}: the element check misses "
                  f"a planted fault ({fault})")
            del want, bad
        else:           # the plain version on row blocks (no S x T matrix)
            def plain():
                for r0 in range(0, s_len, check_rows):
                    chunked_attention_ref(ref, q, k, v,
                                          slice(r0, r0 + check_rows), **kw)
            err = ulps = 0.0
            for rows in (slice(0, check_rows),
                         slice(s_len - check_rows, s_len)):
                want = chunked_attention_ref(ref, q, k, v, rows, **kw)
                err = max(err, rel_err(got[:, :, rows], want))
                ulps = max(ulps, bf16_ulps(got[:, :, rows], want, row_floor(
                    want, BF16_ROW_FLOOR)))
        check(err <= 8e-3, f"flash_attention bf16 {name}: kernel vs plain "
                           f"version {err} > 8e-3 of max-abs")
        check(ulps <= 2.0, f"flash_attention bf16 {name}: kernel vs plain "
                           f"version {ulps} bf16 ulps beyond "
                           f"{BF16_ROW_FLOOR} of the row's max-abs")
        pairs = live_pairs(s_len, t_len, causal, window) * b * h
        flops = 4 * d * pairs
        nbytes = 2 * d * (2 * b * h * s_len + 2 * b * kh * t_len)
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        lib = None
        if cap is None:
            mask = mask_of(causal, window, s_len, t_len)
            g = h // kh
            kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, kk, vv, attn_mask=mask)
        kernel_fn = lambda: fl_mod.flash_attention(q, k, v, **kw)  # noqa
        ms = median_ms(torch, kernel_fn, flush, iters=10)
        lib_rec = {} if lib is None else library_turns(kernel_fn, lib)
        old_rec = {}
        if old_lib is not None and hasattr(old_lib, "flash_attention_bf16"):
            old_rec = old_vs_new(
                torch, flush, fwd_call(old_lib, "old", q, k, v, kw),
                fwd_call(build.library(), "new", q, k, v, kw),
                lambda: fwd_agrees(outs["old"], q, k, v, kw, check_rows))
            outs.clear()
        rec = dict(
            phase="bf16_kernel_check", kernel="flash_attention", case=name,
            dtype="bfloat16", shape=dict(B=b, H=h, Kh=kh, S=s_len, T=t_len,
                                         D=d),
            causal=causal, window=window, cap=cap,
            check="8e-3 of the plain output's max-abs; element by element "
                  f"2 bf16 ulps plus {BF16_ROW_FLOOR} of the row's max-abs" + (
                "" if check_rows is None else
                f" (first and last {check_rows} rows)"),
            max_abs_err=err, bf16_ulps=ulps, planted_fault=fault, ms=ms,
            plain_ms=median_ms(torch, plain, flush, iters=3, warmup=1),
            plain_call="ref.flash_attention_ref" + (
                "" if check_rows is None else
                f" in blocks of {check_rows} query rows"),
            library_ms=lib_rec.pop("library_ms", None),
            library_call="none: scaled_dot_product_attention has no "
                         "soft-cap" if lib is None else
            "F.scaled_dot_product_attention(q, k, v, attn_mask=mask) in "
            "bf16 (k, v repeated to H heads outside the timing)",
            live_pairs=pairs, bytes=nbytes, flops=flops, bound_ms=bound_ms,
            bound_by=bound_by, bound_share=bound_ms / ms,
            bound_route="4 D flops a live pair at 989 TFLOP/s (bf16); the "
                        "kernel runs P V twice (P = hi + lo): 6 D",
            ptxas=ptxas_of(ptxas, f"flash_attention_bf16_kernelILi{d}E"),
            **lib_rec, **old_rec, card=card)
        emit(rec)
        results.append(rec)
        del q, k, v, got
        torch.cuda.empty_cache()

    attn_case("gemma2_global", 2, 8, 4, 4096, 4096, 256, True, None, 50.0)
    attn_case("gemma2_local", 2, 8, 4, 4096, 4096, 256, True, 4096, 50.0)
    attn_case("recurrentgemma_local", 2, 16, 1, 4096, 4096, 256, True, 2048,
              None)
    attn_case("ragged_s4000", 2, 16, 1, 4000, 4000, 256, True, 2048, None)
    attn_case("prefill_32k", 1, 8, 4, 32768, 32768, 256, True, None, 50.0,
              check_rows=512)

    def bwd_case(name, b, h, kh, s_len, t_len, d, causal, window, cap):
        q, k, v = randn(b, h, s_len, d), randn(b, kh, t_len, d), \
            randn(b, kh, t_len, d)
        dout = randn(b, h, s_len, d)
        kw = dict(causal=causal, window=window, cap=cap)
        out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        k_out, k_lse = fl_mod.flash_attention(q, k, v, return_lse=True, **kw)
        lse_err = float((k_lse - lse).abs().max())
        check(lse_err <= 1e-3, f"flash_attention bf16 {name}: lse off by "
                               f"{lse_err}")
        got = fl_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        again = fl_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        row_errs = [row_rel_err(g, w) for g, w in zip(got, want)]
        same = all(bool(torch.equal(g, a)) for g, a in zip(got, again))
        check(max(errs) <= 2e-2, f"flash_attention_bwd bf16 {name}: "
                                 f"(dq, dk, dv) off by {errs} > 2e-2")
        check(max(row_errs) <= 2e-2, f"flash_attention_bwd bf16 {name}: "
                                     f"(dq, dk, dv) rows off by {row_errs} "
                                     f"> 2e-2 of the row's max-abs")
        check(same, f"flash_attention_bwd bf16 {name}: two calls differ")
        # planted faults: dv's last quarter of keys zeroed; dq's late rows
        # from a V with one 64-key tile read as zeros
        dv_bad = want[2].clone()
        dv_bad[:, :, 3 * t_len // 4:] = 0
        _, vz = late_tile_zeroed(q, k, v, out, kw)
        dq_bad = want[0].clone()
        dq_bad[:, :, s_len // 2:] = ref.flash_attention_bwd_ref(
            q, k, vz, out, lse, dout, **kw)[0][:, :, s_len // 2:]
        faults = {
            "dv_last_quarter_zero": dict(rel_err=rel_err(dv_bad, want[2]),
                                         row_rel_err=row_rel_err(dv_bad,
                                                                 want[2])),
            "dq_late_rows_v_tile_zero": dict(
                rel_err=rel_err(dq_bad, want[0]),
                row_rel_err=row_rel_err(dq_bad, want[0]))}
        check(all(f["row_rel_err"] > 2e-2 for f in faults.values()),
              f"flash_attention_bwd bf16 {name}: the row check misses a "
              f"planted fault ({faults})")
        del dv_bad, dq_bad, vz
        pairs = live_pairs(s_len, t_len, causal, window) * b * h
        flops = 10 * d * pairs
        nbytes = 2 * d * (4 * b * h * s_len + 4 * b * kh * t_len) \
            + 4 * b * h * s_len
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        lib = None
        if cap is None:
            mask = mask_of(causal, window, s_len, t_len)
            g = h // kh
            qq = q.detach().requires_grad_(True)
            kk = k.repeat_interleave(g, 1).detach().requires_grad_(True)
            vv = v.repeat_interleave(g, 1).detach().requires_grad_(True)
            o_lib = F.scaled_dot_product_attention(qq, kk, vv,
                                                   attn_mask=mask)
            lib = lambda: torch.autograd.grad(  # noqa: E731
                o_lib, (qq, kk, vv), dout, retain_graph=True)
        kernel_fn = lambda: fl_mod.flash_attention_bwd(  # noqa: E731
            q, k, v, out, lse, dout, **kw)
        ms = median_ms(torch, kernel_fn, flush, iters=10)
        lib_rec = {} if lib is None else library_turns(kernel_fn, lib)
        # a profile that reads no kernel at all is taken again
        kernels = device_kernels(kernel_fn) or device_kernels(kernel_fn)
        check(1 <= len(kernels) <= 2, f"flash_attention_bwd bf16 {name}: "
                                      f"{len(kernels)} device kernels a call")
        old_rec = {}
        if old_lib is not None and hasattr(old_lib,
                                           "flash_attention_bwd_bf16"):
            def old_agrees():
                want_ = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                    **kw)
                return all(rel_err(g, w) <= 2e-2 and row_rel_err(g, w) <= 2e-2
                           for g, w in zip(outs["old"], want_))
            old_rec = old_vs_new(
                torch, flush,
                bwd_call(old_lib, "old", q, k, v, out, lse, dout, kw),
                bwd_call(build.library(), "new", q, k, v, out, lse, dout, kw),
                old_agrees)
            outs.clear()
        rec = dict(
            phase="bf16_kernel_check", kernel="flash_attention_bwd",
            case=name, dtype="bfloat16",
            shape=dict(B=b, H=h, Kh=kh, S=s_len, T=t_len, D=d),
            causal=causal, window=window, cap=cap,
            check="2e-2 of each gradient's max-abs and of each row's "
                  "(a query's dq, a key's dk and dv); bitwise run twice",
            max_abs_err=max(errs), rel_err_dq_dk_dv=errs,
            row_rel_err_dq_dk_dv=row_errs, planted_faults=faults,
            bitwise_twice=same,
            lse_max_abs_err=lse_err, ms=ms,
            plain_ms=median_ms(torch, lambda: ref.flash_attention_bwd_ref(
                q, k, v, out, lse, dout, **kw), flush, iters=3, warmup=1),
            library_ms=lib_rec.pop("library_ms", None),
            library_call="none: scaled_dot_product_attention has no "
                         "soft-cap" if lib is None else
            "the backward of F.scaled_dot_product_attention with the mask "
            "explicit, bf16 (autograd.grad, K/V repeated to H heads)",
            live_pairs=pairs, bytes=nbytes, flops=flops, bound_ms=bound_ms,
            bound_by=bound_by, bound_share=bound_ms / ms,
            bound_route="10 D flops a live pair at 989 TFLOP/s (bf16); the "
                        "kernel recomputes S and dP for dQ: 14 D",
            device_kernels=kernels,
            plan=bwd_plan(torch, ptxas, b, h, kh, s_len, t_len, d, window,
                          "bf16"),
            **lib_rec, **old_rec, card=card)
        emit(rec)
        results.append(rec)
        del q, k, v, dout, out, lse, got, again, want
        torch.cuda.empty_cache()

    bwd_case("gemma2_global", 2, 8, 4, 4096, 4096, 256, True, None, 50.0)
    bwd_case("gemma2_local", 2, 8, 4, 4096, 4096, 256, True, 4096, 50.0)
    bwd_case("recurrentgemma_local", 2, 16, 1, 4096, 4096, 256, True, 2048,
             None)
    bwd_case("seamless_cross_noncausal", 2, 16, 16, 512, 1024, 64, False,
             None, None)

    def scan_case(name, b, t_len, w):
        a = (torch.rand(b, t_len, w, generator=g_rng, device=dev) * 0.099
             + 0.9).to(bf)
        x = (torch.randn(b, t_len, w, generator=g_rng, device=dev)
             * 0.1).to(bf)
        got = sc_mod.rglru_scan(a, x)
        want = ref.rglru_scan_ref(a, x)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        check(equal, f"rglru_scan bf16 {name}: kernel != plain version "
                     f"(max abs err {rel_err(got, want)} of max-abs)")
        n = b * t_len * w
        nbytes, flops = 6 * n, 2 * n
        bound_ms, bound_by = bound(nbytes, flops)
        ms = median_ms(torch, lambda: sc_mod.rglru_scan(a, x), flush)
        rec = dict(
            phase="bf16_kernel_check", kernel="rglru_scan", case=name,
            dtype="bfloat16", shape=dict(B=b, T=t_len, W=w),
            check="bitwise", equal=equal, max_abs_err=0.0, ms=ms,
            plain_ms=median_ms(torch, lambda: ref.rglru_scan_ref(a, x),
                               flush, iters=3, warmup=1),
            library_ms=None,
            library_call="none: PyTorch has no one-call linear recurrence",
            bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
            bound_share=bound_ms / ms, card=card)
        emit(rec)
        results.append(rec)

    scan_case("recurrentgemma_prefill", 2, 4096, 4096)
    scan_case("ragged_w4099", 2, 4096, 4099)
    scan_case("t1", 2, 1, 4096)
    emit(dict(phase="bf16_kernel_check", seconds=time.perf_counter() - t_phase))
    return results


# ---------------------------------------------------------------------------
# phase 3/4: the main path
# ---------------------------------------------------------------------------

def main_path(torch, card, init_params):
    from repro_torch.kernels import fed_aggregate as fa_mod
    from repro_torch.kernels import fed_reduce as fr_mod
    from repro_torch.launch.profile_trial import smoke_server
    from repro_torch.tree import leaves, tree_map

    runs, walls = {}, {}
    launches = {"fed_reduce": 0, "fed_aggregate": 0}
    plans = [("sync", dict(m=20, max_rounds=5)),
             ("async", dict(m=10, max_rounds=10, fleet_name="stragglers")),
             ("buffered", dict(m=10, max_rounds=2, buffer_k=8,
                               fleet_name="stragglers"))]
    for mode, kw in plans:
        srv = smoke_server(mode, device="cuda", **kw)
        params = tree_map(lambda p: p.to("cuda"), init_params)
        torch.cuda.synchronize()
        fr_mod.launches = 0
        fa_mod.launches = 0
        t0 = time.perf_counter()
        res = srv.run(params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"fed_reduce": fr_mod.launches,
                  "fed_aggregate": fa_mod.launches}
        for k, v in counts.items():
            launches[k] += v
        check(res.rounds == kw["max_rounds"],
              f"{mode}: ran {res.rounds} aggregations, wanted "
              f"{kw['max_rounds']}")
        check(all(p.device.type == "cuda" for p in leaves(res.params)),
              f"{mode}: final params are not all on cuda")
        accs = [h.accuracy for h in res.history]
        check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
              f"{mode}: accuracy not finite in [0, 1]: {accs}")
        check(all(c > 0 for c in res.total_cost.as_tuple()),
              f"{mode}: cost totals not all positive: "
              f"{res.total_cost.as_tuple()}")
        check(srv.local_steps > 0, f"{mode}: no local steps ran")
        walls[mode] = wall
        rec = dict(phase="main_path", mode=mode, rounds=res.rounds,
                   m_e=[(h.m, h.e) for h in res.history], accuracy=accs,
                   costs=list(res.total_cost.as_tuple()),
                   sim_time=res.sim_time, wall_s=wall,
                   rounds_per_s=res.rounds / wall,
                   local_steps=srv.local_steps,
                   local_steps_per_s=srv.local_steps / wall,
                   launches=counts, card=card)
        emit(rec)
        runs[mode] = res
    check(launches["fed_reduce"] > 0, "fed_reduce never launched on the "
                                      "main path")
    check(launches["fed_aggregate"] > 0, "fed_aggregate never launched on "
                                         "the main path")
    return runs, launches, walls


def same_records(label, ref_hist, hist, n_rounds):
    """The FedTune record rule over the first ``n_rounds`` rounds of two
    histories: (M, E) per round and the cost totals (the cost model's own
    summation) equal, accuracy within 0.01 (ROADMAP.md section 3,
    departure 7)."""
    ref_hist, hist = ref_hist[:n_rounds], hist[:n_rounds]
    check(len(ref_hist) == len(hist) == n_rounds,
          f"{label}: {len(ref_hist)} and {len(hist)} rounds, wanted "
          f"{n_rounds}")
    me_ref = [(h.m, h.e) for h in ref_hist]
    me = [(h.m, h.e) for h in hist]
    check(me_ref == me, f"{label}: (M, E) per round differ: {me_ref} "
                        f"against {me}")
    totals = []
    for hs in (ref_hist, hist):
        tot = [0.0, 0.0, 0.0, 0.0]
        for h in hs:
            tot = [a + b for a, b in zip(tot, h.cost.as_tuple())]
        totals.append(tot)
    check(totals[0] == totals[1], f"{label}: cost totals differ: "
                                  f"{totals[0]} against {totals[1]}")
    acc_ref = [h.accuracy for h in ref_hist]
    acc = [h.accuracy for h in hist]
    diff = max(abs(a - b) for a, b in zip(acc_ref, acc))
    check(diff <= 0.01, f"{label}: accuracy differs by {diff} > 0.01: "
                        f"{acc_ref} against {acc}")
    return dict(rounds=n_rounds, m_e=me, costs_equal=True, acc_ref=acc_ref,
                acc=acc, max_acc_diff=diff)


def card_vs_cpu(sync_res, init_params):
    from repro_torch.launch.profile_trial import smoke_server

    n_rounds = 3
    srv = smoke_server("sync", m=20, max_rounds=n_rounds, device="cpu")
    t0 = time.perf_counter()
    cpu = srv.run(init_params)
    wall = time.perf_counter() - t0
    rec = same_records("card vs cpu", sync_res.history, cpu.history,
                       n_rounds)
    emit(dict(phase="card_vs_cpu", rounds=n_rounds, m_e=rec["m_e"],
              costs_equal=True, acc_card=rec["acc_ref"], acc_cpu=rec["acc"],
              max_acc_diff=rec["max_acc_diff"], cpu_wall_s=wall))


# ---------------------------------------------------------------------------
# phase 7/8/9: the vectorized sweep engine
# ---------------------------------------------------------------------------

def sweep_full_width(torch, card):
    """Phase 7: the 48-trial sync grid and its async/buffered counterpart
    at paper scale through ``run_sweep`` on the card.  Every
    ``_fused_sync_reduce`` call is watched: it must launch ``fed_reduce``
    exactly once per sweep round, and the first call's inputs are kept
    for the kernel case at the sweep's own launch shape."""
    from repro_torch.experiments import run_sweep, runner
    from repro_torch.kernels import fed_aggregate as fa_mod
    from repro_torch.kernels import fed_reduce as fr_mod
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_sweep import (full_width_event_grid,
                                                  full_width_grid)
    from repro_torch.tree import leaves

    specs = full_width_grid(rounds=5).expand()
    check(len(specs) == 48, f"phase 7 grid has {len(specs)} trials, not 48")
    fused, lanes, captured, all_shapes = [], [], {}, {}
    inner_fused, inner_step = runner._fused_sync_reduce, runner._sync_round_step
    inner_op = ops.fed_reduce

    def op_spy(w, rows, seg, t, base=None, **kw):
        shape = f"T={t},M={rows.shape[0]},N={rows.shape[1]}"
        all_shapes[shape] = all_shapes.get(shape, 0) + 1
        if "in_fused" in captured:
            captured["in_fused"].append(dict(
                T=t, M=rows.shape[0], N=rows.shape[1],
                int8_rows=int(kw["quant_enabled"].sum())
                if kw.get("quant_enabled") is not None else 0))
            if "inputs" not in captured:
                captured["inputs"] = (w.clone(), rows.clone(), seg.clone(),
                                      t, {k: v.clone() if torch.is_tensor(v)
                                          else v for k, v in kw.items()})
        return inner_op(w, rows, seg, t, base, **kw)

    def fused_spy(live):
        captured["in_fused"] = []
        before = fr_mod.launches
        inner_fused(live)
        fused.append(dict(launches=fr_mod.launches - before,
                          calls=captured.pop("in_fused")))

    def step_spy(live, **kw):
        n = inner_step(live, **kw)
        lanes.append(n)
        return n

    ops.fed_reduce, runner._fused_sync_reduce = op_spy, fused_spy
    runner._sync_round_step = step_spy
    try:
        torch.cuda.synchronize()
        fr_mod.launches = 0
        fa_mod.launches = 0
        t0 = time.perf_counter()
        res = run_sweep(specs, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"fed_reduce": fr_mod.launches,
                  "fed_aggregate": fa_mod.launches}
    finally:
        ops.fed_reduce, runner._fused_sync_reduce = inner_op, inner_fused
        runner._sync_round_step = inner_step
    check(len(res) == 48, f"phase 7: {len(res)} results for 48 trials")
    check(all(r.rounds == 5 for r in res),
          f"phase 7: rounds {[r.rounds for r in res]}, wanted 5 each")
    check(all(p.device.type == "cuda" for r in res for p in leaves(r.params)),
          "phase 7: final params are not all on cuda")
    check(all(c > 0 for r in res for c in r.cost),
          "phase 7: cost totals not all positive")
    check(all(math.isfinite(a) for r in res for a in r.history_acc),
          "phase 7: accuracy not finite")
    check(len(fused) == len(lanes) == 5,
          f"phase 7: {len(lanes)} sweep rounds, {len(fused)} fused reduces")
    check(all(f["launches"] == 1 and len(f["calls"]) == 1 for f in fused),
          f"phase 7: fed_reduce launches per fused reduce "
          f"{[f['launches'] for f in fused]}, wanted 1 each")
    check(all(f["calls"][0]["int8_rows"] > 0 for f in fused),
          "phase 7: the FedAvg group's launch carried no int8 lanes")
    trial_rounds = sum(r.rounds for r in res)
    steps = sum(r.local_steps for r in res)
    rec = dict(phase="sweep_full_width", mode="sync", trials=len(res),
               sweep_rounds=len(lanes), lanes_per_round=lanes,
               fed_reduce_fedavg_group=[f["calls"][0] for f in fused],
               fed_reduce_every_launch=all_shapes,
               launches=counts, wall_s=wall, trial_rounds=trial_rounds,
               trial_rounds_per_s=trial_rounds / wall, local_steps=steps,
               local_steps_per_s=steps / wall, card=card)
    emit(rec)

    ev_specs = full_width_event_grid(rounds=10).expand()
    torch.cuda.synchronize()
    fr_mod.launches = 0
    fa_mod.launches = 0
    t0 = time.perf_counter()
    ev_res = run_sweep(ev_specs, device="cuda")
    torch.cuda.synchronize()
    ev_wall = time.perf_counter() - t0
    ev_counts = {"fed_reduce": fr_mod.launches,
                 "fed_aggregate": fa_mod.launches}
    check(all(r.rounds == 10 for r in ev_res),
          f"phase 7 events: rounds {[r.rounds for r in ev_res]}, wanted 10")
    check(all(p.device.type == "cuda" for r in ev_res
              for p in leaves(r.params)),
          "phase 7 events: final params are not all on cuda")
    check(all(c > 0 for r in ev_res for c in r.cost),
          "phase 7 events: cost totals not all positive")
    check(ev_counts["fed_aggregate"] > 0, "phase 7 events: fed_aggregate "
                                          "never launched")
    check(ev_counts["fed_reduce"] > 0, "phase 7 events: fed_reduce (FedBuff "
                                       "flushes) never launched")
    ev_steps = sum(r.local_steps for r in ev_res)
    aggs = sum(r.rounds for r in ev_res)
    emit(dict(phase="sweep_full_width", mode="async,buffered",
              trials=len(ev_res), launches=ev_counts, wall_s=ev_wall,
              aggregations=aggs, aggregations_per_s=aggs / ev_wall,
              local_steps=ev_steps, local_steps_per_s=ev_steps / ev_wall,
              card=card))
    launches = {k: counts[k] + ev_counts[k] for k in counts}
    return res, ev_res, wall, launches, captured["inputs"]


def sweep_vs_standalone(torch, card, res, ev_res, sweep_wall):
    """Phase 8: four of phase 7's trials, each also run alone on the card
    from the same initial params (the port's seeded init on both sides).
    Returns the standalone results by trial key."""
    from repro_torch.experiments import run_trial

    def pick(rs, **want):
        return next(r for r in rs if all(getattr(r.spec, k) == v
                                         for k, v in want.items()))
    chosen = [pick(res, aggregator="fedavg", compression=None, seed=0,
                   tuner="fedtune"),
              pick(res, aggregator="fedavg", compression="int8", seed=1,
                   tuner="fedtune"),
              pick(res, aggregator="fedadam", seed=0, tuner="fedtune"),
              pick(ev_res, mode="async", seed=0, tuner="fedtune")]
    rows, alone_by_key = [], {}
    for vec in chosen:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alone = run_trial(vec.spec, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        name = vec.spec.key()
        alone_by_key[name] = alone
        check((alone.history_m, alone.history_e)
              == (vec.history_m, vec.history_e),
              f"phase 8 {name}: (M, E) differ")
        check(alone.cost == vec.cost, f"phase 8 {name}: costs differ")
        check(alone.dispatch_log == vec.dispatch_log
              and alone.staleness_log == vec.staleness_log,
              f"phase 8 {name}: dispatch/staleness logs differ")
        diff = max(abs(a - b) for a, b in zip(alone.history_acc,
                                               vec.history_acc))
        check(diff <= 0.01, f"phase 8 {name}: accuracy differs by {diff}")
        rows.append(dict(trial=name, rounds=alone.rounds,
                         standalone_wall_s=wall, max_acc_diff=diff,
                         acc_equal=alone.history_acc == vec.history_acc))
    n_sync = len(res)
    emit(dict(phase="sweep_vs_standalone", trials=rows,
              sweep_wall_s=sweep_wall, sweep_trials=n_sync,
              sweep_wall_per_trial_s=sweep_wall / n_sync,
              sync_standalone_wall_mean_s=sum(
                  r["standalone_wall_s"] for r in rows[:3]) / 3,
              card=card))
    return alone_by_key


def eval_routes(torch, card, res, alone_by_key):
    """Phase 8a: phase 7's int8 FedAvg trial (seed 1, FedTune), its packed
    lane's final params evaluated on the card two ways: ``Evaluator``
    (one ``model.forward`` per 256-row batch) and ``StackedEvaluator``
    over the sweep's own last stacked evaluation (every trial of the
    lane's (model, dataset) group, in sweep order, padded to a pow2).
    Then the same trial's standalone run from phase 8: its final params
    against the packed lane's, and the eval points on which the two
    argmaxes differ.  Returns the printed record."""
    from repro_torch.experiments import runner
    from repro_torch.federated.evaluation import (Evaluator,
                                                  StackedEvaluator,
                                                  _pow2_lanes, shared_batches)
    from repro_torch.launch.profile_sweep import full_width_grid
    from repro_torch.tree import leaves, tree_stack

    order = {s.key(): i for i, s in enumerate(
        full_width_grid(rounds=5).expand())}
    vec = next(r for r in res if r.spec.aggregator == "fedavg"
               and r.spec.compression == "int8" and r.spec.seed == 1
               and r.spec.tuner == "fedtune")
    group = sorted((r for r in res if r.spec.seed == vec.spec.seed),
                   key=lambda r: order[r.spec.key()])
    lane = group.index(vec)
    srv = runner.build_server(vec.spec, "cuda")
    model, pts = srv.model, vec.spec.eval_points
    batches = shared_batches(srv.dataset, pts, "cuda")

    def preds(params):
        with torch.no_grad():
            return torch.cat([model.forward(params, bx).argmax(-1)
                              for bx, _, _ in batches])

    pad = _pow2_lanes(len(group))
    stacked = tree_stack([r.params for r in group]
                         + [group[0].params] * (pad - len(group)))
    lanes = torch.func.vmap(model.forward, in_dims=(0, None))
    with torch.no_grad():
        logits_v = torch.cat([lanes(stacked, bx)[lane] for bx, _, _ in batches],
                             dim=0)
        logits_s = torch.cat([model.forward(vec.params, bx)
                              for bx, _, _ in batches])
    single = preds(vec.params)
    acc_single = Evaluator(model, srv.dataset, pts, "cuda").evaluate(
        vec.params)
    acc_stacked = StackedEvaluator(model, srv.dataset, pts, "cuda").evaluate(
        [r.params for r in group], pad_to=pad)[lane]
    alone = alone_by_key[vec.spec.key()]
    param_diff = max(float((a - b).abs().max()) for a, b in
                     zip(leaves(alone.params), leaves(vec.params)))
    rec = dict(phase="eval_routes", trial=vec.spec.key(), eval_points=pts,
               group_lanes=len(group), padded_to=pad, lane=lane,
               acc_evaluator=acc_single, acc_stacked=acc_stacked,
               route_points_differ=int((logits_v.argmax(-1) != single)
                                       .sum()),
               route_logits_max_abs_diff=float(
                   (logits_v - logits_s).abs().max()),
               routes_bitwise=bool(torch.equal(logits_v, logits_s)),
               params_max_abs_diff_vs_standalone=param_diff,
               standalone_points_differ=int((preds(alone.params) != single)
                                            .sum()),
               acc_history_packed=vec.history_acc,
               acc_history_standalone=alone.history_acc, card=card)
    emit(rec)
    # the finding departure 7 rests on: the two eval routes agree, so what
    # separates a packed lane from its standalone run is its params
    check(rec["route_points_differ"] == 0 and acc_single == acc_stacked,
          f"phase 8a: Evaluator and StackedEvaluator disagree on "
          f"{rec['route_points_differ']} eval points")
    return rec


def serve_queue():
    """Phase 10's queue: 16 trials at full width (the sweep's 784-48-62 MLP
    over the full ``emnist_like`` federation, batch 10, 512 eval points,
    (M0, E0) = (20, 1.0)).  10 sync trials of 2-5 rounds (fedavg with and
    without int8 uploads, fednova, fedadam; FedTune preferences 0 and 14;
    seeds 0 and 1) and 6 event trials on the stragglers fleet (async
    fedavg, 4-10 aggregations; buffered fedavg, 4-5 flushes)."""
    from repro_torch.experiments import TrialSpec
    from repro_torch.experiments.grid import parse_preferences

    p0, p14 = parse_preferences("0,14")
    base = dict(dataset="emnist", reduced=False, tuner="fedtune", m0=20,
                e0=1.0, batch_size=10, eval_points=512, target_accuracy=0.99)
    sync = [("fedavg", None, p0, 0, 2), ("fedavg", "int8", p14, 1, 5),
            ("fednova", None, p14, 0, 3), ("fedadam", None, p0, 1, 4),
            ("fedavg", None, p14, 1, 3), ("fedavg", "int8", p0, 0, 4),
            ("fednova", None, p0, 1, 5), ("fedadam", None, p14, 0, 2),
            ("fedavg", None, p0, 1, 5), ("fedavg", "int8", p14, 0, 3)]
    event = [("async", p14, 0, 4), ("buffered", p14, 0, 4),
             ("async", p0, 1, 10), ("buffered", p0, 1, 5),
             ("async", p14, 1, 7), ("buffered", p14, 1, 4)]
    specs = [TrialSpec(aggregator=a, compression=c, preference=p, seed=s,
                       rounds=r, **base) for a, c, p, s, r in sync]
    specs += [TrialSpec(aggregator="fedavg", mode=m, het="stragglers",
                        preference=p, seed=s, rounds=r, **base)
              for m, p, s, r in event]
    # interleave sync and event trials in the queue: lanes retire and
    # refill with both kinds mid-flight
    return [specs[i] for i in (0, 10, 1, 2, 11, 3, 12, 4, 5, 13, 6, 7, 14,
                               8, 15, 9)]


SERVE_LANES = 6


def serve_phase(torch, card):
    """Phase 10: the 16-trial queue served on the card through 6 lanes.

    (a) An uninterrupted drain with a snapshot before every step, into
    store A: wall, trials/s, trial-rounds/s, mean occupancy, bytes and
    median ms per snapshot, and every ``fed_reduce`` (T, M, N) and
    ``fed_aggregate`` launch.  (b) The same drain killed after S // 2 of
    its S steps (no final snapshot), restored on the card and drained to
    the end, into store B: B must equal A row for row (``wall`` aside),
    with no duplicate key, at most one step replayed and the restore under
    1 s.  (c) Every trial alone through ``run_trial`` on the card from the
    same initial params: (M, E), costs and dispatch/staleness logs equal;
    accuracy equal, or within 0.01 (ROADMAP.md section 3, departure 7: a
    packed lane's params are not a standalone run's bits), with the eval
    points that differ counted.  (d) The drain again with tracing and NVTX
    on: its store must equal A and its Chrome trace must validate; the
    spans give the drain's wall split.  (e) A served trial's final params
    plus a bf16 leaf through ``save_checkpoint``/``load_checkpoint`` onto
    the card, bitwise.  Returns (launches of drain A, the record)."""
    import os
    import statistics

    from repro_torch import obs
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.experiments import (ResultStore, TrialQueue,
                                         TrialScheduler, run_trial)
    from repro_torch.kernels import fed_aggregate as fa_mod
    from repro_torch.kernels import fed_reduce as fr_mod
    from repro_torch.kernels import ops
    from repro_torch.obs.export import (validate_chrome_trace,
                                        write_chrome_trace)
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    specs = serve_queue()
    check(len(specs) == 16 and len({s.key() for s in specs}) == 16,
          "phase 10: the queue is not 16 distinct trials")
    out_dir = ROOT / "runs" / "chip_smoke_serve"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.iterdir():
        f.unlink()

    def rows(store):
        return [{k: v for k, v in r.items() if k != "wall"}
                for r in store.load()]

    def scheduler(tag, snapshot=True):
        return TrialScheduler(
            TrialQueue(specs=specs), max_lanes=SERVE_LANES,
            store=ResultStore(str(out_dir / f"{tag}.jsonl")),
            snapshot_path=str(out_dir / f"{tag}.snap") if snapshot else None,
            device="cuda")

    # (a) uninterrupted, a snapshot before every step; each snapshot's
    # host time split into the copy of its tensors to the host, the choice
    # of slot (both slots read and validated) and the two fsynced writes
    sched = scheduler("a")
    snap_ms, snap_bytes = [], []
    inner_snapshot = sched.snapshot
    snap_split = {"host_copy": 0.0, "slot_choice": 0.0, "write_fsync": 0.0}
    snap_fns = {"host_copy": "flatten_to_numpy", "slot_choice": "_read_slot",
                "write_fsync": "_fsync_write"}
    snap_inner = {k: getattr(ckpt, f) for k, f in snap_fns.items()}

    def split_timer(part):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return snap_inner[part](*args, **kw)
            finally:
                snap_split[part] += time.perf_counter() - t0
        return run

    def timed_snapshot(path=None):
        t0 = time.perf_counter()
        npz = inner_snapshot(path)
        snap_ms.append((time.perf_counter() - t0) * 1e3)
        snap_bytes.append(os.path.getsize(npz) + os.path.getsize(
            npz[:-len(".npz")] + ".json"))
        return npz
    sched.snapshot = timed_snapshot
    shapes = {}
    inner_op = ops.fed_reduce

    def op_spy(w, rows_, seg, t, base=None, **kw):
        key = f"T={t},M={rows_.shape[0]},N={rows_.shape[1]}"
        shapes[key] = shapes.get(key, 0) + 1
        return inner_op(w, rows_, seg, t, base, **kw)

    ops.fed_reduce = op_spy
    for part, f in snap_fns.items():
        setattr(ckpt, f, split_timer(part))
    try:
        torch.cuda.synchronize()
        fr_mod.launches = 0
        fa_mod.launches = 0
        t0 = time.perf_counter()
        served = sched.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"fed_reduce": fr_mod.launches,
                  "fed_aggregate": fa_mod.launches}
    finally:
        ops.fed_reduce = inner_op
        for part, f in snap_fns.items():
            setattr(ckpt, f, snap_inner[part])
    snap_split["meta_and_rename"] = (sum(snap_ms) / 1e3
                                     - sum(snap_split.values()))
    store_a = rows(sched.store)
    steps = sched.stats.steps
    check(len(served) == 16 and len(store_a) == 16,
          f"phase 10: {len(served)} trials served, {len(store_a)} rows")
    check(all(r.rounds == r.spec.rounds for r in served),
          "phase 10: a served trial stopped short of its budget")
    check(all(p.device.type == "cuda" for r in served
              for p in leaves(r.params)),
          "phase 10: served params are not all on cuda")
    check(counts["fed_reduce"] > 0 and counts["fed_aggregate"] > 0,
          f"phase 10: launches {counts}: both kernels must launch")
    trial_rounds = sum(r.rounds for r in served)

    # (b) killed after S // 2 steps, restored on the card, drained
    killed = scheduler("b")
    killed.drain(max_steps=steps // 2)
    first_steps = killed.stats.steps
    check(killed.pool.n_live > 0, "phase 10: the kill did not land mid-drain")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = TrialScheduler.restore(str(out_dir / "b.snap"),
                                     store=killed.store, device="cuda")
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    for key in killed.store.completed_keys():
        resumed.queue.mark_done(key)
    replay_from = resumed.stats.steps
    resumed.drain()
    store_b = rows(resumed.store)
    keys_b = [r["key"] for r in store_b]
    check(len(keys_b) == len(set(keys_b)), "phase 10: duplicate store keys")
    check(store_b == store_a, "phase 10: the killed-and-restored drain's "
                              "store differs from the uninterrupted one")
    replayed = first_steps - replay_from
    check(0 <= replayed <= 1 and resumed.stats.steps == steps,
          f"phase 10: replayed {replayed} steps, ended at "
          f"{resumed.stats.steps} of {steps}")
    check(restore_ms < 1000.0, f"phase 10: restore took {restore_ms} ms")

    # (c) every trial alone, from the same (seeded) initial params
    diffs, points = [], 0
    t0 = time.perf_counter()
    for r in served:
        alone = run_trial(r.spec, device="cuda")
        name = r.spec.key()
        check((alone.history_m, alone.history_e)
              == (r.history_m, r.history_e), f"phase 10 {name}: (M, E)")
        check(alone.cost == r.cost, f"phase 10 {name}: costs differ")
        check(alone.dispatch_log == r.dispatch_log
              and alone.staleness_log == r.staleness_log,
              f"phase 10 {name}: dispatch/staleness logs differ")
        d = [abs(a - b) for a, b in zip(alone.history_acc, r.history_acc)]
        diffs.append(max(d))
        points += sum(round(x * r.spec.eval_points) for x in d)
    torch.cuda.synchronize()
    standalone_s = time.perf_counter() - t0
    check(max(diffs) <= 0.01, f"phase 10: accuracy differs by {max(diffs)}")
    rule = ("exact" if max(diffs) == 0.0 else
            "within 0.01 (ROADMAP.md section 3, departure 7)")

    # (d) traced, NVTX on: the same store, a valid trace, the wall split
    traced = scheduler("c", snapshot=True)
    inner_admit, inner_retire = traced.admit_pending, traced._retire

    def admit_span():
        with obs.span("admit_pending", phase="admit"):
            return inner_admit()

    def retire_span(spec, result):
        with obs.span("retire_trial", phase="retire"):
            return inner_retire(spec, result)
    traced.admit_pending, traced._retire = admit_span, retire_span
    obs.enable(nvtx=True)
    nvtx = obs.tracer._annotation_cls is not None
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traced.drain()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    finally:
        obs.disable()
    check(rows(traced.store) == store_a,
          "phase 10: the traced drain's store differs from the untraced one")
    trace = write_chrome_trace(str(out_dir / "c.trace.json"))
    errors = validate_chrome_trace(trace)
    check(errors == [], f"phase 10: trace violates the schema: {errors[:3]}")
    split_names = {"admit": ("admit_pending",), "plan": ("PLAN", "COLLECT"),
                   "pack": ("PACK:pack",), "train": ("TRAIN", "PACK:train"),
                   "reduce": ("APPLY",), "eval": ("EVAL",),
                   "retire": ("retire_trial",), "snapshot": ("snapshot",)}
    split = {k: 0.0 for k in split_names}
    for sp in obs.tracer.spans:
        for k, names in split_names.items():
            if sp.name in names or f"{sp.name}:{sp.phase}" in names:
                split[k] += sp.wall_dur
    split["other"] = traced_wall - sum(split.values())

    # (e) a served trial's final params plus a bf16 leaf, through a
    # checkpoint, back onto the card
    tree = {"params": served[0].params,
            "bf16": torch.randn(4099, device="cuda").to(torch.bfloat16)}
    save_checkpoint(str(out_dir / "ck"), tree, step=served[0].rounds)
    like = {"params": served[1].params,
            "bf16": torch.zeros(4099, device="cuda", dtype=torch.bfloat16)}
    back, meta = load_checkpoint(str(out_dir / "ck"), like)
    check(meta["step"] == served[0].rounds, "phase 10: checkpoint step")
    check(all(a.device.type == "cuda" and a.dtype == b.dtype
              and torch.equal(a, b) for a, b in zip(leaves(back),
                                                    leaves(tree))),
          "phase 10: the checkpoint round trip is not bitwise on the card")

    phase_s = time.perf_counter() - t_phase
    rec = dict(phase="serve_trials", trials=len(served),
               sync_trials=sum(s.mode == "sync" for s in specs),
               event_trials=sum(s.mode != "sync" for s in specs),
               max_lanes=SERVE_LANES, steps=steps, wall_s=wall,
               trials_per_s=len(served) / wall, trial_rounds=trial_rounds,
               trial_rounds_per_s=trial_rounds / wall,
               local_steps=sum(r.local_steps for r in served),
               mean_occupancy=sched.stats.mean_occupancy,
               snapshots=len(snap_ms),
               snapshot_bytes_median=statistics.median(snap_bytes),
               snapshot_bytes_max=max(snap_bytes),
               snapshot_ms_median=statistics.median(snap_ms),
               snapshot_ms_max=max(snap_ms),
               snapshot_split_s=snap_split,
               launches=counts, fed_reduce_shapes=shapes,
               kill_after_steps=first_steps, replayed_steps=replayed,
               restore_ms=restore_ms, killed_store_equal=True,
               standalone_s=standalone_s, standalone_rule=rule,
               standalone_max_acc_diff=max(diffs),
               standalone_eval_points_differ=points,
               traced_wall_s=traced_wall, traced_store_equal=True,
               trace_valid=True, trace_spans=len(obs.tracer.spans),
               nvtx=nvtx, wall_split_s=split, checkpoint_bitwise=True,
               phase_s=phase_s, card=card)
    emit(rec)
    obs.tracer.clear()
    return counts, rec


def sweep_card_vs_cpu(torch):
    """Phase 9: the reduced smoke preset's first 8 trials through the sweep
    CLI on the card and on the CPU, from the same initial params."""
    from repro_torch.launch import sweep as sweep_cli

    out = {}
    for dev in ("cuda", "cpu"):
        store = ROOT / "runs" / f"chip_smoke_sweep_{dev}.jsonl"
        t0 = time.perf_counter()
        out[dev] = sweep_cli.main(["--preset", "smoke", "--limit", "8",
                                   "--device", dev, "--no-resume",
                                   "--out", str(store)])
        out[dev + "_wall"] = time.perf_counter() - t0
    diffs = []
    for a, b in zip(out["cuda"], out["cpu"]):
        check(a.spec.key() == b.spec.key(), "phase 9: trial order differs")
        check((a.history_m, a.history_e) == (b.history_m, b.history_e),
              f"phase 9 {a.spec.key()}: (M, E) differ")
        check(a.cost == b.cost, f"phase 9 {a.spec.key()}: costs differ")
        diffs.append(max(abs(x - y) for x, y in zip(a.history_acc,
                                                    b.history_acc)))
    check(len(out["cuda"]) == 8 and max(diffs) <= 0.01,
          f"phase 9: {len(out['cuda'])} trials, accuracy diffs {diffs}")
    emit(dict(phase="sweep_card_vs_cpu", trials=len(out["cuda"]),
              max_acc_diff=max(diffs), costs_equal=True,
              card_wall_s=out["cuda_wall"], cpu_wall_s=out["cpu_wall"]))


def sweep_reduce_cases(torch, card, floor, inputs):
    """``fed_reduce`` at the sweep's own launch shape: phase 7's first
    FedAvg-group launch (its weights, rows, segments and int8 lanes), with
    the int8 lanes and without."""
    w, rows, seg, t_seg, kw = inputs
    n = rows.shape[1]
    leaf_sizes = tuple(kw["leaf_sizes"])
    check(n == 40_718 and sum(leaf_sizes) == n,
          f"sweep rows have N={n}, leaves {leaf_sizes}")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    out = [fed_reduce_case(torch, card, flush, floor, "sweep_fedavg_int8", w,
                           rows, seg, t_seg, None, True,
                           (kw["quant_ref"], kw["quant_enabled"]),
                           leaf_sizes),
           fed_reduce_case(torch, card, flush, floor, "sweep_fedavg", w,
                           rows, seg, t_seg, None, True)]
    del flush
    return out


# ---------------------------------------------------------------------------
# phase 2c: the training kernels (backward) against their plain versions
# ---------------------------------------------------------------------------

def ptxas_table(log_text: str):
    """ptxas -v's report per compiled entry function (mangled name):
    registers, static shared bytes, spill stores and loads."""
    table, cur = {}, None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1)
            table[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            table[cur].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            table[cur]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            table[cur]["static_smem"] = int(m.group(1))
    return table


def ptxas_of(table, needle: str):
    """The report of the one entry function whose name holds ``needle``."""
    hits = {fn: v for fn, v in table.items() if needle in fn}
    return next(iter(hits.values())) if len(hits) == 1 else hits


def bwd_plan(torch, ptxas, b, h, kh, s_len, t_len, d, window, dtype="f32"):
    """The backward's launch as its C planner gives it (scratch bytes,
    blocks of the prep pass and of the main pass's kv-major and q-major
    kinds, dynamic shared memory) with ptxas's report of both kernels and
    the main grid's waves: its blocks over the SMs times the blocks an SM
    holds (shared memory and registers).  ``dtype`` "f32" or "bf16" picks
    the kernel (both 256 threads a block)."""
    import ctypes

    from repro_torch.kernels import build

    info = (ctypes.c_longlong * 5)()
    scratch = getattr(build.library(), f"flash_attention_bwd_plan_{dtype}")(
        b, h, kh, s_len, t_len, d, 0 if window is None else int(window), info)
    n_dkv, n_dq, n_prep, smem, dq_first = (int(x) for x in info)
    kernel = "attn_bwd" if dtype == "f32" else "attn16_bwd"
    main = ptxas_of(ptxas, f"{kernel}_mainILi{d}E")
    regs = main.get("registers", 255) if isinstance(main, dict) and main \
        else 255
    per_sm = max(1, min((228 * 1024) // (smem + 1024),
                        65536 // (256 * (-(-regs // 8) * 8))))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(scratch_bytes=int(scratch), prep_blocks=n_prep,
                kv_major_blocks=n_dkv, q_major_blocks=n_dq,
                q_major_first=bool(dq_first),
                blocks_per_sm=per_sm, sms=sms,
                waves=(n_dkv + n_dq) / (sms * per_sm),
                dynamic_smem_bytes=smem,
                ptxas=dict(main=main, prep=ptxas_of(
                    ptxas, f"{kernel}_prepILi{d}E")))


def train_kernel_cases(torch, np, card, flush, ptxas, old_lib=None):
    import ctypes

    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fl_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as sc_mod
    from repro_torch.kernels.parity import rel_err

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    results = []

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    def sdpa_bwd(q, k, v, dout, causal, window, s_len, t_len):
        """The library yardstick: the backward of one SDPA call with the
        mask explicit (k, v repeated to H heads outside the timing)."""
        qk = torch.arange(s_len, device=dev)[:, None] + (t_len - s_len)
        kp = torch.arange(t_len, device=dev)[None, :]
        mask = torch.ones((s_len, t_len), dtype=torch.bool, device=dev)
        if causal:
            mask &= kp <= qk
        if window is not None:
            mask &= kp > qk - window
        g = q.shape[1] // k.shape[1]
        qq = q.detach().clone().requires_grad_(True)
        kk = k.repeat_interleave(g, 1).requires_grad_(True)
        vv = v.repeat_interleave(g, 1).requires_grad_(True)
        out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)
        return lambda: torch.autograd.grad(out, (qq, kk, vv), dout,
                                           retain_graph=True)

    def attn_case(name, b, h, kh, s_len, t_len, d, causal, window, cap):
        q = t(rng.standard_normal((b, h, s_len, d)).astype(np.float32))
        k = t(rng.standard_normal((b, kh, t_len, d)).astype(np.float32))
        v = t(rng.standard_normal((b, kh, t_len, d)).astype(np.float32))
        dout = t(rng.standard_normal((b, h, s_len, d)).astype(np.float32))
        kw = dict(causal=causal, window=window, cap=cap)
        out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        _, k_lse = fl_mod.flash_attention(q, k, v, return_lse=True, **kw)
        lse_err = float((k_lse - lse).abs().max())
        check(lse_err <= 1e-4 * max(1.0, float(lse.abs().max())),
              f"flash_attention {name}: the kernel's lse is {lse_err} off")
        got = fl_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        again = fl_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, c)) for a, c in zip(got, again))
        check(same, f"flash_attention_bwd {name}: two calls differ")
        rel = [rel_err(g, w) for g, w in zip(got, want)]
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(max(rel) <= 1e-4, f"flash_attention_bwd {name}: (dq, dk, dv) "
                                f"off by {rel} of their max-abs (> 1e-4)")
        del again, want
        pairs = live_pairs(s_len, t_len, causal, window) * b * h
        flops = 10 * d * pairs
        # reads q, k, v, out, dout, lse; writes dq, dk, dv
        nbytes = 4 * (d * (4 * b * h * s_len + 4 * b * kh * t_len)
                      + b * h * s_len)
        # the kernel's route: every product is three TF32 tensor-core passes
        bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
        simt_ms, _ = bound(nbytes, flops)
        lib, lib_note = None, "none: scaled_dot_product_attention has no " \
            "soft-cap"
        if cap is None:
            lib = sdpa_bwd(q, k, v, dout, causal, window, s_len, t_len)
            lib_note = ("backward of F.scaled_dot_product_attention(q, k, v,"
                        " attn_mask=mask), k and v repeated to H heads")
        ms = median_ms(torch, lambda: fl_mod.flash_attention_bwd(
            q, k, v, out, lse, dout, **kw), flush, iters=10)
        plain_ms = median_ms(torch, lambda: ref.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, **kw), flush, iters=3, warmup=1)
        library_ms = None if lib is None else median_ms(torch, lib, flush,
                                                        iters=5)
        rec = dict(
            phase="train_kernel_check", kernel="flash_attention_bwd",
            case=name, shape=dict(B=b, H=h, Kh=kh, S=s_len, T=t_len, D=d),
            causal=causal, window=window, cap=cap,
            check="max-abs diff <= 1e-4 of max-abs, two calls bitwise",
            rel_err=dict(dq=rel[0], dk=rel[1], dv=rel[2]), max_abs_err=err,
            deterministic=same, lse_max_abs_err=lse_err, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms, library_call=lib_note,
            live_pairs=pairs, bytes=nbytes, flops=flops, bound_ms=bound_ms,
            bound_by=bound_by,
            bound_route="tf32x3: 3 x 10 D flops a live pair at 495 TFLOP/s",
            bound_f32_simt_ms=simt_ms, share_of_bound=bound_ms / ms,
            plan=bwd_plan(torch, ptxas, b, h, kh, s_len, t_len, d, window),
            card=card)
        if old_lib is not None and hasattr(old_lib,
                                           "flash_attention_bwd_f32"):
            # both through their C entry points: a kernel without a planner
            # entry takes a (B, H, S) delta buffer, one with it the scratch
            # its planner sizes
            strides = (ctypes.c_longlong * 24)(*(
                st for x in (q, k, v, out, dout, q, k, v)
                for st in x.stride()[:3]))
            outs = {}

            def c_call(lib_, key):
                work_floats = b * h * s_len
                if hasattr(lib_, "flash_attention_bwd_plan_f32"):
                    info = (ctypes.c_longlong * 5)()
                    work_floats = lib_.flash_attention_bwd_plan_f32(
                        b, h, kh, s_len, t_len, d,
                        0 if window is None else int(window), info) // 4
                work = torch.empty(work_floats, dtype=torch.float32,
                                   device=dev)
                grads = tuple(torch.empty_like(x) for x in (q, k, v))
                outs[key] = grads
                return raw_call(
                    torch, lib_.flash_attention_bwd_f32, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    dout.data_ptr(), lse.data_ptr(), work.data_ptr(),
                    *(x.data_ptr() for x in grads), strides, b, h, kh,
                    s_len, t_len, d, int(causal),
                    0 if window is None else int(window), float(d ** -0.5),
                    0.0 if cap is None else float(cap))

            def old_agrees():
                want_ = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                    **kw)
                return max(rel_err(g, w) for g, w in zip(outs["old"],
                                                         want_)) <= 1e-4
            rec.update(old_vs_new(
                torch, flush, c_call(old_lib, "old"),
                c_call(build.library(), "new"), old_agrees))
            del outs
        emit(rec)
        results.append(rec)
        del q, k, v, dout, out, lse, got, lib
        torch.cuda.empty_cache()

    def scan_case(name, b, t_len, w):
        a = t(rng.uniform(0.9, 0.999, (b, t_len, w)).astype(np.float32))
        x = t((rng.standard_normal((b, t_len, w)) * 0.1).astype(np.float32))
        dh = t(rng.standard_normal((b, t_len, w)).astype(np.float32))
        h = sc_mod.rglru_scan(a, x)
        got = sc_mod.rglru_scan_bwd(a, h, dh)
        want = ref.rglru_scan_bwd_ref(a, h, dh)
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(g, c)) for g, c in zip(got, want))
        err = max(float((g - c).abs().max()) for g, c in zip(got, want))
        check(equal, f"rglru_scan_bwd {name}: kernel != plain version "
                     f"(max abs err {err})")
        n = b * t_len * w
        nbytes, flops = 20 * n, 3 * n
        bound_ms, bound_by = bound(nbytes, flops)
        rec = dict(
            phase="train_kernel_check", kernel="rglru_scan_bwd", case=name,
            shape=dict(B=b, T=t_len, W=w), check="bitwise", equal=equal,
            max_abs_err=err,
            ms=median_ms(torch, lambda: sc_mod.rglru_scan_bwd(a, h, dh),
                         flush),
            plain_ms=median_ms(torch, lambda: ref.rglru_scan_bwd_ref(
                a, h, dh), flush, iters=3, warmup=1),
            library_ms=None,
            library_call="none: PyTorch has no one-call reverse linear "
                         "recurrence",
            bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
            ptxas={"16-byte copies": ptxas_of(ptxas,
                                              "rglru_scan_bwd_kernelILb1E"),
                   "4-byte copies": ptxas_of(ptxas,
                                             "rglru_scan_bwd_kernelILb0E")},
            card=card)
        emit(rec)
        results.append(rec)

    t0 = time.perf_counter()
    scan_case("recurrentgemma_train", 2, 4096, 4096)
    scan_case("ragged_w4099", 2, 4096, 4099)
    scan_case("t1", 2, 1, 4096)
    attn_case("gemma2_global", 2, 8, 4, 4096, 4096, 256, True, None, 50.0)
    attn_case("gemma2_local", 2, 8, 4, 4096, 4096, 256, True, 4096, 50.0)
    attn_case("recurrentgemma_local", 2, 16, 1, 4096, 4096, 256, True, 2048,
              None)
    attn_case("ragged_s4000", 2, 16, 1, 4000, 4000, 256, True, 2048, None)
    attn_case("seamless_cross_noncausal", 2, 16, 16, 512, 1024, 64, False,
              None, None)
    emit(dict(phase="train_kernel_check", seconds=time.perf_counter() - t0))
    return results


# ---------------------------------------------------------------------------
# phase 11/11a: federated LM training through make_fl_train_step
# ---------------------------------------------------------------------------

# arch, layers kept (None: all), batch, sequence, microbatches, the
# reference tree's parameter count
TRAIN = (
    ("gemma2-2b", None, 2, 4096, 1, 2_614_222_080),
    ("recurrentgemma-9b", 6, 2, 4096, 1, 2_227_392_512),
)
TRAIN_ROUNDS = 3


def train_counts(fl_mod, sc_mod, reset: bool = False):
    """The four LM kernels' launch counts (set to 0 first when asked), the
    bf16 kernels' under ``<name>_bf16``."""
    if reset:
        fl_mod.launches = fl_mod.bwd_launches = 0
        sc_mod.launches = sc_mod.bwd_launches = 0
        fl_mod.launches_bf16 = fl_mod.bwd_launches_bf16 = 0
        sc_mod.launches_bf16 = 0
    return {"flash_attention": fl_mod.launches,
            "flash_attention_bwd": fl_mod.bwd_launches,
            "rglru_scan": sc_mod.launches,
            "rglru_scan_bwd": sc_mod.bwd_launches,
            "flash_attention_bf16": fl_mod.launches_bf16,
            "flash_attention_bwd_bf16": fl_mod.bwd_launches_bf16,
            "rglru_scan_bf16": sc_mod.launches_bf16}


def all_finite(torch, tensors) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in tensors)


def train_full_width(torch, card, dtype=None, beside=None):
    """Phase 11 (f32) or 14a (``dtype`` bf16: bf16 params, f32 momentum,
    every attention launch the bf16 kernels', the scan f32 as the model
    casts it; ``beside`` phase 11's records, printed with each arch).
    Returns (launch totals, records by arch)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels import flash_attention as fl_mod
    from repro_torch.kernels import rglru_scan as sc_mod
    from repro_torch.launch.distributed_fl import WEIGHTS, round_batch
    from repro_torch.launch.serve import cut_layers
    from repro_torch.launch.steps import DEFAULT_LR, make_fl_train_step
    from repro_torch.models import stacked
    from repro_torch.tree import leaves, tree_map

    dtype = torch.float32 if dtype is None else dtype
    bf16 = dtype == torch.bfloat16
    totals, recs = {}, {}
    for arch, keep, b, s_len, mb, n_want in TRAIN:
        cfg = get_config(arch)
        if keep is not None:
            cfg = cut_layers(cfg, keep)
        n_attn = sum(sp.mixer == "attn" for sp in cfg.layers)
        n_rglru = sum(sp.mixer == "rglru" for sp in cfg.layers)
        # remat: every layer's forward runs twice (the pass and its
        # recompute in the backward), its backward once, per microbatch
        sfx = "_bf16" if bf16 else ""
        want = dict.fromkeys(train_counts(fl_mod, sc_mod), 0)
        want.update({"flash_attention" + sfx: 2 * n_attn * mb,
                     "flash_attention_bwd" + sfx: n_attn * mb,
                     "rglru_scan": 2 * n_rglru * mb,
                     "rglru_scan_bwd": n_rglru * mb})
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = stacked.init_params_stacked(cfg, gen, dtype)
        momentum = tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in leaves(params))
        check(n_params == n_want, f"{arch}: {n_params} params, want {n_want}")
        step, _ = make_fl_train_step(
            cfg, InputShape("train_4k_cut", seq_len=s_len, global_batch=b,
                            kind="train"), microbatches=mb, dtype=dtype)
        bgen = torch.Generator(device="cuda").manual_seed(7)
        torch.cuda.reset_peak_memory_stats()
        secs, losses, accs = [], [], []
        for r in range(TRAIN_ROUNDS):
            batch = round_batch(cfg, b, s_len, bgen, "cuda")
            torch.cuda.synchronize()
            train_counts(fl_mod, sc_mod, reset=True)
            t0 = time.perf_counter()
            params, momentum, loss, metrics = step(params, momentum, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts = train_counts(fl_mod, sc_mod)
            check(counts == want, f"{arch} round {r}: launches {counts}, "
                                  f"wanted {want}")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            losses.append(float(loss))
            accs.append(float(metrics["acc"]))
            check(math.isfinite(losses[-1]), f"{arch}: loss {losses[-1]}")
            # momentum = 0.9 m + g: finite momentum means finite grads
            check(all_finite(torch, leaves(momentum)),
                  f"{arch} round {r}: a gradient is not finite")
            check(all_finite(torch, leaves(params)),
                  f"{arch} round {r}: a parameter is not finite")
        peak = torch.cuda.max_memory_allocated()
        rec = dict(phase="train_full_width_bf16" if bf16 else
                   "train_full_width", arch=arch, layers=cfg.n_layers,
                   params=n_params, dtype=str(dtype).split(".")[-1],
                   batch=b, seq_len=s_len,
                   weights=[WEIGHTS[i % len(WEIGHTS)] for i in range(b)],
                   microbatches=mb, local_passes=1, remat=True,
                   lr=DEFAULT_LR, rounds=TRAIN_ROUNDS, init_s=init_s,
                   step_s=secs, train_tok_per_s=[b * s_len / dt
                                                 for dt in secs],
                   loss=losses, acc=accs,
                   launches_per_step={k: v for k, v in want.items() if v},
                   peak_mem_bytes=peak, peak_mem_gib=peak / 2**30,
                   card=card)
        if beside is not None and arch in beside:
            f32 = beside[arch]
            rec["f32_same_run"] = {k: f32[k] for k in (
                "step_s", "train_tok_per_s", "peak_mem_gib")}
            rec["speedup_vs_f32"] = min(f32["step_s"]) / min(secs)
        emit(rec)
        recs[arch] = rec
        del params, momentum, step, batch, loss, metrics
        torch.cuda.empty_cache()
    return totals, recs


def train_card_vs_cpu(torch, np):
    """Phase 11a: a reduced step (3 layers) from the same init params on
    the card and on the CPU: the loss and every gradient leaf within 1e-4
    of its max-abs, then one ``fl_train_step``'s params and momentum."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels.parity import rel_err
    from repro_torch.launch.steps import make_fl_train_step
    from repro_torch.models import build_model, stacked
    from repro_torch.tree import leaves, tree_map

    def loss_and_grads(p, batch, cfg):
        for x in leaves(p):
            x.requires_grad_(True)
        loss, _ = stacked.loss_fn(p, cfg, batch, remat=True)
        loss.backward()
        grads = [x.grad for x in leaves(p)]
        for x in leaves(p):
            x.grad = None
            x.requires_grad_(False)
        return loss.item(), grads

    for arch in ("gemma2-2b", "recurrentgemma-9b"):
        cfg = reduced(get_config(arch), n_layers=3)
        b, s_len = 2, 256
        p_cpu = stacked.stack_params(build_model(cfg).init(0, "cpu"), cfg)
        p_card = tree_map(lambda x: x.to("cuda"), p_cpu)
        rng = np.random.default_rng(11)
        batch = {"tokens": torch.from_numpy(
                     rng.integers(0, cfg.vocab_size, (b, s_len))),
                 "labels": torch.from_numpy(
                     rng.integers(-1, cfg.vocab_size, (b, s_len))),
                 "weight": torch.tensor([1.0, 2.0])}
        batch_c = {k: v.to("cuda") for k, v in batch.items()}
        l_cpu, g_cpu = loss_and_grads(p_cpu, batch, cfg)
        l_card, g_card = loss_and_grads(p_card, batch_c, cfg)
        loss_err = abs(l_card - l_cpu) / abs(l_cpu)
        grad_err = max(rel_err(g, w) for g, w in zip(g_card, g_cpu))
        check(loss_err <= 1e-4, f"{arch}: card vs CPU loss {loss_err}")
        check(grad_err <= 1e-4, f"{arch}: card vs CPU grads {grad_err}")
        step, _ = make_fl_train_step(
            cfg, InputShape("t", seq_len=s_len, global_batch=b,
                            kind="train"), lr=1e-2, dtype=torch.float32)
        m_cpu = tree_map(torch.zeros_like, p_cpu)
        m_card = tree_map(torch.zeros_like, p_card)
        p_cpu, m_cpu, _, _ = step(p_cpu, m_cpu, batch)
        p_card, m_card, _, _ = step(p_card, m_card, batch_c)
        step_err = max(rel_err(g, w) for g, w in zip(
            leaves(p_card) + leaves(m_card), leaves(p_cpu) + leaves(m_cpu)))
        check(step_err <= 1e-4, f"{arch}: card vs CPU step {step_err}")
        emit(dict(phase="train_card_vs_cpu", arch=cfg.name,
                  layers=cfg.n_layers, batch=b, seq_len=s_len,
                  loss_cpu=l_cpu, loss_card=l_card, loss_rel_err=loss_err,
                  grad_max_rel_err=grad_err, step_max_rel_err=step_err,
                  tolerance=1e-4))


# ---------------------------------------------------------------------------
# phase 5/6: the LM serving path
# ---------------------------------------------------------------------------

SERVE_ARCH = "recurrentgemma-9b"


def serve_full_width(torch, np, card):
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fl_mod
    from repro_torch.kernels import rglru_scan as sc_mod
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    cfg = get_config(SERVE_ARCH)
    n_attn = sum(s.mixer == "attn" for s in cfg.layers)
    n_rglru = sum(s.mixer == "rglru" for s in cfg.layers)
    b, s_len, steps = 2, 4096, 32
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(params))
    # the analytic count leaves out three (W,) vectors of each RG-LRU
    # layer (conv_b and the gate biases), as the reference's does
    want = cfg.param_count() + 3 * (cfg.lru_width or cfg.d_model) * n_rglru
    check(n_params == want, f"{SERVE_ARCH}: {n_params} params, want {want}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (b, s_len), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    fl_mod.launches = 0
    sc_mod.launches = 0
    out = generate(model, params, prompt, steps)
    counts = {"flash_attention": fl_mod.launches,
              "rglru_scan": sc_mod.launches}
    check(counts == {"flash_attention": n_attn, "rglru_scan": n_rglru},
          f"{SERVE_ARCH}: launches {counts}, wanted {n_attn} flash_attention "
          f"and {n_rglru} rglru_scan (one prefill)")
    logits = torch.cat([out["prefill_logits"][None], out["step_logits"]])
    check(logits.shape == (steps + 1, b, cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "logits not all finite")
    check(out["ids"].shape == (b, steps + 1), "ids shape")

    # decode against prefill: prefill S-1 tokens, decode the last one
    cache = model.init_cache(b, max_len=s_len + 1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = model.prefill(params, prompt[:, :s_len - 1], cache)
    torch.cuda.synchronize()
    prefill2_s = time.perf_counter() - t0
    dec, _ = model.decode_step(params, prompt[:, s_len - 1], s_len - 1, cache)
    err = float((dec - out["prefill_logits"]).abs().max())
    check(err < 5e-3, f"decode vs prefill differ by {err} >= 5e-3")
    del cache
    peak = torch.cuda.max_memory_allocated()
    emit(dict(phase="serve_full_width", arch=SERVE_ARCH,
              layers=cfg.n_layers, params=n_params, dtype="float32",
              batch=b, prompt_len=s_len, decode_tokens=steps,
              init_s=init_s, prefill_s=out["prefill_s"],
              prefill_tok_per_s=out["prefill_tok_per_s"],
              prefill_s_again=prefill2_s,
              prefill_tok_per_s_again=b * (s_len - 1) / prefill2_s,
              decode_s=out["decode_s"],
              decode_tok_per_s=out["decode_tok_per_s"],
              decode_ms_per_step=out["decode_s"] / steps * 1e3,
              launches_per_prefill=counts,
              decode_vs_prefill_max_abs_err=err,
              logit_abs_max=float(logits.abs().max()),
              ids0=out["ids"][0].tolist(),
              peak_mem_bytes=peak, peak_mem_gib=peak / 2**30, card=card))
    del params, out, logits
    torch.cuda.empty_cache()
    return counts


def serve_card_vs_cpu(torch, np):
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    cfg = reduced(get_config(SERVE_ARCH), n_layers=3)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    b, s_len, steps = 2, 160, 8
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s_len)))
    cpu = generate(model, params, prompt, steps)
    params_c = tree_map(lambda p: p.to("cuda"), params)
    cache = model.init_cache(b, max_len=s_len + steps + 1, device="cuda")
    logits, cache = model.prefill(params_c, prompt.to("cuda"), cache)
    errs = [float((logits.cpu() - cpu["prefill_logits"]).abs().max())]
    for i in range(steps):
        tok = cpu["ids"][:, i].to("cuda")
        logits, cache = model.decode_step(params_c, tok, s_len + i, cache)
        errs.append(float((logits.cpu() - cpu["step_logits"][i])
                          .abs().max()))
    check(max(errs) <= 1e-4, f"card vs CPU logits differ by {max(errs)} "
                             f"> 1e-4 (per step {errs})")
    emit(dict(phase="serve_card_vs_cpu", arch=cfg.name, layers=cfg.n_layers,
              prompt_len=s_len, decode_tokens=steps, max_abs_err=errs,
              tolerance=1e-4))


# phase 5b: the rest of the zoo at full width.  Per config: the layers kept
# (None: all), batch, prompt, flash_attention launches per prefill, and the
# parameter count of the reference's tree (``repro.models.lm.init_params``;
# ``ModelConfig.param_count()`` leaves out the frontend projection and
# counts the xLSTM blocks otherwise).
ZOO = (
    ("xlstm-350m", None, 2, 2048, 0, 253_232_224),
    ("granite-moe-1b-a400m", None, 2, 4096, 24, 1_334_628_352),
    ("dbrx-132b", 2, 2, 2048, 2, 7_751_301_120),
    ("seamless-m4t-medium", None, 2, 512, 36, 716_451_840),
    ("internvl2-1b", None, 2, 2048, 24, 494_583_808),
)
# an xLSTM prompt is one mLSTM chunk or a multiple of it: decode is held
# against prefill at one chunk
XLSTM_CHECK_LEN = 128


def serve_zoo(torch, card):
    """Phase 5b: each of the other five LM families at full width through
    ``generate`` (f32 params drawn on the card, 32 greedy tokens).  Returns
    the ``flash_attention`` launches of their prefills."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fl_mod
    from repro_torch.kernels import rglru_scan as sc_mod
    from repro_torch.launch.serve import (cut_layers, frontend_input,
                                          generate, prefix_len)
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    steps, total = 32, 0
    for arch, keep, b, s_len, want_fl, want_params in ZOO:
        cfg = get_config(arch)
        if keep is not None:
            cfg = cut_layers(cfg, keep)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init(0, "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in leaves(params))
        check(n_params == want_params,
              f"{arch}: {n_params} params, want {want_params}")
        gen = torch.Generator(device="cuda").manual_seed(1)
        prompt = torch.randint(0, cfg.vocab_size, (b, s_len), generator=gen,
                               device="cuda")
        fe = frontend_input(cfg, b, gen, "cuda")
        p_len = prefix_len(cfg, fe)
        torch.cuda.synchronize()
        fl_mod.launches = 0
        sc_mod.launches = 0
        out = generate(model, params, prompt, steps, frontend=fe)
        counts = {"flash_attention": fl_mod.launches,
                  "rglru_scan": sc_mod.launches}
        check(counts == {"flash_attention": want_fl, "rglru_scan": 0},
              f"{arch}: launches {counts}, wanted {want_fl} flash_attention "
              "and no rglru_scan (one prefill)")
        total += counts["flash_attention"]
        logits = torch.cat([out["prefill_logits"][None], out["step_logits"]])
        check(logits.shape == (steps + 1, b, cfg.vocab_size),
              f"{arch}: logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()),
              f"{arch}: logits not all finite")
        check(out["prefix_len"] == p_len, f"{arch}: prefix length")

        # decode against prefill: prefill S-1 tokens, decode the last one
        s_chk = min(s_len, XLSTM_CHECK_LEN) if cfg.family == "ssm" else s_len
        if s_chk == s_len:
            want = out["prefill_logits"]
        else:
            cache = model.init_cache(b, max_len=s_chk + 1, device="cuda")
            want, _ = model.prefill(params, prompt[:, :s_chk], cache,
                                    frontend=fe)
        cache = model.init_cache(b, max_len=p_len + s_chk + 1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = model.prefill(params, prompt[:, :s_chk - 1], cache,
                                 frontend=fe)
        torch.cuda.synchronize()
        prefill2_s = time.perf_counter() - t0
        dec, _ = model.decode_step(params, prompt[:, s_chk - 1],
                                   p_len + s_chk - 1, cache)
        err = float((dec - want).abs().max())
        check(err < 5e-3, f"{arch}: decode vs prefill differ by {err} "
                          ">= 5e-3")
        peak = torch.cuda.max_memory_allocated()
        emit(dict(phase="serve_zoo", arch=arch, family=cfg.family,
                  layers=cfg.n_layers, of_layers=get_config(arch).n_layers,
                  params=n_params, dtype="float32", batch=b,
                  prompt_len=s_len, prefix_len=p_len,
                  frontend=None if fe is None else list(fe.shape),
                  decode_tokens=steps, init_s=init_s,
                  prefill_s=out["prefill_s"],
                  prefill_tok_per_s=out["prefill_tok_per_s"],
                  check_prompt_len=s_chk,
                  prefill_s_again=prefill2_s,
                  prefill_tok_per_s_again=b * (s_chk - 1) / prefill2_s,
                  decode_s=out["decode_s"],
                  decode_tok_per_s=out["decode_tok_per_s"],
                  decode_ms_per_step=out["decode_s"] / steps * 1e3,
                  launches_per_prefill=counts,
                  decode_vs_prefill_max_abs_err=err,
                  logit_abs_max=float(logits.abs().max()),
                  ids0=out["ids"][0].tolist(), peak_mem_bytes=peak,
                  peak_mem_gib=peak / 2**30, card=card))
        del params, out, logits, cache, dec, want
    torch.cuda.empty_cache()
    return total


def zoo_card_vs_cpu(torch, np):
    """Phase 6b: phase 6's rule for each of the five families, reduced to 3
    layers.  The router's expert ids are recorded on both devices; a route
    that flips is printed with its top-k margin before the logits are
    held to 1e-4."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.tree import tree_map

    inner = ffn_mod._route
    routes = []

    def route_spy(params, xf, moe):
        out = inner(params, xf, moe)
        probs = torch.softmax(xf.float() @ params["router"].float(), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values
        routes.append((out[1].cpu(), (top[:, moe.top_k - 1]
                                      - top[:, moe.top_k]).cpu()))
        return out

    ffn_mod._route = route_spy
    try:
        for arch, *_ in ZOO:
            cfg = reduced(get_config(arch), n_layers=3)
            model = build_model(cfg)
            params = model.init(0, "cpu")
            b, s_len, steps = 2, 64, 8
            rng = np.random.default_rng(2)
            prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                   (b, s_len)))
            fe = None if cfg.frontend is None else torch.from_numpy(
                rng.standard_normal((b, cfg.frontend.seq_len,
                                     cfg.frontend.feature_dim)).astype(
                                         np.float32))
            fe_c = None if fe is None else fe.to("cuda")
            routes.clear()
            cpu = generate(model, params, prompt, steps, frontend=fe)
            cpu_routes = list(routes)
            routes.clear()
            p_len = cpu["prefix_len"]
            params_c = tree_map(lambda p: p.to("cuda"), params)
            cache = model.init_cache(b, max_len=p_len + s_len + steps + 1,
                                     device="cuda")
            logits, cache = model.prefill(params_c, prompt.to("cuda"), cache,
                                          frontend=fe_c)
            errs = [float((logits.cpu() - cpu["prefill_logits"]).abs().max())]
            for i in range(steps):
                tok = cpu["ids"][:, i].to("cuda")
                logits, cache = model.decode_step(params_c, tok,
                                                  p_len + s_len + i, cache)
                errs.append(float((logits.cpu() - cpu["step_logits"][i])
                                  .abs().max()))
            flips = []
            for call, ((ids, margin), (ids_c, _)) in enumerate(
                    zip(cpu_routes, routes)):
                for tok in torch.nonzero((ids != ids_c).any(-1)).flatten():
                    flips.append(dict(call=call, token=int(tok),
                                      cpu=ids[tok].tolist(),
                                      card=ids_c[tok].tolist(),
                                      top_k_margin=float(margin[tok])))
            if flips:
                emit(dict(phase="serve_zoo_card_vs_cpu", arch=cfg.name,
                          route_flips=flips))
            check(len(cpu_routes) == len(routes),
                  f"{cfg.name}: {len(cpu_routes)} routes on the CPU, "
                  f"{len(routes)} on the card")
            check(max(errs) <= 1e-4,
                  f"{cfg.name}: card vs CPU logits differ by {max(errs)} "
                  f"> 1e-4 (per step {errs}; route flips {len(flips)})")
            emit(dict(phase="serve_zoo_card_vs_cpu", arch=cfg.name,
                      layers=cfg.n_layers, prompt_len=s_len,
                      prefix_len=p_len, decode_tokens=steps,
                      moe_routes_compared=len(routes),
                      route_flips=len(flips), max_abs_err=errs,
                      tolerance=1e-4))
    finally:
        ffn_mod._route = inner


# ---------------------------------------------------------------------------
# phase 12: the paper's ResNets and its speech-command FedTune experiment
# ---------------------------------------------------------------------------

# name, BasicBlocks per stage, in_channels, n_classes, the reference tree's
# parameter count (Table 2's four in the speech shape; two in CIFAR-100's)
RESNETS = (("resnet10", (1, 1, 1, 1), 1, 35, 79_259),
           ("resnet18", (2, 2, 2, 2), 1, 35, 177_659),
           ("resnet26", (3, 3, 3, 3), 1, 35, 276_059),
           ("resnet34", (3, 4, 6, 3), 1, 35, 336_411),
           ("resnet10_cifar100", (1, 1, 1, 1), 3, 100, 83_628),
           ("resnet18_cifar100", (2, 2, 2, 2), 3, 100, 182_028))


def resnet_models(torch, np, card):
    """Phase 12a: each ResNet at B=32 on the card against the CPU from the
    same params and images, with torch's default ``cudnn.allow_tf32 =
    True`` in force: the model's own guard must keep its convolutions in
    f32.  Every convolution of the card's forward and backward is held
    against the same call in f64 on the CPU, on the card's own inputs,
    within 1e-4 of the result's max-abs (TF32 misses that by ~10x); the
    logits and loss end to end within 1e-4 of the CPU's.  The gradients
    end to end are reported beside the CPU's own change when the params
    move by a relative 1e-6: a ReLU input within rounding of 0 takes the
    other side on the other device, so a deep ReLU net's f32 gradients
    need not agree to 1e-4 of a leaf's max-abs (ROADMAP.md section 3).
    Two card backward passes must be bitwise equal.  Prints the card's
    forward+backward time."""
    import torch.nn.functional as F

    from repro_torch.configs.paper_models import resnet
    from repro_torch.kernels.parity import rel_err
    from repro_torch.models import build_model
    from repro_torch.models import resnet as resnet_mod
    from repro_torch.tree import leaves, unflatten_like

    conv = resnet_mod._Conv2d
    fwd0, bwd0 = conv.forward, conv.backward
    op_errs = None                    # a list while recording

    def fwd(x, w, stride, padding):
        out = fwd0(x, w, stride, padding)
        if op_errs is not None and x.is_cuda:
            op_errs.append(("fprop", rel_err(out, F.conv2d(
                x.double().cpu(), w.double().cpu(), stride=stride,
                padding=padding))))
        return out

    def bwd(ctx, grad):
        gx, gw, a, b = bwd0(ctx, grad)
        if op_errs is not None and grad.is_cuda:
            x, w = ctx.saved_tensors
            rx, rw, _ = torch.ops.aten.convolution_backward(
                grad.double().cpu(), x.double().cpu(), w.double().cpu(),
                None, list(ctx.stride), list(ctx.padding), [1, 1], False,
                [0, 0], 1, [gx is not None, True, False])
            if gx is not None:
                op_errs.append(("dgrad", rel_err(gx, rx)))
            op_errs.append(("wgrad", rel_err(gw, rw)))
        return gx, gw, a, b

    def train_step(model, template, flat, x, y, scale=None):
        if scale is not None:
            flat = [t * s for t, s in zip(flat, scale)]
        p = [t.detach().requires_grad_(True) for t in flat]
        loss, _ = model.loss_fn(unflatten_like(template, p),
                                {"x": x, "y": y})
        return loss.detach(), torch.autograd.grad(loss, p)

    def max_rel(got, want):
        return max(rel_err(g, w) for g, w in zip(got, want))

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    conv.forward, conv.backward = staticmethod(fwd), staticmethod(bwd)
    try:
        for i, (name, blocks, ch, n_cls, count) in enumerate(RESNETS):
            model = build_model(resnet(name, blocks, n_classes=n_cls,
                                       in_channels=ch))
            p_cpu = model.init(i, "cpu")
            flat = leaves(p_cpu)
            n = sum(t.numel() for t in flat)
            check(n == count, f"12a {name}: {n} params, the reference's "
                              f"tree has {count}")
            rng = np.random.default_rng(100 + i)
            x = torch.from_numpy(rng.standard_normal(
                (32, 32, 32, ch)).astype(np.float32))
            y = torch.from_numpy(rng.integers(0, n_cls, 32))
            gen = torch.Generator().manual_seed(i)
            nudge = [1.0 + 1e-6 * torch.randn(t.shape, generator=gen)
                     for t in flat]
            loss_cpu, g_cpu = train_step(model, p_cpu, flat, x, y)
            _, g_nudged = train_step(model, p_cpu, flat, x, y, nudge)
            with torch.no_grad():
                logits_cpu = model.forward(p_cpu, x)
            dev_flat = [t.cuda() for t in flat]
            xd, yd = x.cuda(), y.cuda()
            op_errs = []
            with torch.no_grad():
                logits = model.forward(unflatten_like(p_cpu, dev_flat), xd)
            loss, g_card = train_step(model, p_cpu, dev_flat, xd, yd)
            errs, op_errs = op_errs, None
            _, g_again = train_step(model, p_cpu, dev_flat, xd, yd)
            torch.cuda.synchronize()
            check(torch.backends.cudnn.allow_tf32,
                  f"12a {name}: the model's guard did not restore the "
                  "caller's cudnn.allow_tf32")
            worst = {k: max(e for kind, e in errs if kind == k)
                     for k in ("fprop", "dgrad", "wgrad")}
            logit_err = float((logits.cpu() - logits_cpu).abs().max())
            loss_err = abs(float(loss) - float(loss_cpu))
            repeat = all(torch.equal(a, b) for a, b in zip(g_card, g_again))
            check(max(worst.values()) <= 1e-4,
                  f"12a {name}: a convolution on the card is off its f64 "
                  f"value by {worst} of its max-abs > 1e-4")
            check(logit_err <= 1e-4, f"12a {name}: logits differ by "
                                     f"{logit_err} > 1e-4")
            check(loss_err <= 1e-4, f"12a {name}: loss differs by "
                                    f"{loss_err}")
            check(repeat, f"12a {name}: two card backward passes differ")
            ms = median_ms(torch, lambda: train_step(
                model, p_cpu, dev_flat, xd, yd), None, iters=20)
            emit(dict(phase="resnet_models", model=name, blocks=blocks,
                      in_channels=ch, n_classes=n_cls, params=n,
                      leaves=len(flat), batch=32, image=32,
                      cudnn_allow_tf32_in_force=True,
                      convolutions_checked=len(errs),
                      max_conv_err_of_max_abs=worst,
                      max_abs_logit_err=logit_err, loss_err=loss_err,
                      grad_err_of_max_abs=max_rel(g_card, g_cpu),
                      cpu_grad_change_at_1e6_nudge=max_rel(g_nudged,
                                                           g_cpu),
                      card_repeat_bitwise=repeat, fwd_bwd_ms=ms,
                      card=card))
    finally:
        conv.forward, conv.backward = staticmethod(fwd0), staticmethod(bwd0)
        torch.backends.cudnn.allow_tf32 = prev


def speech_trials(torch, card):
    """Phase 12b: ResNet-10 over the full ``speech_command_like``
    federation with ``examples/fedtune_speech.py``'s settings
    (``profile_trial.smoke_server(model_cfg=RESNET10)``), FedTune on, from
    one set of initial params.  Each kernel's launch count is set to 0
    just before each run and read just after."""
    from repro_torch.configs.paper_models import RESNET10
    from repro_torch.kernels import fed_aggregate as fa_mod
    from repro_torch.kernels import fed_reduce as fr_mod
    from repro_torch.launch.profile_trial import smoke_server
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, tree_map

    init_params = build_model(RESNET10).init(0, "cpu")
    plans = (("sync", "sync", dict(max_rounds=5)),
             ("sync_batched", "sync", dict(max_rounds=5,
                                           client_exec="batched")),
             ("async", "async", dict(max_rounds=10,
                                     fleet_name="stragglers")),
             ("buffered", "buffered", dict(max_rounds=2, buffer_k=8,
                                           fleet_name="stragglers")),
             ("sync_int8", "sync", dict(max_rounds=3, compression="int8")))
    runs = {}
    launches = {"fed_reduce": 0, "fed_aggregate": 0}
    for label, mode, kw in plans:
        srv = smoke_server(mode, model_cfg=RESNET10, device="cuda", **kw)
        params = tree_map(lambda p: p.to("cuda"), init_params)
        torch.cuda.synchronize()
        fr_mod.launches = 0
        fa_mod.launches = 0
        t0 = time.perf_counter()
        res = srv.run(params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"fed_reduce": fr_mod.launches,
                  "fed_aggregate": fa_mod.launches}
        for k, v in counts.items():
            launches[k] += v
        check(res.rounds == kw["max_rounds"],
              f"12b {label}: ran {res.rounds} aggregations, wanted "
              f"{kw['max_rounds']}")
        check(all(p.device.type == "cuda" for p in leaves(res.params)),
              f"12b {label}: final params are not all on cuda")
        accs = [h.accuracy for h in res.history]
        check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
              f"12b {label}: accuracy not finite in [0, 1]: {accs}")
        check(all(c > 0 for c in res.total_cost.as_tuple()),
              f"12b {label}: cost totals not all positive")
        check(srv.local_steps > 0, f"12b {label}: no local steps ran")
        emit(dict(phase="speech_trial", run=label, mode=mode,
                  model="resnet10",
                  params=sum(p.numel() for p in leaves(init_params)),
                  clients=srv.dataset.n_clients, rounds=res.rounds,
                  m_e=[(h.m, h.e) for h in res.history], accuracy=accs,
                  costs=list(res.total_cost.as_tuple()),
                  sim_time=res.sim_time, wall_s=wall,
                  rounds_per_s=res.rounds / wall,
                  local_steps=srv.local_steps,
                  local_steps_per_s=srv.local_steps / wall,
                  launches=counts, card=card))
        runs[label] = res
    check(launches["fed_reduce"] > 0, "12b: fed_reduce never launched")
    check(launches["fed_aggregate"] > 0, "12b: fed_aggregate never launched")
    return runs, launches, init_params


def speech_card_vs_cpu(runs, init_params):
    """Phase 12c: the first 3 sync rounds on the CPU from the same initial
    params against the card's, and the card's batched cohort against its
    sequential clients, by the record rule (``same_records``)."""
    from repro_torch.configs.paper_models import RESNET10
    from repro_torch.launch.profile_trial import smoke_server

    n_rounds = 3
    srv = smoke_server("sync", model_cfg=RESNET10, max_rounds=n_rounds,
                       device="cpu")
    t0 = time.perf_counter()
    cpu = srv.run(init_params)
    wall = time.perf_counter() - t0
    emit(dict(phase="speech_card_vs_cpu", cpu_wall_s=wall,
              **same_records("12c card vs cpu", runs["sync"].history,
                             cpu.history, n_rounds)))
    emit(dict(phase="speech_batched_vs_sequential",
              **same_records("12c batched vs sequential",
                             runs["sync"].history,
                             runs["sync_batched"].history, n_rounds)))


def resnet_kernel_cases(torch, np, card, floor):
    """Phase 12d: ``fed_reduce`` and ``fed_aggregate`` at ResNet's shapes
    (N = 79,259 and 336,411; the int8 pre-pass over its 32 and 104
    leaves), each held bitwise against its plain version."""
    from repro_torch.configs.paper_models import RESNET10, RESNET34
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    rng = np.random.default_rng(12)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    out = []

    def t(a):
        return torch.from_numpy(np.asarray(a)).cuda()

    for tag, cfg in (("resnet10", RESNET10), ("resnet34", RESNET34)):
        sizes = tuple(p.numel() for p in leaves(
            build_model(cfg).init(0, "cpu")))
        n = sum(sizes)
        for m in ((5, 20) if tag == "resnet10" else (20,)):
            name = f"{tag}_fedavg" + (f"_m{m}" if tag == "resnet10" else "")
            out.append(fed_reduce_case(
                torch, card, flush, floor, name, t(rng.integers(
                    1, 317, m).astype(np.float32)),
                t(rng.standard_normal((m, n)).astype(np.float32) * 0.05),
                t(np.zeros(m, np.int32)), 1, None, True))
        m = 20
        g = rng.standard_normal((1, n)).astype(np.float32) * 0.05
        rows = g + rng.standard_normal((m, n)).astype(np.float32) * 1e-2
        rec = fed_reduce_case(
            torch, card, flush, floor, f"{tag}_int8",
            t(rng.integers(1, 317, m).astype(np.float32)), t(rows),
            t(np.zeros(m, np.int32)), 1, None, True,
            (t(g), t(np.ones(m, bool))), sizes)
        rec["leaves"] = len(sizes)
        out.append(rec)
    n = 79_259
    out.append(fed_aggregate_case(
        torch, card, flush, floor, "resnet10_fedasync",
        t(rng.uniform(0.0, 1.0, 1).astype(np.float32)),
        t(rng.standard_normal((1, n)).astype(np.float32) * 0.05),
        t(rng.standard_normal(n).astype(np.float32) * 0.05)))
    del flush
    return out


# ---------------------------------------------------------------------------
# phase 13: the sharded FedTune path, two ranks on the card
# ---------------------------------------------------------------------------

COHORT_M = 64                       # 13a's fixed cohort


def params_hash(params) -> str:
    import hashlib
    from repro_torch.tree import leaves
    h = hashlib.sha256()
    for p in leaves(params):
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def cohort_fedavg(np, params, mesh=None):
    """13a's round over the full ``emnist_like`` federation: a fixed
    cohort of 64 of its 2,520 clients, ``MLP_EMNIST``, E=2, batch 10, SGD
    lr 0.03 momentum 0.9, from ``params``.  With ``mesh``, through
    ``sharded_fedavg_train``; without, ``batched_local_train`` + FedAvg in
    this process."""
    from repro_torch.configs.paper_models import MLP_EMNIST
    from repro_torch.data import emnist_like
    from repro_torch.federated import get_aggregator
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.runtime import batched_local_train, sharded_fedavg_train

    ds = emnist_like(seed=0)
    cids = [int(c) for c in np.random.default_rng(13).choice(
        ds.n_clients, COHORT_M, replace=False)]
    data = [ds.client_data(c) for c in cids]
    kw = dict(passes=2.0, batch_size=10,
              optimizer=get_optimizer("sgd", 0.03, momentum=0.9),
              rng=np.random.default_rng(21), client_ids=cids)
    model = build_model(MLP_EMNIST)
    if mesh is not None:
        return sharded_fedavg_train(model, params, data, mesh=mesh,
                                    **kw).params
    return get_aggregator("fedavg")(params, batched_local_train(
        model, params, data, **kw))


def sharded_rank(mesh, init_np, speech_np):
    """Phase 13's four cases on one rank (a process ``run_ranks``
    spawned).  Each case sets the rank's ``fed_reduce`` launch count and
    sharded-round count to 0 just before and reads them just after."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_models import RESNET10
    from repro_torch.experiments import run_sweep
    from repro_torch.kernels import fed_reduce as fr_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.profile_sweep import full_width_grid
    from repro_torch.launch.profile_trial import smoke_server
    from repro_torch.runtime import sharded
    from repro_torch.tree import leaves
    from repro_torch.weights import params_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False    # as in main()
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    out = dict(rank=mesh.rank, size=mesh.size, backend=mesh.backend,
               device=str(dev))

    def run(case, fn):
        torch.cuda.synchronize()
        fr_mod.launches = 0
        sharded.rounds = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[case] = dict(wall_s=time.perf_counter() - t0,
                         fed_reduce_launches=fr_mod.launches,
                         sharded_rounds=sharded.rounds)
        return res

    agg = run("13a", lambda: cohort_fedavg(
        np, params_from_numpy(init_np, dev), mesh))
    out["13a"].update(params=leaves(agg), hash=params_hash(agg))

    srv = smoke_server("sync", m=20, max_rounds=5, client_exec="sharded",
                       device=dev)
    res = run("13b", lambda: srv.run(params_from_numpy(init_np, dev)))
    out["13b"].update(history=res.history, rounds=res.rounds,
                      hash=params_hash(res.params))

    # 13c: every fed_reduce call of the first round, kept for the check
    first, inner = [], ops.fed_reduce

    def spy(w, rows, seg, t, base=None, **kw):
        got = inner(w, rows, seg, t, base, **kw)
        if sharded.rounds == 1:
            first.append((w, rows, seg, t, kw, got))
        return got

    ops.fed_reduce = spy
    try:
        srv = smoke_server("sync", model_cfg=RESNET10, max_rounds=2,
                           compression="int8", client_exec="sharded",
                           device=dev)
        res = run("13c", lambda: srv.run(params_from_numpy(speech_np, dev)))
    finally:
        ops.fed_reduce = inner
    partials = []
    for w, rows, seg, t, kw, got in first:
        want = ref.fed_reduce_ref(w, rows, seg, t, **kw)
        partials.append(dict(
            M=rows.shape[0], N=rows.shape[1], T=t,
            leaves=len(kw["leaf_sizes"] or ()),
            int8=kw.get("quant_ref") is not None,
            equal=bool(torch.equal(got, want)),
            max_abs_err=float((got - want).abs().max())))
    out["13c"].update(history=res.history, rounds=res.rounds,
                      hash=params_hash(res.params),
                      first_round_partials=partials)

    specs = full_width_grid(rounds=5).expand()
    res = run("13d", lambda: run_sweep(specs, pack="sharded", device=dev))
    out["13d"].update(
        trial_rounds=sum(r.rounds for r in res),
        engines=sorted({r.engine for r in res}),
        trials={r.spec.key(): dict(
            m_e=list(zip(r.history_m, r.history_e)), acc=r.history_acc,
            cost=list(r.cost), hash=params_hash(r.params)) for r in res})
    return out


def sharded_phase(torch, np, card, init_params, sync_res, sync_wall,
                  speech_init, sweep_records):
    """Phase 13: the sharded FedTune path on the card.  Two ranks spawned
    by ``launch.mesh.run_ranks``, both on ``cuda:0`` over gloo with CUDA
    tensors (the kernels built once, here, before the spawn), run
    ``sharded_rank``'s cases; this process checks them against phase 3's
    and phase 7's records, a batched speech trial and a batched
    ``cohort_fedavg`` on the card, and runs 13a once more in a 1-rank NCCL
    group.  Returns phase 13's ``fed_reduce`` launches."""
    import os
    import tempfile

    from repro_torch.configs.paper_models import RESNET10
    from repro_torch.kernels import fed_reduce as fr_mod
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.profile_trial import smoke_server
    from repro_torch.tree import leaves, tree_map

    def to_np(tree):
        return tree_map(lambda p: p.detach().cpu().numpy(), tree)

    def on_card(tree):
        return tree_map(lambda p: p.to("cuda"), tree)

    t13 = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    ranks = mesh_mod.run_ranks(
        sharded_rank, 2, device="cuda",
        init_file=os.path.join(tmp, "rendezvous"),
        args=(to_np(init_params), to_np(speech_init)), threads=4,
        timeout_s=600.0)
    ranks_s = time.perf_counter() - t13
    launches = 0
    for r in ranks:
        check((r["device"], r["backend"], r["size"]) == ("cuda:0", "gloo", 2),
              f"13: rank {r['rank']} ran on {r['device']} over "
              f"{r['backend']} in a group of {r['size']}")
        for case in ("13a", "13b", "13c", "13d"):
            check(r[case]["fed_reduce_launches"] > 0,
                  f"{case}: rank {r['rank']} never launched fed_reduce")
            check(r[case]["sharded_rounds"] > 0,
                  f"{case}: rank {r['rank']} ran no sharded round (the "
                  "batched fallback ran)")
            launches += r[case]["fed_reduce_launches"]
    r0, r1 = ranks

    # 13a: the ranks against each other and a batched round on the card
    want = cohort_fedavg(np, on_card(init_params))
    diff = max(float((a.cuda() - b).abs().max())
               for a, b in zip(r0["13a"]["params"], leaves(want)))
    check(r0["13a"]["hash"] == r1["13a"]["hash"],
          "13a: the two ranks' aggregates differ")
    check(diff <= 1e-4, f"13a: sharded aggregate {diff} from the batched "
                        "one (> 1e-4)")
    # ... and once more in a 1-rank NCCL group, in this process
    mesh = mesh_mod.join(0, 1, device="cuda",
                         init_method="file://" + os.path.join(tmp, "nccl"))
    try:
        check(mesh.backend == "nccl", f"13a: 1-rank group on {mesh.backend}")
        torch.cuda.synchronize()
        fr_mod.launches = 0
        one = cohort_fedavg(np, on_card(init_params), mesh)
        torch.cuda.synchronize()
        nccl_launches = fr_mod.launches
    finally:
        mesh_mod.leave()
    diff1 = max(float((a - b).abs().max())
                for a, b in zip(leaves(one), leaves(want)))
    check(nccl_launches > 0, "13a: the NCCL run never launched fed_reduce")
    check(diff1 <= 1e-4, f"13a: the 1-rank NCCL aggregate {diff1} from the "
                         "batched one (> 1e-4)")
    launches += nccl_launches
    emit(dict(phase="sharded", case="13a", model="mlp_emnist",
              params=N_PARAMS, cohort=COHORT_M, ranks=2,
              max_abs_diff_vs_batched=diff, ranks_bitwise_equal=True,
              rank_wall_s=[r["13a"]["wall_s"] for r in ranks],
              launches=[r["13a"]["fed_reduce_launches"] for r in ranks],
              sharded_rounds=[r["13a"]["sharded_rounds"] for r in ranks],
              nccl_1rank=dict(max_abs_diff_vs_batched=diff1,
                              launches=nccl_launches), card=card))

    # 13b: the FedTune trial against phase 3's records
    rec = same_records("13b sharded vs phase 3", sync_res.history,
                       r0["13b"]["history"], 5)
    check(r0["13b"]["hash"] == r1["13b"]["hash"],
          "13b: the two ranks' final params differ")
    check([h.accuracy for h in r0["13b"]["history"]]
          == [h.accuracy for h in r1["13b"]["history"]],
          "13b: the two ranks' accuracies differ")
    emit(dict(phase="sharded", case="13b", ranks=2, **rec,
              ranks_bitwise_equal=True,
              rounds_per_s=[r["13b"]["rounds"] / r["13b"]["wall_s"]
                            for r in ranks],
              phase3_rounds_per_s=sync_res.rounds / sync_wall,
              launches=[r["13b"]["fed_reduce_launches"] for r in ranks],
              sharded_rounds=[r["13b"]["sharded_rounds"] for r in ranks],
              card=card))

    # 13c: the int8 speech trial against a batched run on the card
    t0 = time.perf_counter()
    bat = smoke_server("sync", model_cfg=RESNET10, max_rounds=2,
                       compression="int8", client_exec="batched",
                       device="cuda").run(on_card(speech_init))
    bat_wall = time.perf_counter() - t0
    rec = same_records("13c sharded vs batched", bat.history,
                       r0["13c"]["history"], 2)
    check(r0["13c"]["hash"] == r1["13c"]["hash"],
          "13c: the two ranks' final params differ")
    for r in ranks:
        parts = r["13c"]["first_round_partials"]
        check(parts and all(c["equal"] and c["int8"] and c["leaves"] == 32
                            for c in parts),
              f"13c: rank {r['rank']}'s first-round fed_reduce partials are "
              f"not bitwise the plain version's at 32 int8 leaves: {parts}")
    emit(dict(phase="sharded", case="13c", model="resnet10", ranks=2,
              **rec, ranks_bitwise_equal=True,
              first_round_partials=[r["13c"]["first_round_partials"]
                                    for r in ranks],
              rounds_per_s=[r["13c"]["rounds"] / r["13c"]["wall_s"]
                            for r in ranks],
              batched_rounds_per_s=bat.rounds / bat_wall,
              launches=[r["13c"]["fed_reduce_launches"] for r in ranks],
              sharded_rounds=[r["13c"]["sharded_rounds"] for r in ranks],
              card=card))

    # 13d: the 48-trial sweep against phase 7's records
    t0, t1 = r0["13d"]["trials"], r1["13d"]["trials"]
    check(set(t0) == set(t1) == set(sweep_records),
          "13d: the sharded sweep's trials are not phase 7's")
    diffs = []
    for key, (m_e, acc, cost) in sweep_records.items():
        got = t0[key]
        check(got["m_e"] == m_e, f"13d {key}: (M, E) differ")
        check(got["cost"] == cost, f"13d {key}: costs differ")
        diffs.append(max(abs(a - b) for a, b in zip(acc, got["acc"])))
        check(got["hash"] == t1[key]["hash"] and got["acc"]
              == t1[key]["acc"], f"13d {key}: the two ranks differ")
    check(max(diffs) <= 0.01, f"13d: accuracy differs by {max(diffs)}")
    emit(dict(phase="sharded", case="13d", ranks=2, trials=len(t0),
              engines=r0["13d"]["engines"], m_e_equal=True, costs_equal=True,
              max_acc_diff=max(diffs), ranks_bitwise_equal=True,
              trial_rounds_per_s=[r["13d"]["trial_rounds"]
                                  / r["13d"]["wall_s"] for r in ranks],
              launches=[r["13d"]["fed_reduce_launches"] for r in ranks],
              sharded_rounds=[r["13d"]["sharded_rounds"] for r in ranks],
              card=card))
    emit(dict(phase="sharded", ranks_s=ranks_s,
              seconds=time.perf_counter() - t13, fed_reduce_launches=launches))
    return launches


def sharded_reduce_case(torch, np, card, floor):
    """``fed_reduce`` at a rank's shape from 13a: T=1, M_loc=32 (64 clients
    over 2 ranks), N=169,462, FedAvg weights n_k / n_total (normalised on
    the host, as ``sharded_fedavg_train`` passes them)."""
    rng = np.random.default_rng(13)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    m = COHORT_M // 2
    sizes = rng.integers(1, 317, COHORT_M).astype(np.float64)
    w = (sizes / sizes.sum())[:m].astype(np.float32)
    rec = fed_reduce_case(
        torch, card, flush, floor, "sharded_rank_fedavg",
        torch.from_numpy(w).cuda(),
        torch.from_numpy(rng.standard_normal((m, N_PARAMS)).astype(
            np.float32) * 0.05).cuda(),
        torch.zeros(m, dtype=torch.int32, device="cuda"), 1, None, False)
    del flush
    return rec


# ---------------------------------------------------------------------------
# phase 14: the bf16 production steps (make_fl_train_step, make_prefill_step,
# make_serve_step at dtype=torch.bfloat16)
# ---------------------------------------------------------------------------

def bf16_train_card_vs_cpu(torch, np):
    """Phase 14b: a reduced bf16 step (3 layers, B=2 x S=256) from the same
    bf16 init params on the card and on the CPU: the loss within 1e-2
    relative and every gradient leaf within 3e-2 of its max-abs (each
    side's distance from the f32 gradient of the same params printed
    beside); then one ``fl_train_step`` with microbatches=2 and
    local_passes=2 on both: momentum within 3e-2 of each leaf's max-abs,
    params within 2 bf16 ulps plus what that moves them by (lr x 3e-2 x
    max |m|)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels.parity import bf16_ulps, rel_err
    from repro_torch.launch.steps import make_fl_train_step
    from repro_torch.models import build_model, stacked
    from repro_torch.tree import leaves, tree_map

    tol, lr = 3e-2, 1e-2
    bf = torch.bfloat16

    def loss_and_grads(p, batch, cfg):
        for x in leaves(p):
            x.requires_grad_(True)
        loss, _ = stacked.loss_fn(p, cfg, batch, remat=True)
        loss.backward()
        grads = [x.grad for x in leaves(p)]
        for x in leaves(p):
            x.grad = None
            x.requires_grad_(False)
        return loss.item(), grads

    for arch in ("gemma2-2b", "recurrentgemma-9b"):
        cfg = reduced(get_config(arch), n_layers=3)
        b, s_len = 2, 256
        p_cpu = tree_map(lambda x: x.to(bf), stacked.stack_params(
            build_model(cfg).init(0, "cpu"), cfg))
        p_card = tree_map(lambda x: x.to("cuda"), p_cpu)
        p_f32 = tree_map(lambda x: x.float(), p_cpu)
        rng = np.random.default_rng(14)
        batch = {"tokens": torch.from_numpy(
                     rng.integers(0, cfg.vocab_size, (b, s_len))),
                 "labels": torch.from_numpy(
                     rng.integers(-1, cfg.vocab_size, (b, s_len))),
                 "weight": torch.tensor([1.0, 2.0])}
        batch_c = {k: v.to("cuda") for k, v in batch.items()}
        l_cpu, g_cpu = loss_and_grads(p_cpu, batch, cfg)
        l_card, g_card = loss_and_grads(p_card, batch_c, cfg)
        l_f32, g_f32 = loss_and_grads(p_f32, batch, cfg)
        loss_err = abs(l_card - l_cpu) / abs(l_cpu)
        grad_errs = [rel_err(g.cpu(), w) for g, w in zip(g_card, g_cpu)]
        card_f32 = max(rel_err(g.cpu(), w) for g, w in zip(g_card, g_f32))
        cpu_f32 = max(rel_err(g, w) for g, w in zip(g_cpu, g_f32))
        check(all(g.dtype == bf for g in g_card), f"{arch}: grads not bf16")
        check(loss_err <= 1e-2, f"{arch}: bf16 card vs CPU loss {loss_err}")
        check(max(grad_errs) <= tol, f"{arch}: bf16 card vs CPU grads "
                                     f"{max(grad_errs)} > {tol} (card vs "
                                     f"f32 {card_f32}, CPU vs f32 {cpu_f32})")
        shape = InputShape("t", seq_len=s_len, global_batch=b, kind="train")
        step, _ = make_fl_train_step(cfg, shape, lr=lr, microbatches=2,
                                     local_passes=2)
        m_cpu = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32),
                         p_cpu)
        m_card = tree_map(lambda x: x.to("cuda"), m_cpu)
        p_cpu, m_cpu, _, _ = step(p_cpu, m_cpu, batch)
        p_card, m_card, _, _ = step(p_card, m_card, batch_c)
        m_err = max(rel_err(g.cpu(), w) for g, w in zip(leaves(m_card),
                                                         leaves(m_cpu)))
        p_ulps = max(bf16_ulps(g, w, lr * tol * float(m.abs().max()))
                     for g, w, m in zip(leaves(p_card), leaves(p_cpu),
                                        leaves(m_cpu)))
        check(m_err <= tol, f"{arch}: bf16 step momentum card vs CPU {m_err}")
        check(p_ulps <= 2.0, f"{arch}: bf16 step params card vs CPU "
                             f"{p_ulps} ulps")
        emit(dict(phase="train_card_vs_cpu_bf16", arch=cfg.name,
                  layers=cfg.n_layers, batch=b, seq_len=s_len,
                  loss_cpu=l_cpu, loss_card=l_card, loss_f32=l_f32,
                  loss_rel_err=loss_err, grad_max_rel_err=max(grad_errs),
                  grad_card_vs_f32=card_f32, grad_cpu_vs_f32=cpu_f32,
                  step_micro2_passes2=dict(momentum_max_rel_err=m_err,
                                           params_max_bf16_ulps=p_ulps),
                  tolerance=tol))


SERVE_BF16 = (
    # arch, the reference tree's parameter count
    ("gemma2-2b", 2_614_222_080),
    ("recurrentgemma-9b", None),
)


def bf16_serve(torch, np, card):
    """Phase 14c: ``make_prefill_step`` and ``make_serve_step`` at bf16,
    full width and depth, bf16 params drawn on the card: a 4,096-token
    prompt at B=2 into a 32,768-position cache (cut from ``prefill_32k``'s
    B=32, S=32,768), then 32 serve steps at B=8 (cut from ``decode_32k``'s
    B=128) after a B=8 prefill, with bf16 weights and then int8 weights
    (``quantize_params``, dequantised in every step) fed the bf16 run's
    tokens.  Checks: finite logits; the last decode step within 5e-2 of a
    re-prefill over prompt + tokens (of its max-abs); every int8 step
    within 5e-2 of the bf16 step's max-abs.  Timing: the prefill is called
    once to warm up and then three times, and the median call is kept; each
    serve step is timed alone and the median step kept (the first is the
    step's first call).  Returns the launch counts of the B=2 prefill calls
    (set to 0 just before them)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels import flash_attention as fl_mod
    from repro_torch.kernels import rglru_scan as sc_mod
    from repro_torch.kernels.parity import rel_err
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          quantize_params)
    from repro_torch.models import stacked
    from repro_torch.tree import leaves

    bf = torch.bfloat16
    max_len, prompt_len, b_pre, b_dec, steps = 32768, 4096, 2, 8, 32
    prefill_calls = 3
    totals = {}
    for arch, n_want in SERVE_BF16:
        cfg = get_config(arch)
        n_attn = sum(sp.mixer == "attn" for sp in cfg.layers)
        n_rglru = sum(sp.mixer == "rglru" for sp in cfg.layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(3)
        params = stacked.init_params_stacked(cfg, gen, bf)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in leaves(params))
        if n_want is not None:
            check(n_params == n_want, f"{arch}: {n_params} params")
        pre, _ = make_prefill_step(cfg, InputShape(
            "prefill_32k_cut", seq_len=max_len, global_batch=b_pre,
            kind="prefill"))
        serve, _ = make_serve_step(cfg, InputShape(
            "decode_32k_cut", seq_len=max_len, global_batch=b_dec,
            kind="decode"))
        tgen = torch.Generator(device="cuda").manual_seed(4)
        prompt = torch.randint(0, cfg.vocab_size, (b_dec, prompt_len),
                               generator=tgen, device="cuda")
        # prefill at B=2, counted: one warm-up call at the timed shape,
        # then the median of prefill_calls timed calls
        torch.cuda.synchronize()
        train_counts(fl_mod, sc_mod, reset=True)
        prefill_times = []
        for i in range(1 + prefill_calls):
            t0 = time.perf_counter()
            logits, cache = pre(params, prompt[:b_pre])
            torch.cuda.synchronize()
            if i:
                prefill_times.append(time.perf_counter() - t0)
            if i < prefill_calls:
                del logits, cache
        prefill_s = sorted(prefill_times)[len(prefill_times) // 2]
        counts = {k: v for k, v in train_counts(fl_mod, sc_mod).items() if v}
        want = {k: v * (1 + prefill_calls) for k, v in (
            ("flash_attention_bf16", n_attn), ("rglru_scan", n_rglru)) if v}
        check(counts == want, f"{arch}: bf16 prefill launches {counts}, "
                              f"wanted {want}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        check(logits.dtype == torch.float32 and
              bool(torch.isfinite(logits).all()), f"{arch}: prefill logits")
        del cache, logits
        prefill_peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        # the serve steps at B=8: a prefill into the cache, then 32 tokens
        pre8, _ = make_prefill_step(cfg, InputShape(
            "prefill_32k_cut", seq_len=max_len, global_batch=b_dec,
            kind="prefill"))

        def decode(step, p, scales, feed=None):
            """The serve steps after a prefill; each step timed alone (the
            first one is the step's first call) and the median kept."""
            logits, cache = pre8(params, prompt)
            tok = logits.argmax(-1)
            outs, toks, times = [], [], []
            torch.cuda.synchronize()
            for i in range(steps):
                if feed is not None:
                    tok = feed[i]
                toks.append(tok)
                t0 = time.perf_counter()
                logits, cache = step(p, cache, tok, prompt_len + i, scales)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                outs.append(logits)
                tok = logits.argmax(-1)
            del cache
            return outs, toks, sorted(times)[len(times) // 2]

        torch.cuda.reset_peak_memory_stats()
        outs, toks, dec_s = decode(serve, params, None)
        dec_peak = torch.cuda.max_memory_allocated()
        check(all(bool(torch.isfinite(o).all()) for o in outs),
              f"{arch}: decode logits not finite")
        # the last step against a re-prefill over prompt + fed tokens
        torch.cuda.empty_cache()
        again, _ = make_prefill_step(cfg, InputShape(
            "reprefill", seq_len=prompt_len + steps, global_batch=b_dec,
            kind="prefill"))
        full = torch.cat([prompt, torch.stack(toks, 1)], 1)
        re_logits, re_cache = again(params, full)
        del re_cache
        re_err = rel_err(outs[-1], re_logits)
        check(re_err <= 5e-2, f"{arch}: bf16 decode vs re-prefill {re_err}")
        # int8 weights, fed the bf16 run's tokens
        serve_q, _ = make_serve_step(cfg, InputShape(
            "decode_32k_cut", seq_len=max_len, global_batch=b_dec,
            kind="decode"), quantize_weights=True)
        qp, qs = quantize_params(params)
        n_q = sum(x is not None for x in leaves(qs))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        q_outs, _, q_s = decode(serve_q, qp, qs, feed=toks)
        q_peak = torch.cuda.max_memory_allocated()
        q_err = max(rel_err(a, w) for a, w in zip(q_outs, outs))
        check(q_err <= 5e-2, f"{arch}: int8 serve vs bf16 serve {q_err}")
        emit(dict(phase="serve_bf16", arch=arch, layers=cfg.n_layers,
                  params=n_params, dtype="bfloat16", init_s=init_s,
                  cache_len=max_len, prompt_len=prompt_len,
                  prefill_batch=b_pre, prefill_s=prefill_s,
                  prefill_calls=dict(warmup=1, timed=prefill_calls,
                                     seconds=prefill_times),
                  prefill_tok_per_s=b_pre * prompt_len / prefill_s,
                  prefill_launches=counts,
                  prefill_peak_mem_gib=prefill_peak / 2**30,
                  decode_batch=b_dec, decode_steps=steps,
                  decode_ms_per_step=dec_s * 1e3,
                  decode_tok_per_s=b_dec / dec_s,
                  decode_peak_mem_gib=dec_peak / 2**30,
                  decode_vs_reprefill_rel_err=re_err,
                  int8_leaves=n_q, int8_decode_ms_per_step=q_s * 1e3,
                  int8_decode_tok_per_s=b_dec / q_s,
                  int8_peak_mem_gib=q_peak / 2**30,
                  int8_vs_bf16_rel_err=q_err, tolerance=5e-2, card=card))
        del params, qp, qs, outs, q_outs, re_logits
        torch.cuda.empty_cache()
    return totals


# the bf16 kernels' sources and the case each summary entry quotes: the
# attention's at recurrentgemma's local layer, where SDPA can compute the
# same function (gemma2's soft cap it cannot), so ``library_ms`` is filled
BF16_SOURCE = {"flash_attention": "flash_attention_bf16.cu",
               "flash_attention_bwd": "flash_attention_bwd_bf16.cu",
               "rglru_scan": "rglru_scan.cu"}
BF16_MAIN = {"flash_attention": "recurrentgemma_local",
             "flash_attention_bwd": "recurrentgemma_local",
             "rglru_scan": "recurrentgemma_prefill"}


def kernel_summary(cases, launches):
    """The kernels' JSON summary: one entry per TPU kernel or gradient (six)
    with its f32 kernel's numbers, and under ``bf16`` its bf16 kernel's
    (None where it has none), each with the same keys."""
    summary = []
    csrc = "src/repro_torch/kernels/csrc"
    for name, source, replaces, main_case in (
            ("fed_reduce", "fed_reduce.cu",
             "src/repro/kernels/fed_reduce.py:45", "fedavg"),
            ("fed_aggregate", "fed_aggregate.cu",
             "src/repro/kernels/fed_aggregate.py:23", "fedasync_mix"),
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:32",
             "recurrentgemma_local"),
            ("rglru_scan", "rglru_scan.cu",
             "src/repro/kernels/rglru_scan.py:26", "recurrentgemma_prefill"),
            # the gradients around those kernels: no Pallas kernel has a
            # backward; the reference takes them in jnp
            ("flash_attention_bwd", "flash_attention_bwd.cu",
             "src/repro/models/attention.py:229", "gemma2_global"),
            ("rglru_scan_bwd", "rglru_scan.cu",
             "src/repro/models/recurrent.py:71", "recurrentgemma_train")):
        def entry(kname, src, mine, head, n):
            return dict(
                name=kname, route="cuda", source=f"{csrc}/{src}",
                replaces=replaces, launches=n,
                max_abs_err=max(c["max_abs_err"] for c in mine),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], shape=head["shape"],
                parity={c["case"]: c["check"] for c in mine})

        mine = [c for c in cases if c.get("kernel") == name
                and c.get("dtype") != "bfloat16"]
        head = next(c for c in mine if c["case"] == main_case)
        b16 = [c for c in cases if c.get("kernel") == name
               and c.get("dtype") == "bfloat16"]
        b16_head = next((c for c in b16 if c["case"] == BF16_MAIN.get(name)),
                        None)
        launches_bf16 = launches.get(name + "_bf16", 0)
        summary.append(dict(
            entry(name, source, mine, head, launches[name]),
            launches_bf16=launches_bf16,
            bf16=None if b16_head is None else entry(
                name + "_bf16", BF16_SOURCE[name], b16, b16_head,
                launches_bf16),
            **{k: head[k] for k in ("bound_route", "bound_f32_simt_ms",
                                    "bound_tf32x3_ms", "launch_floor_ms")
               if k in head}))
    return summary


# ---------------------------------------------------------------------------
# phase 15: the LM steps on ("data", "model") device meshes
# ---------------------------------------------------------------------------

MESH_ROUNDS = 2
MESH_DECODE = 8          # phase 15a's serve steps on each side
ATTN16_FWD, ATTN16_BWD = "flash_attention_bf16_kernel", "attn16_bwd"


def device_kernel_counts(torch, fn, names):
    """How many device kernels whose name holds each of ``names`` one call
    of ``fn`` runs (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    got = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return {n: sum(n in g for g in got) for n in names}


def mesh_leaf_err(torch, got, want):
    """(bitwise, max |got - want| over max |want|) of two same-shaped
    leaves, ``want`` on the host."""
    g = got.detach().float()
    w = want.to(got.device).float()
    if torch.equal(got.detach(), want.to(got.device)):
        return True, 0.0
    den = float(w.abs().max())
    return False, float((g - w).abs().max()) / max(den, 1e-30)


def mesh_phase_1rank(torch, card, beside):
    """Phase 15a: a 1-rank NCCL group and a (1, 1) ``("data", "model")``
    mesh in this process.  Phase 14a's bf16 gemma2-2b production step at
    full width and depth (B=2 x S=4,096, f32 momentum, the same init and
    batches) for MESH_ROUNDS rounds on one device, then through
    ``make_fl_train_step(mesh=...)`` (DTensor params and momentum, the
    kernels under ``local_map``): losses and params bitwise, else within
    14b's limits; step seconds and peak beside 14a's (``beside``); the
    bf16 attention launches by the wrappers' counts and, for one more step,
    by ``torch.profiler``.  Then phase 14c's bf16 prefill (B=2, a 4,096
    prompt into 32,768 positions) and MESH_DECODE serve steps on one
    device and through the mesh (the mesh fed the one-device tokens):
    logits bitwise, else within 5e-2; the median serve step's seconds and
    the decode's peak on each side.  Returns the counts of the mesh
    steps' and prefills' launches."""
    import os
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels import flash_attention as fl_mod
    from repro_torch.kernels import rglru_scan as sc_mod
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.distributed_fl import round_batch
    from repro_torch.launch.steps import (make_fl_train_step,
                                          make_prefill_step, make_serve_step)
    from repro_torch.models import stacked
    from repro_torch.sharding.ctx import is_dtensor
    from repro_torch.tree import leaves, tree_map

    bf = torch.bfloat16
    arch, b, s_len = "gemma2-2b", 2, 4096
    cfg = get_config(arch)
    n_attn = sum(sp.mixer == "attn" for sp in cfg.layers)
    shape = InputShape("train_4k_cut", seq_len=s_len, global_batch=b,
                       kind="train")
    bgen = torch.Generator(device="cuda").manual_seed(7)
    batches = [round_batch(cfg, b, s_len, bgen, "cuda")
               for _ in range(MESH_ROUNDS)]
    tmp = tempfile.mkdtemp()
    group = mesh_mod.join(0, 1, device="cuda",
                          init_method="file://" + os.path.join(tmp, "nccl"))
    check(group.backend == "nccl", f"15a: 1-rank group on {group.backend}")
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), "cuda")
    totals = {}
    try:
        runs = {}
        for where in ("one_device", "mesh"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = stacked.init_params_stacked(cfg, gen, bf)
            momentum = tree_map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=x.device), params)
            step, _ = make_fl_train_step(
                cfg, shape, dtype=bf,
                mesh=mesh if where == "mesh" else None)
            secs, losses = [], []
            train_counts(fl_mod, sc_mod, reset=True)
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, momentum, loss, _ = step(params, momentum, batch)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(loss))
            counts = {k: v for k, v in train_counts(fl_mod, sc_mod).items()
                      if v}
            peak = torch.cuda.max_memory_allocated()
            local = [x.to_local() if is_dtensor(x) else x
                     for x in leaves(params)]
            rec = dict(step_s=secs, loss=losses, peak_mem_gib=peak / 2**30,
                       launches=counts)
            if where == "mesh":
                check(all(is_dtensor(x) for x in leaves(params)),
                      "15a: the mesh step's params are not DTensors")
                want = runs["one_device"]
                errs = [mesh_leaf_err(torch, g, w)
                        for g, w in zip(local, want["params"])]
                rec["params_bitwise"] = all(e[0] for e in errs)
                rec["params_max_rel_err"] = max(e[1] for e in errs)
                rec["loss_bitwise"] = losses == want["loss"]
                rec["profiled"] = device_kernel_counts(
                    torch, lambda: step(params, momentum, batches[0]),
                    (ATTN16_FWD, ATTN16_BWD))
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
            else:
                rec["params"] = [x.detach().to("cpu") for x in local]
            runs[where] = rec
            del params, momentum, step, local
        one, msh = runs["one_device"], runs["mesh"]
        want = {"flash_attention_bf16": 2 * n_attn * MESH_ROUNDS,
                "flash_attention_bwd_bf16": n_attn * MESH_ROUNDS}
        check(msh["launches"] == want and one["launches"] == want,
              f"15a: launches {msh['launches']} / {one['launches']}, "
              f"wanted {want}")
        check(msh["profiled"][ATTN16_FWD] > 0 and
              msh["profiled"][ATTN16_BWD] > 0,
              f"15a: profiled attention kernels {msh['profiled']}")
        # 14b's limits where the bits differ
        check(msh["loss_bitwise"] or all(
            abs(a - c) <= 1e-2 * abs(c) for a, c in zip(msh["loss"],
                                                        one["loss"])),
              f"15a: mesh losses {msh['loss']} vs {one['loss']}")
        check(msh["params_bitwise"] or msh["params_max_rel_err"] <= 3e-2,
              f"15a: mesh params off by {msh['params_max_rel_err']}")
        ref14a = (beside or {}).get(arch, {})
        emit(dict(phase="mesh_1rank_train", arch=arch, mesh="1x1 nccl",
                  dtype="bfloat16", batch=b, seq_len=s_len,
                  rounds=MESH_ROUNDS, loss=msh["loss"],
                  loss_one_device=one["loss"],
                  loss_bitwise=msh["loss_bitwise"],
                  params_bitwise=msh["params_bitwise"],
                  params_max_rel_err=msh["params_max_rel_err"],
                  step_s=msh["step_s"], step_s_one_device=one["step_s"],
                  mesh_over_one_device=min(msh["step_s"]) /
                  min(one["step_s"]),
                  peak_mem_gib=msh["peak_mem_gib"],
                  peak_mem_gib_one_device=one["peak_mem_gib"],
                  phase14a_step_s=ref14a.get("step_s"),
                  phase14a_peak_mem_gib=ref14a.get("peak_mem_gib"),
                  launches=msh["launches"],
                  profiled_device_kernels=msh["profiled"], card=card))
        del runs, one

        # 14c's prefill, then MESH_DECODE serve steps, through the mesh
        max_len, prompt_len = 32768, 4096
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(3)
        params = stacked.init_params_stacked(cfg, gen, bf)
        tgen = torch.Generator(device="cuda").manual_seed(4)
        prompt = torch.randint(0, cfg.vocab_size, (b, prompt_len),
                               generator=tgen, device="cuda")
        pshape = InputShape("prefill_32k_cut", seq_len=max_len,
                            global_batch=b, kind="prefill")
        dshape = InputShape("decode_32k_cut", seq_len=max_len,
                            global_batch=b, kind="decode")
        out, feed = {}, None
        for where, m in (("one_device", None), ("mesh", mesh)):
            pre, _ = make_prefill_step(cfg, pshape, mesh=m)
            serve, _ = make_serve_step(cfg, dshape, mesh=m)
            pre(params, prompt)                       # warm-up
            torch.cuda.synchronize()
            train_counts(fl_mod, sc_mod, reset=True)
            t0 = time.perf_counter()
            logits, cache = pre(params, prompt)
            torch.cuda.synchronize()
            rec = dict(logits=logits.float(), prefill_s=time.perf_counter()
                       - t0, launches={k: v for k, v in train_counts(
                           fl_mod, sc_mod).items() if v})
            # the serve steps, the mesh run fed the one-device run's tokens
            torch.cuda.reset_peak_memory_stats()
            tok, toks, dec, times = logits.argmax(-1), [], [], []
            for i in range(MESH_DECODE):
                if feed is not None:
                    tok = feed[i]
                toks.append(tok)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = serve(params, cache, tok, prompt_len + i)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                dec.append(lg.float())
                tok = lg.argmax(-1)
            feed = toks
            rec.update(decode=torch.stack(dec),
                       decode_s=sorted(times)[len(times) // 2],
                       decode_peak_gib=torch.cuda.max_memory_allocated()
                       / 2**30)
            out[where] = rec
            del cache, logits, lg
            torch.cuda.empty_cache()
        one, msh = out["one_device"], out["mesh"]
        check(bool(torch.isfinite(msh["logits"]).all()) and
              bool(torch.isfinite(msh["decode"]).all()),
              "15a: prefill or decode logits not finite")
        errs = {}
        for k in ("logits", "decode"):
            errs[k] = (torch.equal(msh[k], one[k]),
                       float((msh[k] - one[k]).abs().max()
                             / one[k].abs().max()))
            check(errs[k][0] or errs[k][1] <= 5e-2,
                  f"15a: mesh {k} off by {errs[k][1]}")
        cm = msh["launches"]
        check(cm == {"flash_attention_bf16": n_attn},
              f"15a: mesh prefill launches {cm}")
        for k, v in cm.items():
            totals[k] = totals.get(k, 0) + v
        emit(dict(phase="mesh_1rank_prefill", arch=arch, mesh="1x1 nccl",
                  dtype="bfloat16", batch=b, prompt_len=prompt_len,
                  cache_len=max_len, logits_bitwise=errs["logits"][0],
                  logits_max_rel_err=errs["logits"][1],
                  prefill_s=msh["prefill_s"],
                  prefill_s_one_device=one["prefill_s"], launches=cm,
                  card=card))
        emit(dict(phase="mesh_1rank_decode", arch=arch, mesh="1x1 nccl",
                  dtype="bfloat16", batch=b, cache_len=max_len,
                  steps=MESH_DECODE, logits_bitwise=errs["decode"][0],
                  logits_max_rel_err=errs["decode"][1],
                  step_s=msh["decode_s"], step_s_one_device=one["decode_s"],
                  mesh_over_one_device=msh["decode_s"] / one["decode_s"],
                  peak_mem_gib=msh["decode_peak_gib"],
                  peak_mem_gib_one_device=one["decode_peak_gib"],
                  card=card))
        del params, prompt, out, one, msh
    finally:
        mesh_mod.leave()
        torch.cuda.empty_cache()
    return totals


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another checkout's kernels/csrc: time its "
                         "fed_reduce, fed_aggregate, flash_attention_bwd "
                         "and bf16 attention kernels beside this one's")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; card: {card}", flush=True)

    # phase 1: build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    build_s = time.perf_counter() - t0
    log = lib_path.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    emit(dict(phase="build", seconds=build_s, library=str(lib_path.name),
              ptxas=ptxas))

    old_lib = None
    if args.baseline is not None:
        # a checkout from before the training kernels has no backward,
        # one from before bf16 no bf16 kernels
        old_lib = build.library(
            args.baseline.resolve(), ROOT / "build" / "kernels_baseline",
            tuple(f for f in ("fed_reduce.cu", "fed_aggregate.cu",
                              "flash_attention_bwd.cu",
                              "flash_attention_bf16.cu",
                              "flash_attention_bwd_bf16.cu")
                  if (args.baseline / f).exists()))
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    cases, floor = kernel_cases(torch, np, card, flush, old_lib)
    cases += lm_kernel_cases(torch, np, card, flush)
    ptxas_fns = ptxas_table(log.read_text()) if log.exists() else {}
    cases += train_kernel_cases(torch, np, card, flush, ptxas_fns, old_lib)
    cases += bf16_kernel_cases(torch, np, card, flush, ptxas_fns, old_lib)
    del flush

    from repro_torch.models import build_model
    from repro_torch.configs.paper_models import MLP_EMNIST
    init_params = build_model(MLP_EMNIST).init(0, "cpu")
    runs, launches, walls = main_path(torch, card, init_params)
    card_vs_cpu(runs["sync"], init_params)

    torch.cuda.empty_cache()
    lm_launches = serve_full_width(torch, np, card)
    launches.update(lm_launches)
    serve_card_vs_cpu(torch, np)
    torch.cuda.empty_cache()
    launches["flash_attention"] += serve_zoo(torch, card)
    zoo_card_vs_cpu(torch, np)
    torch.cuda.empty_cache()

    res, ev_res, sweep_wall, sweep_launches, reduce_inputs = \
        sweep_full_width(torch, card)
    for k, v in sweep_launches.items():
        launches[k] += v
    alone_by_key = sweep_vs_standalone(torch, card, res, ev_res, sweep_wall)
    eval_routes(torch, card, res, alone_by_key)
    sweep_card_vs_cpu(torch)
    sweep_records = {r.spec.key(): (list(zip(r.history_m, r.history_e)),
                                    r.history_acc, list(r.cost))
                     for r in res}
    del res, ev_res
    cases += sweep_reduce_cases(torch, card, floor, reduce_inputs)

    serve_launches, _ = serve_phase(torch, card)
    for k, v in serve_launches.items():
        launches[k] += v

    torch.cuda.empty_cache()
    train_totals, train_recs = train_full_width(torch, card)
    for k, v in train_totals.items():
        launches[k] = launches.get(k, 0) + v
    train_card_vs_cpu(torch, np)

    # phase 14: the bf16 production steps
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    bf16_totals, bf16_recs = train_full_width(torch, card, torch.bfloat16,
                                              beside=train_recs)
    bf16_train_card_vs_cpu(torch, np)
    for k, v in bf16_serve(torch, np, card).items():
        bf16_totals[k] = bf16_totals.get(k, 0) + v
    for k, v in bf16_totals.items():
        launches[k] = launches.get(k, 0) + v
    emit(dict(phase="bf16_steps", seconds=time.perf_counter() - t14))

    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    resnet_models(torch, np, card)
    speech_runs, speech_launches, speech_init = speech_trials(torch, card)
    for k, v in speech_launches.items():
        launches[k] += v
    speech_card_vs_cpu(speech_runs, speech_init)
    cases += resnet_kernel_cases(torch, np, card, floor)
    emit(dict(phase="resnet_phase", seconds=time.perf_counter() - t12))

    torch.cuda.empty_cache()
    launches["fed_reduce"] += sharded_phase(
        torch, np, card, init_params, runs["sync"], walls["sync"],
        speech_init, sweep_records)
    cases.append(sharded_reduce_case(torch, np, card, floor))

    # phase 15: the LM steps on ("data", "model") meshes
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    for k, v in mesh_phase_1rank(torch, card, bf16_recs).items():
        launches[k] = launches.get(k, 0) + v
    emit(dict(phase="mesh_steps", seconds=time.perf_counter() - t15))

    for k in ("flash_attention_bf16", "flash_attention_bwd_bf16"):
        check(launches.get(k, 0) > 0, f"{k}: no launch on the bf16 path")
    summary = kernel_summary(cases, launches)
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
