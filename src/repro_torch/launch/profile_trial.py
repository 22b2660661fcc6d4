"""Where a trial's time goes on the card: one sync FedTune trial under
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_trial \
        [--model mlp_emnist|resnet10] [--rounds 3]

Configuration (``smoke_server``, which ``chip_smoke.py`` also drives):
FedAvg, E=2, FedTune preference (0.25, 0.25, 0.25, 0.25) started from
(M, 2), over the model's full federation.  ``mlp_emnist`` (the default):
``MLP_EMNIST`` over ``emnist_like``, SGD lr 0.03 momentum 0.9, batch 10,
M=20.  ``resnet10``: Table 2's ResNet-10 over ``speech_command_like``
(2,112 clients, 32x32x1, 35 classes) with ``examples/fedtune_speech.py``'s
settings: SGD lr 0.05 momentum 0.9, batch 5, M=5.  One round runs first,
unprofiled, to warm up.  Prints one JSON line: the same run's wall time
unprofiled and profiled, the device's busy time (the union of its kernels,
copies and memsets) and idle share in the profiled window, device
activities per local step, the device time by class (convolutions,
matrix products, ``fed_reduce``, copies, and GroupNorm, elementwise and
the rest), the top kernels by device time and operators by host time, and
the server step's device time per round: the ``fed_reduce`` kernel and the
packing around it.  Needs a GPU; raises without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Optional

from repro_torch.configs.paper_models import MLP_EMNIST, RESNET10, MLPConfig
from repro_torch.federated.server import FLServer

N_PARAMS = 169_462
MODELS = {"mlp_emnist": MLP_EMNIST, "resnet10": RESNET10}


class CountingServer(FLServer):
    """FLServer that also counts the local optimizer steps it ran."""
    local_steps = 0

    def _client_update(self, params, cid, e):
        upd, n = super()._client_update(params, cid, e)
        self.local_steps += upd.n_steps
        return upd, n


class _CountingAggregator:
    """The aggregator, adding the local steps of the updates it combines to
    ``server.local_steps``: a batched sync round's updates come from one
    packed cohort, not through ``_client_update``."""

    def __init__(self, inner, server):
        self.inner, self.server = inner, server

    def __call__(self, params, updates):
        self.server.local_steps += sum(u.n_steps for u in updates)
        return self.inner(params, updates)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def smoke_server(mode: str = "sync", *, model_cfg=MLP_EMNIST,
                 m: Optional[int] = None, max_rounds: int, device, buffer_k: int = 8,
                 fleet_name=None, compression=None,
                 client_exec: str = "sequential") -> CountingServer:
    """The smoke configuration (also ``chip_smoke.py``'s) of ``model_cfg``
    (``MLP_EMNIST`` or a ResNet in the speech shape; see the module
    docstring), in ``mode`` over ``fleet_name`` (None is the homogeneous
    fleet), with ``compression`` of the uploads and ``client_exec`` for
    sync rounds.  ``m`` defaults to 20 for the MLP, 5 for a ResNet."""
    from repro_torch.core import CostModel, FedTune, FedTuneConfig, Preference
    from repro_torch.core.tuner import HyperParams
    from repro_torch.data import emnist_like, speech_command_like
    from repro_torch.federated import FLConfig, get_aggregator
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.runtime import RuntimeConfig, sample_fleet
    from repro_torch.tree import leaves

    model = build_model(model_cfg)
    if isinstance(model_cfg, MLPConfig):
        dataset = emnist_like(seed=0)
        m, lr, batch = m or 20, 0.03, 10
        cost = CostModel(flops_per_example=2 * N_PARAMS, param_count=N_PARAMS)
    else:
        dataset = speech_command_like(seed=0)
        m, lr, batch = m or 5, 0.05, 5
        n = sum(t.numel() for t in leaves(model.init(0, "cpu")))
        cost = CostModel(flops_per_example=model.flops_per_example,
                         param_count=n)
    e = 2.0
    fleet = (None if fleet_name is None
             else sample_fleet(fleet_name, dataset.n_clients, seed=0))
    srv = CountingServer(
        model, dataset, get_aggregator("fedavg"),
        get_optimizer("sgd", lr, momentum=0.9), cost,
        FLConfig(m=m, e=e, batch_size=batch, target_accuracy=0.99,
                 max_rounds=max_rounds, eval_points=1024,
                 compression=compression),
        tuner=FedTune(FedTuneConfig(
            preference=Preference(0.25, 0.25, 0.25, 0.25)),
            HyperParams(m, e)),
        fleet=fleet, runtime_config=RuntimeConfig(
            mode=mode, buffer_k=buffer_k, client_exec=client_exec),
        device=device)
    if client_exec == "batched":
        srv.aggregator = _CountingAggregator(srv.aggregator, srv)
    return srv


def kernel_class(name: str) -> str:
    """A device activity by class, for every profile of the port: its
    hand-written kernels (``fed_reduce``, the flash attention forward and
    backward, f32 and bf16, the RG-LRU scan and its backward), copies,
    cuDNN's convolutions (forward, data and weight gradients), matrix
    products (cuBLAS and cuBLASLt's ``nvjet`` kernels), and the rest
    (elementwise passes, reductions, norms, the optimizer, the loss)."""
    n = name.lower()
    if "fed_reduce_kernel" in n:
        return "fed_reduce"
    if "attn_bwd_" in n or "attn16_bwd_" in n:
        return "flash_attention_bwd"
    if "flash_attention_kernel" in n or "flash_attention_bf16_kernel" in n:
        return "flash_attention"
    if "rglru_scan_bwd_kernel" in n:
        return "rglru_scan_bwd"
    if "rglru_scan_kernel" in n or "rglru_scan_bf16_kernel" in n:
        return "rglru_scan"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                            "implicit", "winograd")):
        return "convolution"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "dot_kernel",
                            "nvjet")):
        return "matmul"
    return "elementwise_and_other"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(MODELS), default="mlp_emnist")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import resolve_device

    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MODELS[args.model]
    smoke_server(model_cfg=cfg, max_rounds=1, device=device).run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()                         # the same run, unprofiled
    smoke_server(model_cfg=cfg, max_rounds=args.rounds, device=device).run()
    torch.cuda.synchronize()
    plain_wall_s = time.perf_counter() - t0

    srv = smoke_server(model_cfg=cfg, max_rounds=args.rounds, device=device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = srv.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    act = device_activity(torch, prof)
    print(json.dumps(dict(
        model=args.model, rounds=res.rounds, local_steps=srv.local_steps,
        m_e=[(h.m, h.e) for h in res.history],
        unprofiled_wall_s=plain_wall_s, wall_s=wall_s,
        device_busy_s=act["busy_s"],
        device_idle_share=1.0 - act["busy_s"] / wall_s,
        kernel_launches=act["activities"],
        launches_per_step=act["activities"] / max(srv.local_steps, 1),
        device_ms_by_class=by_class(act["by_name"], kernel_class),
        top_device=act["top_device"], top_host=act["top_host"],
        aggregation=aggregation_split(act["by_name"], res.rounds),
        card=card_name())), flush=True)


def by_class(by_name, classify) -> dict:
    """``device_activity``'s (name, count, ms) summed by ``classify(name)``:
    {class: {"count", "ms"}}."""
    split = {}
    for name, n, ms in by_name:
        k = classify(name)
        cnt, tot = split.get(k, (0, 0.0))
        split[k] = (cnt + n, tot + ms)
    return {k: {"count": c, "ms": ms} for k, (c, ms) in sorted(split.items())}


def aggregation_split(by_name, rounds: int) -> dict:
    """Device time per round of the server step: ``fed_reduce``'s kernel,
    and the packing around it in ``aggregation._weighted_combine`` (each
    client's flatten ``torch.cat`` and the ``torch.stack`` of the rows,
    both PyTorch's cat kernels, which nothing else of a sync trial
    launches).  ``by_name`` is ``device_activity``'s."""
    def pick(key):
        hits = [(n, ms) for name, n, ms in by_name if key in name]
        return (sum(n for n, _ in hits) / rounds,
                sum(ms for _, ms in hits) / rounds)
    pack_n, pack_ms = pick("CatArrayBatchedCopy")
    red_n, red_ms = pick("fed_reduce_kernel")
    return dict(pack_launches_per_round=pack_n, pack_ms_per_round=pack_ms,
                fed_reduce_launches_per_round=red_n,
                fed_reduce_ms_per_round=red_ms)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def device_activity(torch, prof, top: int = 10) -> dict:
    """Summarise a ``torch.profiler`` window: the device's busy time (the
    union of its kernels, copies and memsets), their count, each one's
    (name, count, ms) summed by name, and the top operators by host time.
    The profiler also puts each operator's name on the device timeline as
    an annotation spanning its kernels; those are left out so no time
    counts twice."""
    cuda = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof.events() if e.device_type == cuda
                  and not getattr(e, "is_user_annotation", False)
                  and "annotation" not in str(getattr(e, "activity_type", ""))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    by_dev = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    by_cpu = sorted((e for e in prof.key_averages() if e.device_type != cuda),
                    key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    return dict(
        busy_s=busy_us / 1e6, activities=len(dev_events),
        by_name=[(name, n, us / 1e3) for name, (n, us) in by_dev],
        top_device=[(name[:80], n, us / 1e3)
                    for name, (n, us) in by_dev[:top]],
        top_host=[(e.key, e.count, e.self_cpu_time_total / 1e3)
                  for e in by_cpu])


if __name__ == "__main__":
    main()
