"""Where a serving request's time goes on the card: an LM config's prefill
and decode steps under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        [--arch recurrentgemma-9b] [--batch 2] [--prompt-len 4096] \\
        [--tokens 8] [--layers N]    # any of the ten LM configs

Full width by default, f32 params drawn on the card from a seed (as
``launch/serve.py``).  One ``generate`` runs first, unprofiled: it warms
up and gives the unprofiled times.  Then one prefill and ``--tokens``
decode steps run under the profiler, each phase in its own window.  Prints
one JSON line per phase: its wall time, the device's busy time and idle
share, its device activities, and the device time split into matrix
products (cuBLAS kernels), the port's two LM kernels, copies and the rest
(elementwise and reductions), with the top kernels by device time and
operators by host time.  Two named ranges are read beside the classes
(parts of them, not classes of their own): the MoE's expert products
(``ffn.EXPERT_RANGE``, cuBLAS products of the dense or dispatched experts)
and the sLSTM step loop (``xlstm.SLSTM_RANGE``), each with its host
milliseconds and the device time of its kernels, so the loop's host share
shows.  Any of the ten LM configs: a config with a frontend gets its stub
input drawn from the seed, as ``launch/serve.py``; an xLSTM prompt is at
most 128 tokens or a multiple of 128.  Needs a GPU; raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.launch.profile_trial import card_name, device_activity


def kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_attention_kernel" in n:
        return "flash_attention"
    if "rglru_scan_kernel" in n:
        return "rglru_scan"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "dot_kernel")):
        return "matmul"
    return "elementwise_and_other"


def named_ranges(torch, prof) -> dict:
    """Host ms and the device ms of the kernels launched inside each of
    the models' named ``record_function`` ranges, summed over the window."""
    from repro_torch.models.ffn import EXPERT_RANGE
    from repro_torch.models.xlstm import SLSTM_RANGE

    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for e in prof.key_averages():
        if e.key in (EXPERT_RANGE, SLSTM_RANGE) and e.device_type != cuda:
            out[e.key] = dict(count=e.count, host_ms=e.cpu_time_total / 1e3,
                              device_ms=e.device_time_total / 1e3)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import (cut_layers, frontend_input,
                                          generate, prefix_len)
    from repro_torch.models import build_model

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = cut_layers(cfg, args.layers)
    model = build_model(cfg)
    params = model.init(args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    b, s = args.batch, args.prompt_len
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    fe = frontend_input(cfg, b, gen, dev)
    p_len = prefix_len(cfg, fe)
    warm = generate(model, params, prompt, args.tokens, frontend=fe)

    def phase(name, fn, n_tokens, unprofiled_s):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        act = device_activity(torch, prof)
        split = {}
        for kname, n, ms in act["by_name"]:
            k = kernel_class(kname)
            cnt, tot = split.get(k, (0, 0.0))
            split[k] = (cnt + n, tot + ms)
        print(json.dumps(dict(
            phase=name, arch=cfg.name, layers=cfg.n_layers, batch=b,
            prompt_len=s, prefix_len=p_len,
            frontend=None if fe is None else list(fe.shape),
            tokens=n_tokens, unprofiled_wall_s=unprofiled_s,
            wall_s=wall_s, device_busy_s=act["busy_s"],
            device_idle_share=1.0 - act["busy_s"] / wall_s,
            activities=act["activities"],
            device_ms_by_class={k: {"count": c, "ms": ms}
                                for k, (c, ms) in sorted(split.items())},
            named_ranges=named_ranges(torch, prof),
            top_device=act["top_device"], top_host=act["top_host"],
            card=card_name())), flush=True)
        return out

    cache = model.init_cache(b, max_len=p_len + s + args.tokens + 1,
                             device=dev)
    logits, cache = phase(
        "prefill", lambda: model.prefill(params, prompt, cache, frontend=fe),
        b * s, warm["prefill_s"])
    tok = torch.argmax(logits, dim=-1)

    def decode():
        nonlocal tok, cache
        for i in range(args.tokens):
            lg, cache = model.decode_step(params, tok, p_len + s + i, cache)
            tok = torch.argmax(lg, dim=-1)

    phase("decode", decode, b * args.tokens, warm["decode_s"])


if __name__ == "__main__":
    main()
