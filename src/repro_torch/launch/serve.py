"""Serving launcher: prefill + batched greedy decode of an LM config.

Port of ``repro.launch.serve``, for any of the ten LM configs.  By
default it runs the FULL config on the card with random params drawn there
from ``--seed``; ``--reduced`` takes the reference CLI's ``reduced(cfg,
n_layers=4)`` for a CPU run, and ``--layers`` cuts depth only.  A config
with a frontend gets its (stub) input drawn from ``--seed`` on the device,
as the reference draws it: audio frames (B, 1024, 1024) for
seamless-m4t's encoder, vision patches (B, 256, 896) before internvl2's
prompt.  An xLSTM prompt is at most 128 tokens or a multiple of 128 (the
mLSTM's chunk).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \\
      --reduced --device cpu --prompt-len 128 --tokens 8
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import torch


def cut_layers(cfg, n_layers: int):
    """``cfg`` with only its first ``n_layers`` layers (widths unchanged)."""
    return dataclasses.replace(cfg, n_layers=n_layers,
                               layers=cfg.layers[:n_layers])


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def frontend_input(cfg, batch: int, gen: torch.Generator, device
                   ) -> Optional[torch.Tensor]:
    """The config's stub frontend input drawn from ``gen``: (B, frames or
    patches, features) standard normal, or None without a frontend."""
    if cfg.frontend is None:
        return None
    f = cfg.frontend
    return torch.randn((batch, f.seq_len, f.feature_dim), generator=gen,
                       device=device)


def prefix_len(cfg, frontend: Optional[torch.Tensor]) -> int:
    """Positions a vision-patch prefix takes before the prompt."""
    if cfg.frontend is None or cfg.frontend.kind != "vision_patches":
        return 0
    return frontend.shape[1]


def generate(model, params, prompt: torch.Tensor, tokens: int, *,
             frontend: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Prefill ``prompt`` (B, S), after or beside ``frontend``, and decode
    ``tokens`` greedy tokens.  Returns the prefill logits (B, V), every
    decoded step's logits (tokens, B, V), the generated ids (B, tokens + 1,
    the first from the prefill), the vision prefix's length and the
    host-clock seconds of both phases (each ending in a device sync).
    The cache holds prefix + S + tokens + 1 positions and decode step i
    runs at position prefix + S + i, as the reference's launcher; prefill
    tokens/s counts the prompt's B x S tokens."""
    dev = prompt.device
    b, s = prompt.shape
    p_len = prefix_len(model.config, frontend)
    cache = model.init_cache(b, max_len=p_len + s + tokens + 1, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompt, cache, frontend=frontend)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    first = logits
    tok = torch.argmax(logits, dim=-1)
    ids, steps = [tok], []
    t0 = time.perf_counter()
    for i in range(tokens):
        logits, cache = model.decode_step(params, tok, p_len + s + i, cache)
        tok = torch.argmax(logits, dim=-1)
        ids.append(tok)
        steps.append(logits)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {
        "prefill_logits": first,
        "step_logits": (torch.stack(steps) if steps else
                        first.new_empty((0,) + tuple(first.shape))),
        "ids": torch.stack(ids, dim=1),
        "prefix_len": p_len,
        "prefill_s": prefill_s,
        "prefill_tok_per_s": b * s / prefill_s,
        "decode_s": decode_s,
        "decode_tok_per_s": (b * tokens / decode_s) if tokens else 0.0,
    }


def main(argv=None):
    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--layers", type=int, default=None,
                    help="keep only the first N layers (depth cut)")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference CLI's reduced(cfg, n_layers=4)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, n_layers=4)
    if args.layers is not None:
        cfg = cut_layers(cfg, args.layers)
    if dev.type == "cuda":          # set-up: nvcc runs here, not in prefill
        from repro_torch.kernels import build
        build.library()
    model = build_model(cfg)
    params = model.init(args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    fe = frontend_input(cfg, args.batch, gen, dev)
    out = generate(model, params, prompt, args.tokens, frontend=fe)
    b, s = prompt.shape
    print(f"{cfg.name}: {cfg.n_layers} layers, "
          f"{sum(p.numel() for p in leaves(params)):,} params, device {dev}")
    beside = "" if fe is None else (
        f", with {fe.shape[1]} {cfg.frontend.kind.replace('_', ' ')} "
        f"x {fe.shape[2]}")
    print(f"prefill: {b}x{s} in {out['prefill_s']:.3f}s "
          f"({out['prefill_tok_per_s']:.1f} tok/s){beside}")
    print(f"decoded {args.tokens} tokens x batch {b} in "
          f"{out['decode_s']:.3f}s ({out['decode_tok_per_s']:.1f} tok/s)")
    print("sampled ids[0]:", out["ids"][0].tolist())
    if dev.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
