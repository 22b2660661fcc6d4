"""Prefill: a closed loop of back-to-back ``prefill_step`` calls, each of B
prompts of S tokens into an S-slot cache, token ids Zipf-distributed over
the vocabulary; each call's answer (the greedy next token of every prompt)
reaches the host before the next call starts.

Each call keeps what it produced for the check: the last position's
logits, its greedy tokens, and the keys and values that it wrote at a set
of cache positions drawn from the seed (the first and the last among
them), in every layer.  Once the window has closed, prompts drawn from the
seed among those the window served are run through the reference: the gap
by which each served token's logit lies below the reference's best, the
logits' error and the cached keys' and values' error, at the worst layer.
"""

from __future__ import annotations

import gc

import torch

from benchlib import inputs as I
from benchlib.counts import step_counts
from reference.model import Ref

BF16 = torch.bfloat16


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in f32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


class Entry:
    def __init__(self, run):
        from repro_torch.configs.shapes import InputShape
        from repro_torch.launch.steps import make_prefill_step
        t = run.traffic
        self.run, self.t, dev = run, t, run.device
        b, s = t["batch"], t["prompt_len"]
        self.step_fn, (p_struct, _) = make_prefill_step(
            run.pcfg, InputShape("bench", seq_len=s, global_batch=b,
                                 kind="prefill"), dtype=BF16)
        self.p_struct = p_struct
        self.params = I.make_params(p_struct, run.cfg, run.seed, dev, BF16)
        self.probs = I.zipf_probs(run.cfg["vocab_size"], t["zipf_exponent"],
                                  dev)
        self.gen = I.generator(run.seed, "prompts", dev)
        g = I.generator(run.seed, "cache-positions", dev)
        n = min(t["cache_positions"], s)
        pos = torch.randperm(s - 2, generator=g, device=dev)[:max(n - 2, 0)]
        self.kv_pos = torch.cat([pos + 1, torch.tensor([0, s - 1],
                                                       device=dev)]).sort()[0]
        self.calls = []
        self.record = False

    def _call(self):
        b, s = self.t["batch"], self.t["prompt_len"]
        tokens = I.zipf_tokens(self.probs, (b, s), self.gen)
        logits, cache = self.step_fn(self.params, tokens)
        served = logits.argmax(-1)
        if self.run.fault == "token":       # an answer altered
            served = (served + 1) % logits.shape[-1]
        if self.record:
            kv = cache["stacked"][0]
            self.calls.append((tokens, logits, served,
                               kv.k[:, :, self.kv_pos].clone(),
                               kv.v[:, :, self.kv_pos].clone()))
        del cache
        served.cpu()            # the prompt's answer reaches the host

    def warmup(self):
        for _ in range(self.t["warmup_calls"]):
            self._call()
        self.record = True

    def step(self):
        self._call()

    def end_to_end(self, wall_s: float, steps: int):
        return {"prefill_tokens_per_s":
                steps * self.t["batch"] * self.t["prompt_len"] / wall_s}

    def counts(self):
        return step_counts(self.run.cfg, "prefill", self.t)

    def release(self):
        del self.params, self.step_fn
        gc.collect()
        if torch.device(self.run.device).type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self):
        """(call, row) pairs drawn from the seed among the window's."""
        b = self.t["batch"]
        n = len(self.calls) * b
        g = torch.Generator().manual_seed(I.sub_seed(self.run.seed, "check"))
        pick = torch.randperm(n, generator=g)[:self.t["check_prompts"]]
        return [(int(i) // b, int(i) % b) for i in pick]

    def check(self, control: bool = False):
        run = self.run
        w = I.ref_weights(self.p_struct, run.cfg, run.seed, run.device, BF16)
        refs = [Ref(run.cfg)] + ([Ref(run.cfg, "fp8")] if control else [])
        mine = {"token_gap": 0.0, "logit_err": 0.0, "cache_err": 0.0}
        ctl = dict(mine)
        for c, r in self._sample():
            tokens, logits, served, ks, vs = self.calls[c]
            got = []
            for ref in refs:
                kv = []
                last = ref.forward(w, tokens[r], 1, lambda l, k, v: kv.append(
                    (k[self.kv_pos], v[self.kv_pos])))[0]
                got.append((last, kv))
            (best, kv_ref) = got[0]
            top = float(best.max())
            outs = [(mine, logits[r], int(served[r]),
                     [(ks[l, r], vs[l, r]) for l in range(len(kv_ref))])]
            if control:
                lo, kv_lo = got[1]
                outs.append((ctl, lo, int(lo.argmax()), kv_lo))
            for acc, lg, tok, kv in outs:
                acc["token_gap"] = max(acc["token_gap"],
                                       top - float(best[tok]))
                acc["logit_err"] = max(acc["logit_err"], rel_err(lg, best))
                acc["cache_err"] = max(acc["cache_err"], max(
                    max(rel_err(a, x), rel_err(b_, y))
                    for (a, b_), (x, y) in zip(kv, kv_ref)))
        return (mine, ctl) if control else mine
