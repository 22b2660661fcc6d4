"""Decode: B sequences decode greedily through ``serve_step``, one token
each a step, in a C-slot cache whose first P positions hold each
sequence's prompt: P Zipf-distributed token ids, run through the
program's ``prefill_step`` ``prefill_batch`` sequences a call at set-up
(the last logits give each sequence's first token).  Each step's tokens reach the host before
the next step starts.

The sequences to check are drawn from the seed at set-up; each step keeps
their logits.  Once the window has closed the reference runs each checked
sequence whole, its prompt and every token it was fed (set-up's steps and
the window's): the gap by which each served token's logit lies below the
reference's best, the logits' error over all the checked steps, and the
error of the keys and values the steps wrote, over all of them, at the
worst layer.
"""

from __future__ import annotations

import gc
import time

import torch

from benchlib import inputs as I
from benchlib.counts import step_counts
from reference.model import Ref

BF16 = torch.bfloat16


class Entry:
    def __init__(self, run):
        from repro_torch.configs.shapes import InputShape
        from repro_torch.launch.steps import (make_prefill_step,
                                              make_serve_step)
        t = run.traffic
        self.run, self.t, dev = run, t, run.device
        b, c, p0 = t["batch"], t["cache_len"], t["prefix_len"]
        self.step_fn, (p_struct, c_struct, _, _) = make_serve_step(
            run.pcfg, InputShape("bench", seq_len=c, global_batch=b,
                                 kind="decode"), dtype=BF16)
        self.p_struct = p_struct
        self.params = I.make_params(p_struct, run.cfg, run.seed, dev, BF16)
        probs = I.zipf_probs(run.cfg["vocab_size"], t["zipf_exponent"], dev)
        self.prompts = I.zipf_tokens(probs, (b, p0),
                                     I.generator(run.seed, "prompts", dev))
        g = t["prefill_batch"]
        if b % g:
            raise ValueError(f"batch {b} is not a multiple of prefill_batch "
                             f"{g}")
        prefill, _ = make_prefill_step(
            run.pcfg, InputShape("bench-prompt", seq_len=c, global_batch=g,
                                 kind="prefill"), dtype=BF16)
        kv = c_struct["stacked"][0]
        k = torch.empty(kv.k.shape, dtype=BF16, device=dev)
        v = torch.empty(kv.v.shape, dtype=BF16, device=dev)
        first = []
        for i in range(0, b, g):
            logits, part = prefill(self.params, self.prompts[i:i + g])
            o = part["stacked"][0]
            k[:, i:i + g], v[:, i:i + g], slot = o.k, o.v, o.slot_pos
            first.append(logits.argmax(-1).to(torch.int32))
            del part, o
        self.cache = dict(c_struct, stacked=(type(kv)(k=k, v=v,
                                                      slot_pos=slot),))
        self.tok = torch.cat(first)
        g = torch.Generator().manual_seed(I.sub_seed(run.seed, "check"))
        self.seqs = torch.randperm(b, generator=g)[:t["check_sequences"]] \
            .sort()[0].to(dev)
        self.fed, self.served, self.logits = [], [], []
        self.events, self.stamps = [], []
        self.pos = p0

    def _step(self):
        if self.pos >= self.t["cache_len"]:
            raise RuntimeError("the cache is full: the run outlasted its "
                               "free positions")
        logits, self.cache = self.step_fn(self.params, self.cache, self.tok,
                                          self.pos)
        self.fed.append(self.tok[self.seqs])
        tok = logits.argmax(-1).to(torch.int32)
        if self.run.fault == "token":       # a token altered
            tok = (tok + 1) % logits.shape[-1]
        self.logits.append(logits[self.seqs])
        self.served.append(tok[self.seqs])
        self.tok = tok
        self.pos += 1
        if torch.device(self.run.device).type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        tok.cpu()               # the step's tokens reach the host
        if not self.events:     # no device clock: the host's (tests)
            self.stamps.append(time.perf_counter() * 1e3)

    def warmup(self):
        for _ in range(self.t["warmup_steps"]):
            self._step()
        self.first = max(len(self.events), len(self.stamps))

    def step(self):
        self._step()

    def end_to_end(self, wall_s: float, steps: int):
        ev = self.events[self.first - 1:]
        gaps = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        st = self.stamps[self.first - 1:]
        gaps = sorted(gaps + [b - a for a, b in zip(st, st[1:])])
        p95 = gaps[min(len(gaps) - 1, int(0.95 * len(gaps)))] if gaps \
            else float("nan")
        return {"decode_tokens_per_s": steps * self.t["batch"] / wall_s,
                "decode_itl_ms_p95": p95}

    def counts(self):
        t = dict(self.t, mean_new_positions=self.pos - self.t["prefix_len"]
                 - self.run.wl["trace_steps"] / 2)
        return step_counts(self.run.cfg, "decode", t)

    def release(self):
        p0 = self.t["prefix_len"]
        kv = self.cache["stacked"][0]
        n = len(self.served)
        self.new_k = kv.k[:, self.seqs, p0:p0 + n].clone()
        self.new_v = kv.v[:, self.seqs, p0:p0 + n].clone()
        del self.params, self.step_fn, self.cache, kv
        gc.collect()
        if torch.device(self.run.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False):
        """The served tokens' widest gap; the logits' error and each
        layer's error of the keys and values written, each over all the
        checked sequences' steps together (the cache's at the worst
        layer)."""
        run, p0 = self.run, self.t["prefix_len"]
        w = I.ref_weights(self.p_struct, run.cfg, run.seed, run.device, BF16)
        fed = torch.stack(self.fed, 1)          # (seqs, n)
        served = torch.stack(self.served, 1)
        logits = torch.stack(self.logits, 1)    # (seqs, n, V)
        n, n_l = fed.shape[1], run.cfg["n_layers"]
        refs = [Ref(run.cfg)] + ([Ref(run.cfg, "fp8")] if control else [])
        sums = [Sums(n_l) for _ in refs]
        for i, s in enumerate(self.seqs.tolist()):
            seq = torch.cat([self.prompts[s], fed[i]])
            got = []
            for ref in refs:
                kv = []
                lg = ref.forward(w, seq, n, lambda l, k, v: kv.append(
                    (k[p0:], v[p0:])))
                got.append((lg, kv))
            best, kv_ref = got[0]
            outs = [(logits[i], served[i],
                     [(self.new_k[l, i], self.new_v[l, i])
                      for l in range(n_l)])]
            if control:
                lo, kv_lo = got[1]
                outs.append((lo, lo.argmax(-1), kv_lo))
            for acc, (lg, tok, kv) in zip(sums, outs):
                acc.add(best, lg, tok, kv_ref, kv)
        got = [acc.numbers() for acc in sums]
        return tuple(got) if control else got[0]


class Sums:
    """Squared norms of errors and of the reference, summed over the
    checked sequences: the logits', and each layer's keys' and values'."""

    def __init__(self, n_layers: int):
        self.gap = 0.0
        self.lg = [0.0, 0.0]
        self.kv = [[0.0, 0.0, 0.0, 0.0] for _ in range(n_layers)]

    def add(self, best, lg, tok, kv_ref, kv):
        top = best.max(-1).values
        gap = top - best.gather(1, tok.long()[:, None])[:, 0]
        self.gap = max(self.gap, float(gap.max()))
        self.lg[0] += float((lg.float() - best).square().sum())
        self.lg[1] += float(best.square().sum())
        for acc, (x, y), (a, b) in zip(self.kv, kv_ref, kv):
            acc[0] += float((a.float() - x).square().sum())
            acc[1] += float(x.square().sum())
            acc[2] += float((b.float() - y).square().sum())
            acc[3] += float(y.square().sum())

    def numbers(self):
        return {"token_gap": self.gap,
                "logit_err": (self.lg[0] / self.lg[1]) ** 0.5,
                "cache_err": max(max(a / b, c / d) ** 0.5
                                 for a, b, c, d in self.kv)}
