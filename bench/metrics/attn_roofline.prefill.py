"""attn_roofline.prefill: the hand-written attention forward's share of its
roofline in the traced calls: its launches' bound (4 D FLOP a live pair at
the bf16 peak, or its bytes at HBM bandwidth) over their device time, in
%.  Moves ``prefill_tokens_per_s``."""


def read(t):
    n, s = t.class_time_s("flash_attention")
    if n == 0 or "attn_fwd_bound_s" not in t.counts:
        return None
    return 100.0 * n * t.counts["attn_fwd_bound_s"] / s
