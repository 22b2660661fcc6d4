"""Assigned input shapes.

Each shape names the step it lowers:
  * train shapes   -> ``fl_train_step``  (FL round: local grad steps + weighted psum)
  * prefill shapes -> ``prefill_step``   (forward, build KV cache)
  * decode shapes  -> ``serve_step``     (ONE new token against a seq_len KV cache)

Copy of ``repro.configs.shapes``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = InputShape("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = InputShape("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = InputShape("long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def get_shape(name: str) -> InputShape:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}") from None
