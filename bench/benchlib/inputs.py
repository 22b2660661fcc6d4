"""What the benchmark makes from ``--seed``: weights and token ids, on the
device, in the dtype they are served in.

The program's parameter and cache trees are used for their shapes only
(the ``meta`` structs that its ``make_*_step`` return).  Each leaf is drawn
from a generator of its own, seeded by the run's seed and the leaf's name,
so any leaf can be drawn again, bit for bit, for the reference once the
program's copy is gone.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Tuple

import torch

# standard deviation of each weight by its name in the tree: fan-in
# scaling for products, small random offsets for the norms' (1 + w) and the
# q/k/v biases so that every term of the model carries weight
def weight_std(name: str, cfg: Dict) -> float:
    d, hd = cfg["d_model"], cfg["head_dim"]
    f = cfg["moe"]["d_ff_expert"] if cfg.get("moe") else cfg["d_ff"]
    return {
        "embed": 0.02, "lm_head": d ** -0.5,
        "final_norm": 0.1, "ln1": 0.1, "ln2": 0.1,
        "wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
        "wo": (cfg["n_heads"] * hd) ** -0.5,
        "bq": 0.3, "bk": 0.3, "bv": 0.3,
        "w_gate": d ** -0.5, "w_up": d ** -0.5, "w_down": cfg["d_ff"] ** -0.5,
        "router": d ** -0.5, "we_gate": d ** -0.5, "we_up": d ** -0.5,
        "we_down": f ** -0.5,
    }[name]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run (any size of ``seed``)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def tree_paths(tree, prefix=()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) in a fixed order: dict keys sorted, sequences and
    NamedTuple fields in order (fields by name)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for f, x in zip(tree._fields, tree)
                for pl in tree_paths(x, prefix + (f,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree)
                for pl in tree_paths(x, prefix + (i,))]
    return [(prefix, tree)]


def rebuild(tree, fn, prefix=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, fn, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[rebuild(x, fn, prefix + (f,))
                            for f, x in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(x, fn, prefix + (i,))
                          for i, x in enumerate(tree))
    return fn(prefix, tree)


def ref_name(path: Tuple) -> str:
    """A parameter's name in the reference's dict: ``embed``,
    ``final_norm``, ``lm_head``, or ``layers.<name>`` for a leaf of the
    layers stacked on their leading axis."""
    if path[0] == "stacked":
        return f"layers.{path[-1]}"
    if path[0] == "rest":
        raise ValueError("unstacked layers are not laid out by the bench")
    return path[-1]


def draw_weight(name: str, shape, cfg: Dict, seed: int, device,
                dtype) -> torch.Tensor:
    """The leaf ``name`` (``ref_name``), drawn from its own stream."""
    g = generator(seed, f"weight:{name}", device)
    x = torch.randn(tuple(shape), generator=g, device=device,
                    dtype=torch.float32)
    return x.mul_(weight_std(name.split(".")[-1], cfg)).to(dtype)


def make_params(p_struct, cfg: Dict, seed: int, device, dtype):
    """The program's parameter tree, every leaf drawn from the seed."""
    return rebuild(p_struct, lambda path, leaf: draw_weight(
        ref_name(path), leaf.shape, cfg, seed, device, dtype))


def ref_weights(p_struct, cfg: Dict, seed: int, device, dtype
                ) -> Dict[str, Any]:
    """The same weights in the reference's dict: top-level names and
    ``layers``: name -> stacked tensor."""
    w: Dict[str, Any] = {"layers": {}}
    for path, leaf in tree_paths(p_struct):
        name = ref_name(path)
        x = draw_weight(name, leaf.shape, cfg, seed, device, dtype)
        if name.startswith("layers."):
            w["layers"][name[7:]] = x
        else:
            w[name] = x
    return w


def zipf_probs(vocab: int, exponent: float, device) -> torch.Tensor:
    """Token id i drawn with weight (i + 1) ** -exponent."""
    r = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
    p = r.pow(-exponent)
    return (p / p.sum()).to(torch.float32)


def zipf_tokens(probs: torch.Tensor, shape, gen: torch.Generator
                ) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    ids = torch.multinomial(probs, n, replacement=True, generator=gen)
    return ids.reshape(tuple(shape)).to(torch.int32)
