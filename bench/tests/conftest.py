"""Shared set-up of the benchmark's CPU tests: the import paths, and small
sizes of each cell's configuration and traffic (the widths cut, every
structural feature kept), at which the program runs its plain CPU paths.

    python -m pytest -q bench/tests
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH.parent / "src"), str(BENCH)]

SMALL_MOE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                 head_dim=16, d_ff=96, vocab_size=512,
                 moe=dict(n_experts=4, top_k=2, d_ff_expert=32,
                          aux_loss_coef=0.01))
SMALL_DENSE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=96, vocab_size=512)
SMALL_TRAFFIC = {
    "prefill": dict(batch=2, prompt_len=48, cache_positions=8,
                    check_prompts=2),
    "decode": dict(batch=4, cache_len=4096, prefix_len=40,
                   prefill_batch=2, check_sequences=2),
}


def small(cell: str):
    """(model, traffic) replacements that run ``cell`` at a small size."""
    from benchlib import harness
    wl = harness.workload(cell)
    cfg = harness.config(wl["config"])["model"]
    return (SMALL_MOE if cfg.get("moe") else SMALL_DENSE,
            SMALL_TRAFFIC[wl["entry"]])


def cells():
    import json
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    return [w["name"] for w in spec["workloads"]]


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
