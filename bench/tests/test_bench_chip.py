"""One short run of a cell on the card, through the benchmark's own
command; skips where there is no card (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH


@pytest.mark.gpu
def test_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "qwen2-7b.prefill-2k", "--seed", str(2**31 + 5), "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["metrics"]["prefill_tokens_per_s"]["value"] > 0


def test_run_refuses_without_enough_cards():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "qwen2-7b.prefill-2k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=BENCH.parent)
    assert out.returncode != 0 and out.stdout.strip() == ""
