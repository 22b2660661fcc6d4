"""Each entry drives the program and is judged against ``bench/reference``
at a small size on the CPU, through the program's plain paths: in float32
the program and the reference agree to rounding; the control (the
reference in float8 put in the program's place) and the planted faults of
the timed path come out as not correct under the cell's own limits, by the
one predicate that decides ``correct``."""

import time

import pytest
import torch

from conftest import cells, small


def _run(cell, seed, *, f32=False, **kw):
    from benchlib import harness
    model, traffic = small(cell)
    if f32:
        traffic = dict(traffic, dtype="float32")
        orig = harness.entry_class

        def entry_class(entry, bench=harness.BENCH):
            cls = orig(entry, bench)
            cls.__init__.__globals__["BF16"] = torch.float32
            return cls
        harness.entry_class = entry_class
    try:
        return harness.run_cell(cell, seed, 0.05, False, "cpu",
                                time.perf_counter(), model=model,
                                traffic=traffic, **kw)
    finally:
        if f32:
            harness.entry_class = orig


@pytest.mark.parametrize("cell", cells())
def test_program_in_f32_agrees_with_the_reference(cell):
    out = _run(cell, 2**31 + 17, f32=True)
    for name, c in out["checks"].items():
        assert c["value"] < 1e-4, (name, c)


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(cell):
    out = _run(cell, 23, control=True)
    ctl = out["control"]
    assert ctl["correct"] is False, ctl
    assert any(c["value"] > c["limit"] for c in ctl["checks"].values())
    assert set(ctl["checks"]) == set(out["checks"])


@pytest.mark.parametrize("cell", cells())
def test_altered_token_is_not_correct(cell):
    out = _run(cell, 29, fault="token")
    assert not out["correct"], out["checks"]
    assert out["checks"]["token_gap"]["value"] > \
        out["checks"]["token_gap"]["limit"]
