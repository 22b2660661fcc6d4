"""The port's roofline (``repro_torch.roofline``) against the reference's
``repro.roofline``: the aggregation kernels' byte and FLOP model and the
analytic per-(architecture x shape) terms are plain Python floats, so the
port's values must equal the reference's exactly.  The H100 chip carries
the figures that every bound in PERF.md section 6 was computed with."""

import importlib.util
import itertools
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import ARCH_NAMES as J_ARCH_NAMES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as J_SHAPES  # noqa: E402
from repro.roofline import analytic as j_analytic  # noqa: E402
from repro.roofline import kernels as j_kernels  # noqa: E402
from repro.roofline.hardware import TPU_V5E as J_TPU_V5E  # noqa: E402
from repro_torch import roofline  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.roofline import analytic, hardware, kernels  # noqa: E402

GRID = list(itertools.product((1, 20, 512, 2_880), (1, 40_718, 152_404),
                              (1, 2, 16), (False, True), (False, True)))


@pytest.mark.parametrize("fn", ["fed_reduce_traffic",
                                "fed_reduce_separate_traffic"])
def test_fed_reduce_traffic_equals_the_reference(fn):
    for m, n, t, quant, base in GRID:
        got = getattr(kernels, fn)(m, n, t, quant=quant, base=base)
        want = getattr(j_kernels, fn)(m, n, t, quant=quant, base=base)
        assert (got.name, got.bytes_hbm, got.flops) == \
            (want.name, want.bytes_hbm, want.flops), (m, n, t, quant, base)
        assert got.bound_s() == want.bound_s(J_TPU_V5E)
        assert got.bound_s_at(1e11) == want.bound_s_at(1e11)
        assert got.bound_s(hardware.H100) == max(
            got.bytes_hbm / 3.35e12, got.flops / 989e12)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_analytic_terms_equal_the_reference(arch):
    assert ARCH_NAMES == J_ARCH_NAMES and sorted(SHAPES) == sorted(J_SHAPES)
    for shape in SHAPES:
        for kw in ({}, dict(moe_dense=False, remat=False, causal_skip=True)):
            got = analytic.analyze(get_config(arch), SHAPES[shape], **kw)
            want = j_analytic.analyze(j_get_config(arch), J_SHAPES[shape],
                                      **kw)
            assert (got.flops, got.hbm_bytes, got.coll_bytes,
                    got.flops_ideal, got.detail) == \
                (want.flops, want.hbm_bytes, want.coll_bytes,
                 want.flops_ideal, want.detail), (arch, shape, kw)
            assert got.terms() == want.terms(J_TPU_V5E)
            assert got.bottleneck() == want.bottleneck(J_TPU_V5E)
            for chip in (hardware.H100,):
                t = got.terms(chip)
                assert t["memory"] == got.hbm_bytes / 3.35e12
                assert got.bottleneck(chip) == max(t, key=t.get)


def test_the_h100_is_the_card_of_every_bound():
    """The figures of PERF.md section 6's bounds (NVIDIA H100 SXM5 80GB
    data sheet, 700 W), which ``chip_smoke.py`` reads from here."""
    h = hardware.H100
    assert (h.hbm_bandwidth, h.peak_flops_bf16, h.hbm_bytes) == \
        (3.35e12, 989e12, 80e9)
    assert hardware.H100_F32_FLOPS_PER_S == 67e12
    assert hardware.H100_TF32_FLOPS_PER_S == 495e12
    # NVLink 4 at its one-way rate: 18 links of 25 GB/s
    assert h.ici_links_per_chip * h.ici_link_bandwidth == 450e9
    assert hardware.TPU_V5E == hardware.Chip(**vars(J_TPU_V5E))
    assert roofline.__all__ == ["TPU_V5E", "H100", "KernelTraffic",
                                "fed_reduce_traffic",
                                "fed_reduce_separate_traffic",
                                "RooflineReport", "analyze_traced"]
    # chip_smoke.py takes its rates from this module and nowhere else, and
    # its bounds keep their bits
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    for literal in ("3.35e12", "67e12", "495e12", "989e12"):
        assert literal not in path.read_text(), literal
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert (smoke.HBM_BYTES_PER_S, smoke.F32_FLOPS_PER_S,
            smoke.TF32_FLOPS_PER_S, smoke.BF16_FLOPS_PER_S) == \
        (3.35e12, 67e12, 495e12, 989e12)
    assert smoke.bound(4e9, 1e9) == (4e9 / 3.35e12 * 1e3, "bytes")
    assert smoke.bound(1e6, 1e12, smoke.TF32_FLOPS_PER_S) == \
        (1e12 / 495e12 * 1e3, "operations")
    # every fed_reduce case's bytes (the formula chip_smoke.py takes from
    # the roofline): the roofline's count plus the (M,) weights, segments
    # and int8 mask, equal to the count by hand
    for m, n, t, quant, base in GRID:
        hand = 4 * (m * n + 2 * m + t * n * (2 if base else 1))
        if quant:
            hand += 4 * t * n + m           # quant_ref, quant mask
        assert smoke.fed_reduce_launch_traffic(
            m, n, t, quant=quant, base=base).bytes_hbm == hand, \
            (m, n, t, quant, base)
