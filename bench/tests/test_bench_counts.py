"""``benchlib.counts`` against hand counts of the two configurations, and
its frozen copies against the program's originals."""

import pytest

from benchlib import counts
from benchlib import harness


def model(name):
    return harness.config(name)["model"]


def test_granite_hand_counts():
    c = model("granite-moe-1b-a400m")
    attn = 1024 * 64 * (2 * 16 + 2 * 8)              # q, k, v, o
    active = 8 * 3 * 1024 * 512 + 1024 * 32          # top-8 experts, router
    assert counts.layer_matrix_params(c) == attn + active == 15_761_408
    every = 24 * (attn + 32 * 3 * 1024 * 512 + 1024 * 32 + 2 * 1024)
    assert counts.param_count(c) == every + 1024 + 49_155 * 1024 \
        == 1_334_628_352
    # a decode step of the cell: 256 sequences at 2,048 + 10 positions
    t = {"batch": 256, "prefix_len": 2048, "mean_new_positions": 10}
    got = counts.step_counts(c, "decode", t)
    flops = 2 * (24 * 15_761_408 + 49_155 * 1024) * 256 \
        + 4 * 64 * 16 * 24 * 2058 * 256
    assert got["flops"] == pytest.approx(flops, rel=1e-12)


def test_qwen2_hand_counts():
    c = model("qwen2-7b")
    layer = 3584 * 128 * (2 * 28 + 2 * 4) + 3 * 3584 * 18_944
    assert counts.layer_matrix_params(c) == layer == 233_046_016
    bias = 128 * (28 + 2 * 4)
    assert counts.param_count(c) == 28 * (layer + bias + 2 * 3584) + 3584 \
        + 2 * 152_064 * 3584 == 7_615_616_512
    t = {"batch": 1, "prompt_len": 32_768}
    pairs = 32_768 * 32_769 // 2
    flops = 2 * 28 * layer * 32_768 + 2 * 3584 * 152_064 \
        + 4 * 128 * 28 * 28 * pairs
    got = counts.step_counts(c, "prefill", t)
    assert got["flops"] == pytest.approx(flops, rel=1e-12)
    assert 4.27e14 < 2 * 28 * layer * 32_768 < 4.28e14   # 428 TFLOP
    short = counts.step_counts(c, "prefill", {"batch": 16,
                                              "prompt_len": 2048})
    attn_share = 4 * 128 * 28 * 28 * (2048 * 2049 // 2) * 16 / short["flops"]
    assert 0.02 < attn_share < 0.04                        # about 3%


def test_decode_is_bound_by_bytes():
    c = model("granite-moe-1b-a400m")
    t = {"batch": 256, "prefix_len": 2048}
    got = counts.step_counts(c, "decode", t)
    kv = 2 * 24 * 8 * 64 * 2 * 256 * 2049
    assert got["bytes"] == 2 * counts.param_count(c) + kv
    assert got["bytes"] / counts.PEAK_HBM_BYTES > \
        got["flops"] / counts.PEAK_BF16_FLOPS


@pytest.mark.parametrize("s,t,causal,window", [
    (4096, 4096, True, None), (512, 1024, False, None),
    (4000, 4000, True, 2048), (1, 30_721, True, None), (64, 64, False, 16)])
def test_frozen_copies_equal_the_programs(s, t, causal, window):
    from repro_torch.roofline import kernels as prog
    assert counts.live_pairs(s, t, causal, window) == \
        prog.live_pairs(s, t, causal, window)
    for bwd in (False, True):
        a = counts.attention_traffic(2, 16, 8, s, t, 64, causal=causal,
                                     window=window, esize=2, backward=bwd,
                                     lse=True)
        b = prog.attention_traffic(2, 16, 8, s, t, 64, causal=causal,
                                   window=window, esize=2, backward=bwd,
                                   lse=True)
        assert (a.bytes_hbm, a.flops) == (b.bytes_hbm, b.flops)


def test_frozen_classifier_equals_the_programs():
    from benchlib.trace import kernel_class
    from repro_torch.launch.profile_train import kernel_class as prog
    for n in ("void flash_attention_bf16_kernel<64>(Args)",
              "attn16_bwd_main<64>", "attn16_bwd_prep<128>",
              "sm90_xmma_gemm_bf16bf16", "nvjet_tst_128x256",
              "Memcpy DtoD", "vectorized_elementwise_kernel",
              "rglru_scan_bf16_kernel"):
        assert kernel_class(n) == prog(n)
