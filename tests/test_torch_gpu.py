"""The port's Hopper kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where no CUDA device is present (decided in
the ``cuda`` fixture, never at import).  On a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The shapes cover every vector width the kernels pick (N divisible by 4, by
2 only, and odd), a misaligned row pointer, interleaved and empty segments
and the int8 round trip.  ``fed_reduce`` and the M=1 ``fed_aggregate`` must
be bitwise equal to the plain version; ``fed_aggregate`` at M>1 within
rtol=1e-6.  This file imports no JAX, so it runs where only torch is.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fed_aggregate as fa_mod  # noqa: E402
from repro_torch.kernels import fed_reduce as fr_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(m, n, t, seed, dev):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, t, m).astype(np.int32)
    if t > 2:
        seg[seg == 1] = 0                              # segment 1 empty
    w = rng.uniform(1.0, 100.0, m).astype(np.float32)
    w[0] = 0.0                                         # a zero-weight row
    rows = rng.standard_normal((m, n)).astype(np.float32)
    base = rng.standard_normal((t, n)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (w, rows, seg, base)]


@pytest.mark.parametrize("n", [4096, 4098, 4099])
@pytest.mark.parametrize("mode", ["plain", "normalize", "base", "quant"])
def test_fed_reduce_kernel_is_bitwise(cuda, n, mode):
    m, t = 19, 4
    w, rows, seg, base = _case(m, n, t, seed=n, dev=cuda)
    kw = {"normalize": mode != "plain"}
    if mode == "quant":
        kw.update(leaf_sizes=(n // 3, n - n // 3), quant_ref=base,
                  quant_enabled=torch.arange(m, device=cuda) % 3 != 0)
    b = base if mode in ("base", "quant") else None
    before = fr_mod.launches
    got = fr_mod.fed_reduce(w, rows, seg, t, b, **kw)
    torch.cuda.synchronize()
    assert fr_mod.launches == before + 1
    assert torch.equal(got, ref.fed_reduce_ref(w, rows, seg, t, b, **kw))


def test_fed_reduce_kernel_misaligned_rows(cuda):
    """A view that starts one float into its storage takes the scalar
    path and gives the same bits."""
    m, n, t = 6, 1024, 2
    w, rows, seg, base = _case(m, n + 1, t, seed=1, dev=cuda)
    view = rows.reshape(-1)[1:1 + m * n].reshape(m, n)
    got = fr_mod.fed_reduce(w, view, seg, t, base[:, :n].contiguous(),
                            normalize=True)
    want = ref.fed_reduce_ref(w, view, seg, t, base[:, :n].contiguous(),
                              normalize=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,n", [(1, 4096), (1, 4099), (16, 4098)])
def test_fed_aggregate_kernel(cuda, m, n):
    rng = np.random.default_rng(m + n)
    w, d, base = (torch.from_numpy(a).to(cuda) for a in (
        rng.uniform(0.0, 1.0, m).astype(np.float32),
        rng.standard_normal((m, n)).astype(np.float32),
        rng.standard_normal(n).astype(np.float32)))
    before = fa_mod.launches
    got = fa_mod.fed_aggregate(w, d, base)
    want = ref.fed_aggregate_ref(w, d, base)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    if m == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
