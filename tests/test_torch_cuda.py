"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips when no card is present (decided inside the
fixture, never at import). On the H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

TF32 is off for every f32 comparison. Tolerances follow tests/test_kernels.py
(f32 2e-5, bf16 2e-2), scaled as it scales them: by n for the n-term update
sum and by 4 for f32 attention. bf16 attention has the tighter limit of
chip_smoke.py, set from on-card readings.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import attend
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ns_update import ns_update as nu_mod
from repro_torch.kernels.ns_update.ns_update import ns_update
from repro_torch.kernels.ns_update.ref import ns_update_ref

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 flash attention, as chip_smoke.py holds it: elementwise
# |err| <= 4e-3 + 2e-2 |ref|, and the relative L2 error of each output row
# <= 1e-2 (scripts/flash_fault_check.py shows planted faults fail it).
FLASH_BF16_ATOL, FLASH_BF16_RTOL, FLASH_BF16_ROW_REL_L2 = 4e-3, 2e-2, 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,B,D", [(4, 8, 512), (8, 4, 65536), (16, 4, 384),
                                   (20, 3, 1000), (3, 1, 7)])
def test_ns_update_matches_plain(dev, n, B, D, dtype):
    rng = np.random.default_rng(n * 1000 + B + D)
    x0 = _randn(rng, (B, D), dtype, dev)
    u = _randn(rng, (n, B, D), dtype, dev)
    a = _randn(rng, (), torch.float32, dev)
    w = _randn(rng, (n,), torch.float32, dev)
    before = nu_mod.COUNTER.launches
    out = ns_update(x0, u, a, w)
    torch.cuda.synchronize()
    assert nu_mod.COUNTER.launches == before + 1
    ref = ns_update_ref(x0, u, a, w)
    assert out.dtype == dtype and out.shape == x0.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype] * n,
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,L,hd,causal", [
    (1, 4, 2, 256, 64, True),
    (2, 8, 8, 128, 128, True),
    (1, 4, 1, 256, 64, True),      # extreme GQA
    (1, 2, 2, 128, 128, False),    # bidirectional (encoder)
    (2, 8, 2, 100, 80, True),      # ragged L, hd=80 tile plan
    (1, 4, 4, 1, 128, True),       # one position
    (1, 32, 4, 1000, 128, True),   # yi-6b heads, ragged L
    (1, 4, 2, 77, 80, False),
])
def test_flash_attention_matches_plain(dev, B, H, KV, L, hd, causal, dtype):
    rng = np.random.default_rng(B + H + L + hd)
    q = _randn(rng, (B, H, L, hd), dtype, dev)
    k = _randn(rng, (B, KV, L, hd), dtype, dev)
    v = _randn(rng, (B, KV, L, hd), dtype, dev)
    before = fa_mod.COUNTER.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_mod.COUNTER.launches == before + 1
    ref = attention_ref(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=TOL[dtype] * 4, rtol=TOL[dtype] * 4)
        return
    torch.testing.assert_close(out.float(), ref.float(), atol=FLASH_BF16_ATOL,
                               rtol=FLASH_BF16_RTOL)
    ref = ref.float()
    row_err = (torch.linalg.vector_norm(out.float() - ref, dim=-1)
               / torch.linalg.vector_norm(ref, dim=-1))
    assert float(row_err.max()) <= FLASH_BF16_ROW_REL_L2


def test_attend_reads_model_layout_in_place(dev):
    """Transposed (B, L, H, hd) views go in without copies; the result comes
    back in the model layout, contiguous."""
    rng = np.random.default_rng(0)
    B, L, H, KV, hd = 2, 96, 8, 2, 128
    q = _randn(rng, (B, L, H, hd), torch.float32, dev)
    k = _randn(rng, (B, L, KV, hd), torch.float32, dev)
    v = _randn(rng, (B, L, KV, hd), torch.float32, dev)
    out = attend(q, k, v, causal=True)
    assert out.is_contiguous() and out.shape == q.shape
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(out, ref, atol=TOL[torch.float32] * 4,
                               rtol=TOL[torch.float32] * 4)


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros(2, 8, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        ns_update(x, x[None], torch.zeros((), device=dev), torch.zeros(1, device=dev))
    q = torch.zeros(1, 2, 16, 32, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    shifted = torch.zeros(1, 2, 16, 65, device=dev, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(shifted, shifted, shifted)
