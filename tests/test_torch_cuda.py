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


def _paged_inputs(seed, B, KV, G, hd, ps, nb, q_dtype, page_dtype, dev, layers=1):
    """q, a (layers, num_pages, ps, KV, hd) K and V pool, each row owning nb
    shuffled (non-contiguous) pages past the trash page 0, ragged lengths."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + B * nb
    q = _randn(rng, (B, KV, G, hd), q_dtype, dev)
    k = _randn(rng, (layers, num_pages, ps, KV, hd), page_dtype, dev)
    v = _randn(rng, (layers, num_pages, ps, KV, hd), page_dtype, dev)
    perm = rng.permutation(num_pages - 1)[:B * nb] + 1
    table = torch.from_numpy(perm.reshape(B, nb).astype(np.int32)).to(dev)
    lengths = torch.tensor([(i * ps + i + 1) % (nb * ps) + 1 for i in range(B)],
                           dtype=torch.int32, device=dev)
    return q, k, v, table, lengths


def _check_paged(out, ref):
    """f32 output: 4x the f32 TOL, as tests/test_kernels.py holds f32
    attention. bf16 output: both versions keep scores, weights and sums in
    f32 and round only the output, so they differ by at most one bf16 ulp of
    |o|, which is <= 2**-7 |o|."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=TOL[torch.float32] * 4,
                                   rtol=TOL[torch.float32] * 4)
        return
    err = (out.float() - ref.float()).abs()
    limit = 2.0 ** -7 * ref.float().abs() + 1e-6
    assert bool((err <= limit).all()), float((err / limit).max())


_PAGED_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                 (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("q_dtype,page_dtype", _PAGED_DTYPES, ids=str)
@pytest.mark.parametrize("B,KV,G,hd,ps,nb", [
    (2, 2, 2, 64, 8, 4),        # tests/test_kernels.py sweep
    (3, 1, 4, 32, 16, 2),
    (1, 4, 1, 64, 8, 3),
    (2, 2, 4, 80, 16, 3),       # hd=80
    (3, 2, 7, 128, 4, 5),       # G=7, small pages
    (8, 4, 8, 128, 16, 16),     # the decode cell: yi-6b heads, 256-position rows
    (2, 4, 8, 128, 16, 64),     # 1024-position rows
])
def test_paged_attention_matches_plain(dev, B, KV, G, hd, ps, nb, q_dtype, page_dtype):
    from repro_torch.kernels.flash_attention import paged_attention as pa_mod
    from repro_torch.kernels.flash_attention.ref import paged_attention_ref

    q, k, v, table, lengths = _paged_inputs(B + G + hd + nb, B, KV, G, hd, ps, nb,
                                            q_dtype, page_dtype, dev)
    before = pa_mod.COUNTER.launches
    out = pa_mod.paged_attention(q, k[0], v[0], table, lengths)
    torch.cuda.synchronize()
    assert pa_mod.COUNTER.launches == before + 1
    _check_paged(out, paged_attention_ref(q, k[0], v[0], table, lengths))


@pytest.mark.parametrize("q_dtype,page_dtype", _PAGED_DTYPES, ids=str)
def test_paged_attention_edge_rows(dev, q_dtype, page_dtype):
    """A pool view of one layer; garbage (+-1e4) in a row's own pages past its
    length; rows whose block table is all zeros (the trash page, as inactive
    slots read it); a length past nb * page_size (the clamped write)."""
    from repro_torch.kernels.flash_attention.paged_attention import paged_attention
    from repro_torch.kernels.flash_attention.ref import paged_attention_ref

    B, KV, G, hd, ps, nb = 4, 4, 8, 128, 16, 4
    q, k, v, table, lengths = _paged_inputs(7, B, KV, G, hd, ps, nb, q_dtype,
                                            page_dtype, dev, layers=3)
    table[2] = 0
    lengths[:] = torch.tensor([5, 37, 1, nb * ps + 9], dtype=torch.int32)
    kl, vl = k[1], v[1]                    # per-layer views of the stacked pool
    base = paged_attention(q, kl, vl, table, lengths)
    _check_paged(base, paged_attention_ref(q, kl, vl, table, lengths))
    torch.testing.assert_close(base, paged_attention(q, kl.clone(), vl.clone(), table,
                                                     lengths), atol=0, rtol=0)
    # poison row 0's own pages past its length 5 and row 1's past 37
    for row, n in ((0, 5), (1, 37)):
        for pos in range(n, nb * ps):
            page = int(table[row, pos // ps])
            kl[page, pos % ps] = 1e4 if pos % 2 else -1e4
            vl[page, pos % ps] = -1e4 if pos % 2 else 1e4
    poisoned = paged_attention(q, kl, vl, table, lengths)
    torch.testing.assert_close(poisoned, base, atol=0, rtol=0)
    _check_paged(poisoned, paged_attention_ref(q, kl, vl, table, lengths))


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

    from repro_torch.kernels.flash_attention.paged_attention import paged_attention

    q, k, v, table, lengths = _paged_inputs(0, 2, 2, 2, 64, 8, 2, torch.float32,
                                            torch.float32, dev)
    with pytest.raises(TypeError, match="int32"):
        paged_attention(q, k[0], v[0], table.long(), lengths)
    with pytest.raises(TypeError):
        paged_attention(q.half(), k[0], v[0], table, lengths)
    with pytest.raises(ValueError, match="head dims"):
        paged_attention(q[..., :48].contiguous(), k[0][..., :48].contiguous(),
                        v[0][..., :48].contiguous(), table, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(q, k[0].transpose(0, 1), v[0].transpose(0, 1), table, lengths)
