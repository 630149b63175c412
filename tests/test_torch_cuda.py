"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips when no card is present (decided inside the
fixture, never at import). On the H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

TF32 is off for every f32 comparison. Tolerances follow tests/test_kernels.py
(f32 2e-5, bf16 2e-2), scaled as it scales them: by n for the n-term update
sum, by 4 for f32 attention, and atol 20x / rtol 1x for the gated linear
recurrence (its strong-decay case at that test's atol 1e-3), held against its
step-by-step oracle taken in f64 on the same inputs: over long weakly decayed
sequences the f32 recurrence itself drifts from exact by more than that limit. bf16 attention has the tighter limit of
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
# bf16 flash backward, as chip_smoke.py's FLASH_BWD_BF16 holds it: one bf16
# rounding step elementwise, and each row's relative L2 error over
# max(|ref row|, atol sqrt(hd)).
FLASH_BWD_ATOL, FLASH_BWD_RTOL, FLASH_BWD_ROW_REL_L2 = 1e-3, 2 ** -7, 4e-3


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
def test_ns_update_takes_the_solvers_live_row_views(dev, dtype):
    """ns_sample hands step i U[:i+1] and one row of b as views; here the
    weights are a strided column view, so w's stride reaches the kernel."""
    rng = np.random.default_rng(5)
    n, B, D = 8, 4, 4096
    x0 = _randn(rng, (B, D), dtype, dev)
    U = _randn(rng, (n, B, D), dtype, dev)
    a = _randn(rng, (n,), torch.float32, dev)
    bt = _randn(rng, (n, n), torch.float32, dev).t()
    for i in range(n):
        u, w = U[: i + 1], bt[i, : i + 1]
        assert w.stride(0) == n
        out = ns_update(x0, u, a[i], w)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ns_update_ref(x0, u, a[i], w).float(),
                                   atol=TOL[dtype] * (i + 1), rtol=TOL[dtype])


def test_ns_update_refuses_non_f32_coefficients_on_the_card(dev):
    rng = np.random.default_rng(6)
    x0, u = _randn(rng, (2, 64), torch.float32, dev), _randn(rng, (3, 2, 64), torch.float32, dev)
    a, w = _randn(rng, (), torch.float32, dev), _randn(rng, (3,), torch.float32, dev)
    before = nu_mod.COUNTER.launches
    for args in ((a.double(), w), (a, w.bfloat16())):
        with pytest.raises(TypeError, match="float32 a and w"):
            ns_update(x0, u, *args)
    assert nu_mod.COUNTER.launches == before


@pytest.mark.parametrize("needs_grad", ["x0", "u", "a", "w"])
def test_fused_ns_update_under_grad_launches_forward_and_backward(dev, needs_grad):
    """Under grad, an input that requires grad goes through NSUpdate: one
    forward launch, and one backward launch when the gradient is taken; the
    gradient matches autograd of the plain version. Under no_grad the same
    inputs launch the forward kernel alone."""
    from repro_torch.kernels.ns_update.ops import fused_ns_update

    rng = np.random.default_rng(7)
    args = {"x0": _randn(rng, (2, 64), torch.float32, dev),
            "u": _randn(rng, (3, 2, 64), torch.float32, dev),
            "a": _randn(rng, (), torch.float32, dev),
            "w": _randn(rng, (3,), torch.float32, dev)}
    args[needs_grad].requires_grad_(True)
    before = (nu_mod.COUNTER.launches, nu_mod.BWD_COUNTER.launches)
    out = fused_ns_update(**args)
    (got,) = torch.autograd.grad(out.square().sum(), args[needs_grad])
    assert (nu_mod.COUNTER.launches, nu_mod.BWD_COUNTER.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    (want,) = torch.autograd.grad(ns_update_ref(**args).square().sum(), args[needs_grad])
    torch.testing.assert_close(got, want, atol=TOL[torch.float32] * 2 * 64,
                               rtol=TOL[torch.float32] * 3)
    with torch.no_grad():
        out = fused_ns_update(**args)
    assert nu_mod.COUNTER.launches == before[0] + 2
    torch.testing.assert_close(out, ns_update_ref(**args).detach(), atol=TOL[torch.float32] * 3,
                               rtol=TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,B,D", [(1, 4, 65536), (8, 4, 65536), (20, 3, 1000), (3, 1, 7),
                                   (64, 2, 4096), (2, 16, 131072)])
@pytest.mark.parametrize("need_x0", [True, False])
def test_ns_update_bwd_matches_plain(dev, n, B, D, dtype, need_x0):
    """dU and dx0 one f32 product each (TOL); da and dw f32 sums over B*D
    products, held to TOL times the sum of their magnitudes."""
    from repro_torch.kernels.ns_update.ns_update import ns_update_bwd
    from repro_torch.kernels.ns_update.ref import ns_update_bwd_ref

    rng = np.random.default_rng(n + B + D)
    x0, g = _randn(rng, (B, D), dtype, dev), _randn(rng, (B, D), dtype, dev)
    u = _randn(rng, (n, B, D), dtype, dev)
    a, w = _randn(rng, (), torch.float32, dev), _randn(rng, (n,), torch.float32, dev)
    before = nu_mod.BWD_COUNTER.launches
    got = ns_update_bwd(g, x0, u, a, w, need_x0=need_x0)
    torch.cuda.synchronize()
    assert nu_mod.BWD_COUNTER.launches == before + 1
    want = ns_update_bwd_ref(g, x0, u, a, w, need_x0=need_x0)
    assert (got[0] is None) == (not need_x0)
    for x, r in zip(got[:2], want[:2]):
        if r is not None:
            assert x.dtype == r.dtype and x.shape == r.shape
            torch.testing.assert_close(x.float(), r.float(), atol=TOL[dtype], rtol=TOL[dtype])
    scale = torch.cat([(x0.float() * g.float()).abs().sum().reshape(1),
                       torch.tensordot(u.float().abs(), g.float().abs(), dims=2)])
    err = (torch.cat([got[2].reshape(1), got[3]]) - torch.cat([want[2].reshape(1), want[3]]))
    assert float((err.abs() / (TOL[torch.float32] * scale)).max()) <= 1
    assert got[2].shape == a.shape and got[3].shape == w.shape


def test_ns_update_bwd_is_deterministic_across_shapes(dev):
    """Two runs give the same bits (a fixed-order reduction, no float
    atomics), also after a call of another shape (the arrival counter is
    back at 0 after every call)."""
    from repro_torch.kernels.ns_update.ns_update import ns_update_bwd

    rng = np.random.default_rng(9)
    big = [_randn(rng, s, torch.float32, dev) for s in ((4, 65536), (4, 65536), (8, 4, 65536))]
    small = [_randn(rng, s, torch.float32, dev) for s in ((3, 100), (3, 100), (2, 3, 100))]
    a, w8, w2 = (_randn(rng, s, torch.float32, dev) for s in ((), (8,), (2,)))
    first = ns_update_bwd(*big, a, w8)
    ns_update_bwd(*small, a, w2)
    again = ns_update_bwd(*big, a, w8)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("need_x0", [True, False])
def test_ns_update_bwd_graphed_equals_eager(dev, dtype, need_x0):
    """A call replayed from a CUDA graph gives the eager call's bits, at the
    main path's shape (k = 8 of B=4 x D=65536) and the ragged k = 20 one."""
    from repro_torch.kernels.ns_update.ns_update import ns_update_bwd

    rng = np.random.default_rng(11)
    for n, B, D in ((8, 4, 65536), (20, 3, 1000)):
        x0, g = _randn(rng, (B, D), dtype, dev), _randn(rng, (B, D), dtype, dev)
        u = _randn(rng, (n, B, D), dtype, dev)
        a, w = _randn(rng, (), torch.float32, dev), _randn(rng, (n,), torch.float32, dev)
        eager = ns_update_bwd(g, x0, u, a, w, need_x0=need_x0)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            graphed = ns_update_bwd(g, x0, u, a, w, need_x0=need_x0)
        graph.replay()
        torch.cuda.synchronize()
        for x, y in zip(eager, graphed):
            assert (x is None and y is None) or torch.equal(x, y)


def _check_flash_bf16(out, ref):
    torch.testing.assert_close(out.float(), ref.float(), atol=FLASH_BF16_ATOL,
                               rtol=FLASH_BF16_RTOL)
    ref = ref.float()
    row_err = (torch.linalg.vector_norm(out.float() - ref, dim=-1)
               / torch.linalg.vector_norm(ref, dim=-1))
    assert float(row_err.max()) <= FLASH_BF16_ROW_REL_L2


@pytest.mark.parametrize("B,H,KV,L,hd,causal", [
    (2, 8, 2, 512, 64, True),      # hd 64, L a multiple of the 128-row tiles
    (2, 8, 2, 512, 80, True),      # hd 80: 16-column chunks, 32-byte swizzle
    (2, 8, 2, 512, 128, True),
    (2, 8, 8, 384, 64, False),     # G 1, full
    (2, 8, 8, 384, 80, False),
    (1, 16, 2, 384, 128, False),   # G 8, full
    (1, 16, 2, 200, 64, True),     # ragged L, two query tiles
    (1, 16, 2, 129, 80, True),     # one row past a tile
    (2, 8, 1, 1000, 128, True),    # G 8, ragged L
    (1, 8, 1, 1000, 128, False),
    (1, 8, 2, 1, 64, True),        # one position
    (1, 8, 2, 1, 80, False),
    (2, 4, 4, 1, 128, False),
    (1, 4, 2, 127, 128, True),     # one short of a tile
])
def test_flash_attention_bf16_tiles_and_heads(dev, B, H, KV, L, hd, causal):
    """The TMA + wgmma kernel on transposed views of the model's (B, L, heads,
    hd) layout, as attention_forward hands them over."""
    rng = np.random.default_rng(B * 1000 + H + L + hd)
    q = _randn(rng, (B, L, H, hd), torch.bfloat16, dev).transpose(1, 2)
    k = _randn(rng, (B, L, KV, hd), torch.bfloat16, dev).transpose(1, 2)
    v = _randn(rng, (B, L, KV, hd), torch.bfloat16, dev).transpose(1, 2)
    before = fa_mod.COUNTER.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_mod.COUNTER.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _check_flash_bf16(out, attention_ref(q, k, v, causal=causal))


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
    _check_flash_bf16(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk", [(1024, 1500), (1, 1500), (37, 300), (300, 37)])
def test_flash_attention_cross_attention_lq_ne_lk(dev, Lq, Lk, dtype):
    """whisper-medium's cross-attention: 16 query and 16 KV heads of 64,
    non-causal, queries over a memory of another length (Lq 1 in decode),
    K and V projected from the memory, through ``attend`` as the model calls it."""
    rng = np.random.default_rng(Lq + Lk)
    q = _randn(rng, (2, Lq, 16, 64), dtype, dev)
    k, v = (_randn(rng, (2, Lk, 16, 64), dtype, dev) for _ in "kv")
    before = fa_mod.COUNTER.launches
    out = attend(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa_mod.COUNTER.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    out = out.transpose(1, 2)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=False)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=TOL[dtype] * 4, rtol=TOL[dtype] * 4)
        return
    _check_flash_bf16(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L", [(4, 1024), (2, 300)])
def test_flash_attention_at_zamba2_heads(dev, B, L, dtype):
    """zamba2-2.7b's shared attention: 32 query and 32 KV heads of 80 (G 1),
    causal, on transposed views of the model's layout (row stride 32 x 80),
    at the flow cell's (4, 1024) and a ragged L."""
    rng = np.random.default_rng(B + L)
    q, k, v = (_randn(rng, (B, L, 32, 80), dtype, dev).transpose(1, 2) for _ in "qkv")
    before = fa_mod.COUNTER.launches
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True)
    torch.cuda.synchronize()
    assert fa_mod.COUNTER.launches == before + 1
    out = out.transpose(1, 2)
    ref = attention_ref(q, k, v, causal=True)
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=TOL[dtype] * 4, rtol=TOL[dtype] * 4)
        return
    _check_flash_bf16(out, ref)


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
    (8, 4, 16, 128, 16, 16),    # G=16: qwen3-moe-235b-a22b's 64 over 4 heads
    (3, 2, 12, 32, 4, 5),       # G=12, the 16-row kernels' partial rows
    (2, 1, 16, 80, 16, 64),     # G=16, hd=80, split rows
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


_LONG_LENGTHS = [4096, 3001, 2048, 1, 777, 4095, 1500, 3333]   # chip_smoke.py phase 3


def _paged_case(seed, B, KV, G, hd, ps, nb, q_dtype, page_dtype, dev, lengths):
    q, k, v, table, _ = _paged_inputs(seed, B, KV, G, hd, ps, nb, q_dtype, page_dtype, dev)
    return q, k[0], v[0], table, torch.tensor(lengths, dtype=torch.int32, device=dev)


def _check_paged_rows(out, q, k, v, table, lengths):
    """Rows of length >= 1 against the plain version; a row of length 0
    gives zeros, as the TPU kernel's does (the dense plain version averages
    over the masked positions there)."""
    from repro_torch.kernels.flash_attention.ref import paged_attention_ref

    ref = paged_attention_ref(q, k, v, table, lengths)
    nz = lengths > 0
    _check_paged(out[nz], ref[nz])
    assert bool((out[~nz] == 0).all())


@pytest.mark.parametrize("q_dtype,page_dtype", _PAGED_DTYPES, ids=str)
def test_paged_attention_long_ragged_rows(dev, q_dtype, page_dtype):
    """Rows of up to 4096 positions (16 splits of 16 pages on the H100),
    one of them a single position."""
    from repro_torch.kernels.flash_attention.paged_attention import paged_attention

    args = _paged_case(11, 8, 4, 8, 128, 16, 256, q_dtype, page_dtype, dev, _LONG_LENGTHS)
    _check_paged_rows(paged_attention(*args), *args)


@pytest.mark.parametrize("nb", [16, 64, 256])
def test_paged_attention_lengths_at_split_boundaries(dev, nb):
    """Every length k * span - 1, k * span, k * span + 1 for the span of
    positions a split covers under the plan the wrapper picks on this card,
    beside lengths 0 and nb * page_size."""
    from repro_torch.kernels.flash_attention import paged_attention as pa_mod

    KV, G, hd, ps = 4, 8, 128, 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lengths = [0, nb * ps]
    pps, splits, _ = pa_mod.split_plan(8, KV, nb, ps, sms)
    span = pps * ps
    lengths += [k * span + d for k in range(1, splits + 1) for d in (-1, 0, 1)
                if 1 <= k * span + d <= nb * ps]
    for f32_pages in (True, False):
        page_dtype = torch.float32 if f32_pages else torch.bfloat16
        for i in range(0, len(lengths), 8):
            rows = (lengths[i:i + 8] + [1] * 8)[:8]
            args = _paged_case(nb + i, 8, KV, G, hd, ps, nb, torch.bfloat16, page_dtype,
                               dev, rows)
            _check_paged_rows(pa_mod.paged_attention(*args), *args)


@pytest.mark.parametrize("q_dtype,page_dtype", _PAGED_DTYPES, ids=str)
def test_paged_attention_empty_rows_beside_full_rows(dev, q_dtype, page_dtype):
    from repro_torch.kernels.flash_attention.paged_attention import paged_attention

    nb, ps = 32, 16
    args = _paged_case(5, 6, 4, 8, 128, ps, nb, q_dtype, page_dtype, dev,
                       [0, nb * ps, 0, nb * ps, nb * ps + 7, 0])
    _check_paged_rows(paged_attention(*args), *args)


@pytest.mark.parametrize("q_dtype,page_dtype", _PAGED_DTYPES, ids=str)
@pytest.mark.parametrize("hd", [32, 64, 80, 128])
@pytest.mark.parametrize("G", list(range(1, 9)))
def test_paged_attention_every_type_pair_head_dim_and_group(dev, G, hd, q_dtype,
                                                            page_dtype):
    from repro_torch.kernels.flash_attention.paged_attention import paged_attention

    args = _paged_case(G * 1000 + hd, 4, 2, G, hd, 16, 24, q_dtype, page_dtype, dev,
                       [384, 1, 200, 17])
    _check_paged_rows(paged_attention(*args), *args)


def test_paged_attention_counters_reset_between_calls_of_different_shapes(dev):
    """Back-to-back calls of two shapes (different rows, heads and splits)
    on one workspace: each output matches the plain version, a repeat is
    bit-identical, and every arrival counter is back at 0."""
    from repro_torch.kernels.flash_attention import paged_attention as pa_mod

    a = _paged_case(1, 8, 4, 8, 128, 16, 64, torch.bfloat16, torch.float32, dev,
                    [1024, 900, 17, 1, 512, 513, 33, 1000])
    b = _paged_case(2, 3, 2, 4, 64, 8, 40, torch.float32, torch.float32, dev,
                    [320, 9, 100])
    outs = [pa_mod.paged_attention(*args) for args in (a, b, a, b)]
    torch.cuda.synchronize()
    for out, args in zip(outs, (a, b, a, b)):
        _check_paged_rows(out, *args)
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    assert not bool(pa_mod._DEVICES[dev.index or 0].counters.any())


def test_paged_attention_poisoned_tails_over_many_splits(dev):
    """Garbage (+-1e4) in each row's own pages past its length, with rows
    that end inside a split, on a split boundary and inside a page."""
    from repro_torch.kernels.flash_attention.paged_attention import paged_attention

    nb, ps = 128, 16
    lengths = [5, 16, 257, 1024, 2047, 1, 1500, 777]
    q, k, v, table, lens = _paged_case(9, 8, 4, 8, 128, ps, nb, torch.bfloat16,
                                       torch.float32, dev, lengths)
    base = paged_attention(q, k, v, table, lens)
    for row, n in enumerate(lengths):
        pos = torch.arange(n, nb * ps, device=dev)
        page, off = table[row, pos // ps].long(), pos % ps
        sign = (pos % 2 * 2 - 1).to(k.dtype)[:, None, None]
        k[page, off] = 1e4 * sign
        v[page, off] = -1e4 * sign
    poisoned = paged_attention(q, k, v, table, lens)
    torch.testing.assert_close(poisoned, base, atol=0, rtol=0)
    _check_paged_rows(poisoned, q, k, v, table, lens)


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


# ---------------------------------------------------------------------------
# gla_scan: the gated linear recurrence against its step-by-step oracle
# ---------------------------------------------------------------------------


def _gla_inputs(seed, B, L, H, dk, dv, dtype, ld_dtype, dev, scale=0.5, ld_dk=None):
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, L, H, dk), dtype, dev)
    k = _randn(rng, (B, L, H, dk), dtype, dev)
    v = _randn(rng, (B, L, H, dv), dtype, dev)
    ld = -(_randn(rng, (B, L, H, ld_dk or dk), torch.float32, dev).abs() * scale)
    return q, k, v, ld.to(ld_dtype)


def _oracle(q, k, v, ld, s0=None, *, inclusive):
    from repro_torch.kernels.gla_scan.ref import gla_ref

    return gla_ref(*(t.double() for t in (q, k, v, ld)),
                   None if s0 is None else s0.double(), inclusive=inclusive)


def _check_gla(out, ref, dtype, atol=None):
    (o, s), (o_ref, s_ref) = out, ref
    assert o.dtype == dtype and o.shape == o_ref.shape
    assert s.dtype == torch.float32 and s.shape == s_ref.shape
    atol = TOL[dtype] * 20 if atol is None else atol
    torch.testing.assert_close(o.double(), o_ref.double(), atol=atol, rtol=TOL[dtype])
    torch.testing.assert_close(s.double(), s_ref.double(), atol=atol, rtol=TOL[dtype])


_GLA_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("dtype,ld_dtype", _GLA_DTYPES, ids=str)
@pytest.mark.parametrize("L,chunk,inclusive,dk,dv", [
    (128, 32, True, 64, 64),     # tests/test_kernels.py sweep: mamba2-style
    (128, 32, False, 64, 64),    # rwkv6-style exclusive
    (96, 16, False, 32, 48),     # ragged head dims
    (64, 64, True, 16, 128),     # single chunk
    (1000, 64, False, 64, 64),   # ragged last chunk
    (5, 64, True, 16, 16),       # L below the chunk
    (130, 64, True, 64, 64),     # two positions past the last whole chunk
])
def test_gla_scan_matches_plain(dev, L, chunk, inclusive, dk, dv, dtype, ld_dtype):
    from repro_torch.kernels.gla_scan import gla_scan as gs_mod

    q, k, v, ld = _gla_inputs(L + chunk + dk, 2, L, 3, dk, dv, dtype, ld_dtype, dev)
    before = gs_mod.COUNTER.launches
    out = gs_mod.gla_scan(q, k, v, ld, inclusive=inclusive, chunk=chunk)
    torch.cuda.synchronize()
    assert gs_mod.COUNTER.launches == before + 1
    _check_gla(out, _oracle(q, k, v, ld, inclusive=inclusive), dtype)


@pytest.mark.parametrize("dtype,L,dk,dv,chunk,want", [
    (torch.bfloat16, 1024, 64, 64, 64, "tensor-core"),    # rwkv6-7b's time mix
    (torch.bfloat16, 256, 32, 96, 64, "tensor-core"),
    (torch.bfloat16, 96, 16, 128, 16, "tensor-core"),
    (torch.bfloat16, 128, 128, 128, 32, "tensor-core"),
    (torch.float32, 1024, 64, 64, 64, "CUDA-core"),       # f32: by type
    (torch.bfloat16, 1024, 64, 72, 64, "CUDA-core"),      # dv not a multiple of 16
    (torch.bfloat16, 1024, 144, 64, 64, "CUDA-core"),     # dk past 128
    (torch.bfloat16, 1024, 64, 64, 8, "CUDA-core"),       # chunk not 16, 32 or 64
    (torch.bfloat16, 40, 64, 64, 64, "CUDA-core"),        # chunk cut to L = 40
])
def test_gla_scan_selects_its_kernel_by_type_and_shape(dev, dtype, L, dk, dv, chunk, want):
    """The C library's selection rule, as the source note states it; both
    kernels agree with the oracle at a short L of the same sizes."""
    from repro_torch.kernels.gla_scan.gla_scan import gla_scan, kernel_for

    assert kernel_for(dtype, L, dk, dv, chunk) == want
    L = min(L, 80)
    q, k, v, ld = _gla_inputs(dk + dv, 1, L, 2, dk, dv, dtype, torch.float32, dev)
    assert kernel_for(dtype, L, dk, dv, chunk) == want
    _check_gla(gla_scan(q, k, v, ld, inclusive=False, chunk=chunk),
               _oracle(q, k, v, ld, inclusive=False), dtype)


@pytest.mark.parametrize("ld_dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("L,chunk,inclusive,dk,dv", [
    (256, 64, False, 64, 64),    # rwkv6-style, four sub-chunks a chunk
    (200, 32, True, 48, 80),     # dk != dv, ragged tail
    (80, 16, False, 128, 32),    # one sub-chunk a chunk
    (64, 64, True, 128, 128),    # the largest tile
])
def test_gla_scan_tensor_core_kernel_with_s0_and_strong_decay(dev, L, chunk, inclusive, dk,
                                                              dv, ld_dtype):
    """The tensor-core kernel with an initial state, and under strong decay
    (ld x30: factors underflow to 0, never overflow), against the f64
    oracle."""
    from repro_torch.kernels.gla_scan.gla_scan import gla_scan, kernel_for

    bf16 = torch.bfloat16
    assert kernel_for(bf16, L, dk, dv, chunk) == "tensor-core"
    q, k, v, ld = _gla_inputs(L + dk, 2, L, 3, dk, dv, bf16, ld_dtype, dev)
    s0 = _randn(np.random.default_rng(L), (2, 3, dk, dv), torch.float32, dev)
    _check_gla(gla_scan(q, k, v, ld, s0, inclusive=inclusive, chunk=chunk),
               _oracle(q, k, v, ld, s0, inclusive=inclusive), bf16)
    q, k, v, ld = _gla_inputs(L + dv, 1, L, 2, dk, dv, bf16, ld_dtype, dev, scale=30.0)
    o, s = gla_scan(q, k, v, ld, inclusive=inclusive, chunk=chunk)
    assert bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(s).all())
    _check_gla((o, s), _oracle(q, k, v, ld, inclusive=inclusive), bf16,
               atol=max(1e-3, TOL[bf16] * 20))


@pytest.mark.parametrize("inclusive", [True, False])
def test_gla_scan_initial_state_and_scalar_decay(dev, inclusive):
    """A given s0 composes as the state carry does; one decay per head (ld's
    last dim 1, read with a stride of 0) equals the decay broadcast to dk."""
    from repro_torch.kernels.gla_scan.gla_scan import gla_scan

    f32 = torch.float32
    q, k, v, ld = _gla_inputs(3, 2, 200, 4, 64, 64, f32, f32, dev, ld_dk=1)
    s0 = _randn(np.random.default_rng(4), (2, 4, 64, 64), f32, dev)
    got = gla_scan(q, k, v, ld, s0, inclusive=inclusive, chunk=64)
    _check_gla(got, _oracle(q, k, v, ld, s0, inclusive=inclusive), f32)
    wide = gla_scan(q, k, v, ld.expand(-1, -1, -1, 64).contiguous(), s0,
                    inclusive=inclusive, chunk=64)
    torch.testing.assert_close(got, wide, atol=0, rtol=0)
    first = gla_scan(q[:, :128], k[:, :128], v[:, :128], ld[:, :128], s0,
                     inclusive=inclusive, chunk=64)
    second = gla_scan(q[:, 128:], k[:, 128:], v[:, 128:], ld[:, 128:], first[1],
                      inclusive=inclusive, chunk=64)
    _check_gla((torch.cat([first[0], second[0]], dim=1), second[1]), got, f32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_scan_strong_decay_finite(dev, dtype):
    """ld x30 (tests/test_kernels.py): within a 32-position chunk e^{-cum}
    would reach e^{+960}; the kernel's exponents stay <= 0."""
    from repro_torch.kernels.gla_scan.gla_scan import gla_scan

    q, k, v, ld = _gla_inputs(1, 1, 128, 2, 16, 16, dtype, torch.float32, dev, scale=30.0)
    o, s = gla_scan(q, k, v, ld, inclusive=False, chunk=32)
    assert bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(s).all())
    _check_gla((o, s), _oracle(q, k, v, ld, inclusive=False), dtype,
               atol=max(1e-3, TOL[dtype] * 20))


def test_gla_scan_reads_model_layout_in_place(dev):
    """r, k, v as (B, L, H, 64) views of (B, L, d) products, and a strided
    (non-contiguous) view: read through their strides, same result."""
    from repro_torch.kernels.gla_scan.gla_scan import gla_scan

    rng = np.random.default_rng(9)
    B, L, H = 2, 150, 4
    x = _randn(rng, (B, L, 3 * H * 64), torch.bfloat16, dev)
    q, k, v = (x[..., i * H * 64:(i + 1) * H * 64].reshape(B, L, H, 64) for i in range(3))
    assert not q.is_contiguous()
    ld = -(_randn(rng, (B, H, L, 64), torch.float32, dev).abs() * 0.1).transpose(1, 2)
    got = gla_scan(q, k, v, ld, inclusive=False, chunk=64)
    _check_gla(got, _oracle(q, k, v, ld, inclusive=False), torch.bfloat16)
    same = gla_scan(q.contiguous(), k.contiguous(), v.contiguous(), ld.contiguous(),
                    inclusive=False, chunk=64)
    torch.testing.assert_close(got, same, atol=0, rtol=0)


@pytest.mark.parametrize("B,L,H,ds,hd,chunk", [
    (4, 1024, 80, 64, 64, 64),   # zamba2-2.7b's SSD at the flow cell
    (2, 200, 8, 16, 32, 16),     # its smoke config, a ragged last chunk
])
def test_gla_scan_mamba2_form(dev, B, L, H, ds, hd, chunk):
    """The Mamba2 form, as models/mamba2.py::_ssd hands it over: q and k one
    B/C group broadcast over the heads (views with a stride of 0 on h into a
    (B, L, conv_dim) product), one f32 decay a head (ld's last dim 1),
    inclusive; against the f64 oracle, and to the bit against the same
    values materialised contiguous."""
    from repro_torch.kernels.gla_scan import gla_scan as gs_mod
    from repro_torch.kernels.gla_scan.ops import gla

    rng = np.random.default_rng(L + H)
    bf16 = torch.bfloat16
    xbc = _randn(rng, (B, L, H * hd + 2 * ds), bf16, dev)
    k = xbc[..., H * hd:H * hd + ds][:, :, None, :].expand(B, L, H, ds)
    q = xbc[..., H * hd + ds:][:, :, None, :].expand(B, L, H, ds)
    assert q.stride(2) == 0 and k.stride(2) == 0
    v = _randn(rng, (B, L, H, hd), bf16, dev)
    dt = torch.nn.functional.softplus(_randn(rng, (B, L, H), torch.float32, dev) - 2.0)
    ld = (dt * -torch.exp(_randn(rng, (H,), torch.float32, dev) * 0.5))[..., None]
    assert gs_mod.kernel_for(bf16, L, ds, hd, chunk) == "tensor-core"
    before = gs_mod.COUNTER.launches
    got = gla(q, k, v, ld, inclusive=True, chunk=chunk)
    torch.cuda.synchronize()
    assert gs_mod.COUNTER.launches == before + 1
    _check_gla(got, _oracle(q, k, v, ld, inclusive=True), bf16)
    same = gs_mod.gla_scan(q.contiguous(), k.contiguous(), v,
                           ld.expand(B, L, H, ds).contiguous(), inclusive=True, chunk=chunk)
    torch.testing.assert_close(got, same, atol=0, rtol=0)


def test_gla_dispatch_launches_the_kernel_on_the_card(dev):
    from repro_torch.kernels.gla_scan import gla_scan as gs_mod
    from repro_torch.kernels.gla_scan.ops import gla

    q, k, v, ld = _gla_inputs(2, 1, 70, 2, 64, 64, torch.float32, torch.float32, dev)
    before = gs_mod.COUNTER.launches
    o, s = gla(q, k, v, ld, inclusive=False, chunk=64)
    assert gs_mod.COUNTER.launches == before + 1
    assert o.is_cuda and s.is_cuda


def test_gla_scan_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels.gla_scan.gla_scan import gla_scan

    q, k, v, ld = _gla_inputs(0, 1, 64, 2, 64, 64, torch.float32, torch.float32, dev)
    with pytest.raises(TypeError):
        gla_scan(q.half(), k.half(), v.half(), ld)
    with pytest.raises(TypeError):
        gla_scan(q, k, v.bfloat16(), ld)
    with pytest.raises(ValueError, match="shape"):
        gla_scan(q, k, v, ld[..., :3])
    with pytest.raises(ValueError, match="s0"):
        gla_scan(q, k, v, ld, torch.zeros(1, 2, 64, 32, device=dev))
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 64, 1, 512, device=dev)
        gla_scan(big, big, big, big)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gla_scan(q.cpu(), k.cpu(), v.cpu(), ld.cpu())


# ---------------------------------------------------------------------------
# flash attention under grad: the forward's log-sum-exp and the backward
# ---------------------------------------------------------------------------


def _check_flash_bwd(out, ref, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=TOL[dtype] * 4, rtol=TOL[dtype] * 4)
        return
    ref = ref.float()
    err = (out.float() - ref).abs()
    assert float((err / (FLASH_BWD_ATOL + FLASH_BWD_RTOL * ref.abs())).max()) <= 1
    floor = FLASH_BWD_ATOL * ref.shape[-1] ** 0.5
    row = (torch.linalg.vector_norm(err, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1).clamp_min(floor))
    assert float(row.max()) <= FLASH_BWD_ROW_REL_L2


def _bwd_inputs(seed, B, H, KV, Lq, Lk, dtype, dev, hd=128):
    rng = np.random.default_rng(seed)
    # transposed views of the model's (B, L, heads, hd) layout
    q, do = (_randn(rng, (B, Lq, H, hd), dtype, dev).transpose(1, 2) for _ in "qo")
    k, v = (_randn(rng, (B, Lk, KV, hd), dtype, dev).transpose(1, 2) for _ in "kv")
    return q, k, v, do


_BWD_SHAPES = [  # B, H, KV, Lq, Lk, causal
    (4, 32, 4, 1024, 1024, True),   # the flow cell
    (2, 8, 2, 77, 77, True),
    (2, 8, 2, 77, 77, False),
    (1, 4, 4, 33, 33, True),        # G 1
    (1, 16, 2, 200, 200, False),    # G 8
    (2, 8, 1, 1000, 1000, True),    # ragged L
    (1, 4, 2, 1, 1, True),          # one position
    (1, 4, 2, 40, 97, False),       # Lq != Lk
    (1, 4, 2, 50, 70, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,Lq,Lk,causal", _BWD_SHAPES)
def test_flash_attention_lse_matches_plain(dev, B, H, KV, Lq, Lk, causal, dtype):
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref

    q, k, v, _ = _bwd_inputs(Lq + H, B, H, KV, Lq, Lk, dtype, dev)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    assert lse.shape == (B, H, Lq) and lse.dtype == torch.float32 and lse.is_contiguous()
    ref = attention_lse_ref(q, k, causal=causal)
    torch.testing.assert_close(lse, ref, atol=TOL[torch.float32] * 4,
                               rtol=TOL[torch.float32] * 4)
    assert torch.equal(o, flash_attention(q, k, v, causal=causal))  # same output either way


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,Lq,Lk,causal", _BWD_SHAPES)
def test_flash_attention_bwd_matches_plain(dev, B, H, KV, Lq, Lk, causal, dtype):
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    q, k, v, do = _bwd_inputs(Lq + Lk + H, B, H, KV, Lq, Lk, dtype, dev)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    before = fa_mod.BWD_COUNTER.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa_mod.BWD_COUNTER.launches == before + 1
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for x, r, like in zip(got, want, (q, k, v)):
        assert x.shape == like.shape and x.dtype == dtype
        _check_flash_bwd(x, r, dtype)


_BWD_HD_SHAPES = [  # B, H, KV, Lq, Lk, causal, hd
    (4, 32, 32, 1024, 1024, True, 80),   # zamba2-2.7b's shared attention
    (4, 16, 16, 1024, 1024, True, 64),   # whisper-medium's decoder self-attention
    (4, 16, 16, 1024, 1500, False, 64),  # its cross-attention
    (2, 8, 2, 77, 77, True, 80),
    (1, 4, 2, 40, 97, False, 80),
    (2, 8, 1, 100, 100, False, 64),
    # the tensor-core path's edges in bf16: ragged L, GQA 8 / 2, Lq != Lk both ways
    (2, 16, 16, 1000, 1000, True, 64),
    (2, 16, 16, 1000, 1000, True, 80),
    (2, 8, 2, 333, 333, True, 64),
    (2, 8, 2, 333, 333, True, 80),
    (1, 8, 4, 200, 77, False, 64),
    (1, 8, 4, 200, 77, False, 80),
    (1, 4, 2, 40, 97, False, 64),
    (2, 8, 2, 300, 450, True, 80),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,Lq,Lk,causal,hd", _BWD_HD_SHAPES)
def test_flash_attention_bwd_at_hd_64_and_80_matches_plain(dev, B, H, KV, Lq, Lk, causal, hd,
                                                          dtype):
    """The backward at the head dims of zamba2-2.7b and whisper-medium
    (bf16 on the tensor cores, f32 on the CUDA cores), with the forward's
    lse, and its dq pass alone."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_lse_ref

    q, k, v, do = _bwd_inputs(Lq + Lk + hd, B, H, KV, Lq, Lk, dtype, dev, hd=hd)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.testing.assert_close(lse, attention_lse_ref(q, k, causal=causal),
                               atol=TOL[torch.float32] * 4, rtol=TOL[torch.float32] * 4)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for x, r, like in zip(got, want, (q, k, v)):
        assert x.shape == like.shape and x.dtype == dtype
        _check_flash_bwd(x, r, dtype)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, dkdv=False)
    assert dk is None and dv is None and torch.equal(dq, got[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 80, 128])
def test_flash_attention_bwd_is_deterministic(dev, dtype, hd):
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bwd

    q, k, v, do = _bwd_inputs(1, 2, 16, 2, 300, 300, dtype, dev, hd=hd)
    o, lse = flash_attention(q, k, v, return_lse=True)
    first = flash_attention_bwd(q, k, v, o, lse, do)
    again = flash_attention_bwd(q, k, v, o, lse, do)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("causal", [True, False])
def test_attend_gradient_through_the_kernels_matches_autograd_of_the_plain_version(dev, causal):
    """The FlashAttention Function in f32 (a gradcheck-style comparison): the
    gradient of a scalar of attend's output through the kernels (forward with
    lse, backward) against autograd of the plain version, on the card; the
    forward and backward kernels launch once each, the plain version never."""
    B, L, H, KV = 2, 150, 8, 2
    rng = np.random.default_rng(12)
    q = _randn(rng, (B, L, H, 128), torch.float32, dev).requires_grad_(True)
    k = _randn(rng, (B, L, KV, 128), torch.float32, dev).requires_grad_(True)
    v = _randn(rng, (B, L, KV, 128), torch.float32, dev).requires_grad_(True)
    weight = _randn(rng, (B, L, H, 128), torch.float32, dev)
    before = (fa_mod.COUNTER.launches, fa_mod.BWD_COUNTER.launches)
    out = attend(q, k, v, causal=causal)
    assert type(out.grad_fn).__name__ == "TransposeBackward0"
    got = torch.autograd.grad((out * weight).sum(), (q, k, v))
    assert (fa_mod.COUNTER.launches, fa_mod.BWD_COUNTER.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal).transpose(1, 2)
    want = torch.autograd.grad((ref * weight).sum(), (q, k, v))
    for x, r in zip(got, want):
        torch.testing.assert_close(x, r, atol=TOL[torch.float32] * 4, rtol=TOL[torch.float32] * 4)
    with torch.no_grad():
        attend(q, k, v, causal=causal)
    assert (fa_mod.COUNTER.launches, fa_mod.BWD_COUNTER.launches) == (before[0] + 2,
                                                                      before[1] + 1)


def test_flash_attention_bwd_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bwd

    q = torch.zeros(1, 2, 16, 32, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 16, device=dev), q)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q, return_lse=True)
    q = torch.zeros(1, 2, 16, 128, device=dev)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 8, device=dev), q)
    with pytest.raises(ValueError, match="do must be like q"):
        flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 16, device=dev), q.bfloat16())


def _relative_l2(got, want):
    return float(torch.linalg.vector_norm(got.double() - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


# f32 inputs 1e-5, bf16 2e-2, a gradient kept in f32 for bf16 inputs (dld of
# an f32 ld, ds0) 1e-3 (chip_smoke.py's limits), relative L2 against the
# plain backward taken in f64 on the same inputs
GLA_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _gla_bwd_limit(qkv_dtype, out_dtype):
    if qkv_dtype == torch.bfloat16 and out_dtype == torch.float32:
        return 1e-3
    return GLA_BWD_TOL[qkv_dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["exclusive", "inclusive", "group"])
@pytest.mark.parametrize("B,L,H,dk,dv,chunk,state", [
    (2, 200, 4, 64, 64, 64, True),    # a ragged last chunk, s0 and dS_final
    (1, 128, 2, 32, 16, 32, False),
    (4, 1024, 8, 64, 64, 64, False),
])
def test_gla_scan_bwd_matches_plain(dev, B, L, H, dk, dv, chunk, state, form, dtype):
    """The backward kernel against ``gla_chunked_bwd`` in f64 on the same
    inputs: rwkv6's exclusive form (per-channel decay), the inclusive form,
    and zamba2's (inclusive, q and k one group, one decay a head). bf16 runs
    the tensor-core kernel at these sizes, f32 the CUDA-core one."""
    from repro_torch.kernels.gla_scan import gla_scan as gs_mod
    from repro_torch.kernels.gla_scan.ref import gla_chunked_bwd

    want_kernel = "tensor-core" if dtype == torch.bfloat16 else "CUDA-core"
    assert gs_mod.bwd_kernel_for(dtype, L, dk, dv, chunk) == want_kernel
    rng = np.random.default_rng(L + H + dk)
    group = form == "group"
    Hq = 1 if group else H
    q, k = (_randn(rng, (B, L, Hq, dk), dtype, dev) for _ in "qk")
    v, do = (_randn(rng, (B, L, H, dv), dtype, dev) for _ in "vo")
    ld = -(_randn(rng, (B, L, H, 1 if group else dk), torch.float32, dev).abs() * 0.3)
    s0, dS = ((_randn(rng, (B, H, dk, dv), torch.float32, dev) for _ in "sd") if state
              else (None, None))
    inclusive = form != "exclusive"
    before = gs_mod.BWD_COUNTER.launches
    got = gs_mod.gla_scan_bwd(q, k, v, ld, s0, do, dS, inclusive=inclusive, chunk=chunk)
    torch.cuda.synchronize()
    assert gs_mod.BWD_COUNTER.launches == before + 1
    f64 = lambda t: None if t is None else t.double()  # noqa: E731
    want = gla_chunked_bwd(*map(f64, (q, k, v, ld, s0, do, dS)), inclusive=inclusive,
                           chunk=chunk)
    for g, w, like in zip(got, want, (q, k, v, ld, s0)):
        if like is None:
            assert g is None
            continue
        assert g.shape == like.shape and g.dtype == like.dtype
        assert _relative_l2(g, w) <= _gla_bwd_limit(dtype, g.dtype)
    again = gs_mod.gla_scan_bwd(q, k, v, ld, s0, do, dS, inclusive=inclusive, chunk=chunk)
    for g, a in zip(got, again):
        assert (g is None and a is None) or torch.equal(g, a)


@pytest.mark.parametrize("form", ["exclusive", "inclusive", "group"])
def test_gla_scan_bwd_strong_decay_on_the_tensor_cores(dev, form):
    """Strong decay (x30: most factors underflow) in bf16 on the tensor-core
    kernel, a ragged tail, s0 and dS_final: finite, within the bf16 limit of
    ``gla_chunked_bwd`` in f64, and bit-equal on a rerun."""
    from repro_torch.kernels.gla_scan import gla_scan as gs_mod
    from repro_torch.kernels.gla_scan.ref import gla_chunked_bwd

    B, L, H, dk, dv, chunk = 2, 200, 4, 64, 64, 64
    assert gs_mod.bwd_kernel_for(torch.bfloat16, L, dk, dv, chunk) == "tensor-core"
    rng = np.random.default_rng(30)
    group = form == "group"
    q, k = (_randn(rng, (B, L, 1 if group else H, dk), torch.bfloat16, dev) for _ in "qk")
    v, do = (_randn(rng, (B, L, H, dv), torch.bfloat16, dev) for _ in "vo")
    ld = -(_randn(rng, (B, L, H, 1 if group else dk), torch.float32, dev).abs() * 30.0)
    s0, dS = (_randn(rng, (B, H, dk, dv), torch.float32, dev) for _ in "sd")
    inclusive = form != "exclusive"
    got = gs_mod.gla_scan_bwd(q, k, v, ld, s0, do, dS, inclusive=inclusive, chunk=chunk)
    want = gla_chunked_bwd(*(t.double() for t in (q, k, v, ld, s0, do, dS)),
                           inclusive=inclusive, chunk=chunk)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g.float()).all())
        assert _relative_l2(g, w) <= _gla_bwd_limit(torch.bfloat16, g.dtype)
    again = gs_mod.gla_scan_bwd(q, k, v, ld, s0, do, dS, inclusive=inclusive, chunk=chunk)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_gla_scan_bwd_refuses_a_plan_past_shared_memory(dev):
    """dk = dv = 128 at a chunk of 64 needs more shared memory a block than
    the card gives, in either kernel: the wrapper raises before a launch."""
    from repro_torch.kernels.gla_scan import gla_scan as gs_mod

    x = torch.zeros((1, 64, 1, 128), dtype=torch.bfloat16, device=dev)
    ld = torch.zeros((1, 64, 1, 128), device=dev)
    before = gs_mod.BWD_COUNTER.launches
    with pytest.raises(ValueError, match="shared memory"):
        gs_mod.gla_scan_bwd(x, x, x, ld, None, x, None, chunk=64)
    assert gs_mod.BWD_COUNTER.launches == before


@pytest.mark.parametrize("needs_grad", ["q", "v", "ld"])
def test_gla_under_grad_launches_the_backward_kernel_on_the_card(dev, needs_grad):
    """Under grad an input that requires grad goes through GLAScan: one
    forward launch, and one backward launch at the backward, whose gradient
    is the plain backward's; under no_grad the forward alone."""
    from repro_torch.kernels.gla_scan import gla_scan as gs_mod
    from repro_torch.kernels.gla_scan.ops import gla
    from repro_torch.kernels.gla_scan.ref import gla_chunked_bwd

    q, k, v, ld = _gla_inputs(3, 1, 64, 2, 64, 64, torch.float32, torch.float32, dev)
    args = {"q": q, "k": k, "v": v, "ld": ld}
    args[needs_grad].requires_grad_(True)
    before = (gs_mod.COUNTER.launches, gs_mod.BWD_COUNTER.launches)
    o, _ = gla(**args, chunk=64)
    do = torch.ones_like(o)
    got, = torch.autograd.grad(o, args[needs_grad], do)
    assert (gs_mod.COUNTER.launches, gs_mod.BWD_COUNTER.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    want = gla_chunked_bwd(q.double(), k.double(), v.double(), ld.double(), None,
                           do.double(), None, chunk=64)["qkvl".index(needs_grad[0])]
    assert _relative_l2(got, want) <= GLA_BWD_TOL[torch.float32]
    with torch.no_grad():
        gla(**args, chunk=64)
    assert (gs_mod.COUNTER.launches, gs_mod.BWD_COUNTER.launches) == (before[0] + 2,
                                                                      before[1] + 1)


# ---------------------------------------------------------------------------
# The mesh path: DTensors through each kernel entry (``kernels.dtensor``)
# ---------------------------------------------------------------------------


@pytest.fixture
def card_mesh(dev):
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(dev)


def _placed(x, mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    return distribute_tensor(x, mesh, [Replicate(), Replicate()], src_data_rank=None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dtensor_ns_update_entry_launches_the_kernel(dev, card_mesh, dtype):
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.ns_update.ops import fused_ns_update

    rng = np.random.default_rng(31)
    x0, u = _randn(rng, (4, 1024, 64), dtype, dev), _randn(rng, (5, 4, 1024, 64), dtype, dev)
    a, w = _randn(rng, (), torch.float32, dev), _randn(rng, (5,), torch.float32, dev)
    before = nu_mod.COUNTER.launches
    out = fused_ns_update(_placed(x0, card_mesh), _placed(u, card_mesh), a, w)
    torch.cuda.synchronize()
    assert isinstance(out, DTensor) and nu_mod.COUNTER.launches == before + 1
    tol = TOL[dtype] * 5
    torch.testing.assert_close(out.to_local().float(), ns_update_ref(x0, u, a, w).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dtensor_attend_entry_launches_the_kernel(dev, card_mesh, dtype):
    from torch.distributed.tensor import DTensor

    rng = np.random.default_rng(32)
    q = _randn(rng, (2, 256, 32, 128), dtype, dev)        # model layout (B, L, H, hd)
    k, v = (_randn(rng, (2, 256, 4, 128), dtype, dev) for _ in range(2))
    before = fa_mod.COUNTER.launches
    with torch.no_grad():
        out = attend(*(_placed(t, card_mesh) for t in (q, k, v)))
    torch.cuda.synchronize()
    assert isinstance(out, DTensor) and fa_mod.COUNTER.launches == before + 1
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=True)
    local = out.to_local().transpose(1, 2)
    if dtype == torch.float32:
        torch.testing.assert_close(local, ref, atol=TOL[dtype] * 4, rtol=TOL[dtype] * 4)
    else:
        _check_flash_bf16(local, ref)


def test_dtensor_paged_attend_entry_launches_the_kernel(dev, card_mesh):
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.flash_attention import paged_attention as pa_mod
    from repro_torch.kernels.flash_attention.ops import paged_attend
    from repro_torch.kernels.flash_attention.ref import paged_attention_ref

    q, k, v, table, lengths = _paged_inputs(33, 8, 4, 8, 128, 16, 16, torch.bfloat16,
                                            torch.bfloat16, dev)
    before = pa_mod.COUNTER.launches
    out = paged_attend(_placed(q, card_mesh), _placed(k[0], card_mesh),
                       _placed(v[0], card_mesh), table, lengths)
    torch.cuda.synchronize()
    assert isinstance(out, DTensor) and pa_mod.COUNTER.launches == before + 1
    _check_paged(out.to_local(), paged_attention_ref(q, k[0], v[0], table, lengths))


def test_dtensor_reaching_a_launcher_without_local_map_raises(dev, card_mesh):
    from repro_torch.kernels.flash_attention import paged_attention as pa_mod

    x = _placed(torch.randn(2, 4, 64, 128, device=dev), card_mesh)
    one = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    counts = (nu_mod.COUNTER.launches, fa_mod.COUNTER.launches, pa_mod.COUNTER.launches)
    for call in (lambda: ns_update(x, x.unsqueeze(0), torch.ones((), device=dev),
                                   torch.ones(1, device=dev)),
                 lambda: flash_attention(x, x, x),
                 lambda: pa_mod.paged_attention(x, x, x, one, one[:, 0])):
        with pytest.raises(TypeError, match="DTensor with no local_map"):
            call()
    assert counts == (nu_mod.COUNTER.launches, fa_mod.COUNTER.launches,
                      pa_mod.COUNTER.launches)


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-2.7b"])
def test_lm_apply_with_a_window_raises_on_the_card(dev, arch):
    """Sliding-window attention has no CUDA kernel (the reference's flash
    kernel takes no window either): ``lm_apply`` with ``window > 0`` on card
    tensors runs the masked plain path on the card, launches no flash kernel
    and matches the same call on the CPU; without a window the same call
    runs the flash kernel. (The name is older than the windowed route: the
    card refused a window until it had one.)"""
    from repro_torch.configs import for_device, get_config
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import params_to

    cfg = for_device(get_config(arch, smoke=True), dev)   # heads the flash kernel takes
    params = tmodel.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), device=dev)}
    before = fa_mod.COUNTER.launches
    windowed = tmodel.lm_apply(params, cfg, batch, window=4)
    torch.cuda.synchronize()
    assert fa_mod.COUNTER.launches == before and windowed.is_cuda
    on_cpu = tmodel.lm_apply(params_to(params, "cpu"), cfg,
                             {"tokens": batch["tokens"].cpu()}, window=4)
    torch.testing.assert_close(windowed.cpu(), on_cpu, atol=1e-4, rtol=1e-4)
    before = fa_mod.COUNTER.launches
    logits = tmodel.lm_apply(params, cfg, batch, last_only=True)
    torch.cuda.synchronize()
    assert logits.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    assert fa_mod.COUNTER.launches > before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_dispatch_backward_bits_repeat_on_the_card(dev, cf, dtype):
    """``moe_mlp_scatter``'s backward twice on the same inputs and gradient:
    x.grad equal to the bit (the dispatch gather's backward is a gather,
    ``moe._Dispatch``, not ``index_add_``'s float atomics), and close to the
    same layer on the CPU. 32 experts of 64, top 8, d_model 256, 2 x 256
    tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    base = get_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(base, d_model=256, moe=dataclasses.replace(
        base.moe, num_experts=32, d_expert=64, capacity_factor=cf))
    g = torch.Generator(device=dev).manual_seed(0)
    p = {k: v.to(dtype) for k, v in moe.init_moe_mlp(g, cfg).items()}
    rng = np.random.default_rng(1)
    x = _randn(rng, (2, 256, 256), dtype, dev)
    dy = _randn(rng, (2, 256, 256), dtype, dev)

    def x_grad(p, x, dy):
        x = x.clone().requires_grad_(True)
        y, _ = moe.moe_mlp_scatter(p, x, cfg)
        return torch.autograd.grad(y, x, dy)[0]

    first, second = x_grad(p, x, dy), x_grad(p, x, dy)
    assert torch.equal(first, second)
    if dtype == torch.float32:
        on_cpu = x_grad({k: v.cpu() for k, v in p.items()}, x.cpu(), dy.cpu())
        torch.testing.assert_close(first.cpu(), on_cpu, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The dry run on the card's torch (launch/dryrun.py): fake tensors on the
# card's paths, the kernels' launchers allocating and launching nothing
# ---------------------------------------------------------------------------


def test_dryrun_smoke_configs_on_the_cards_paths(dev, tmp_path):
    """Every smoke config at the four shapes on the fake 16 x 16 mesh,
    ``--device cuda`` (train too: autograd over fake CUDA tensors needs a
    torch built with CUDA), each combo in a process of its own: every
    record ``ok`` (whisper-medium's long_500k skipped, as the reference
    skips it), and the kernels' fake launches counted where the paths
    reach them."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--single-pod", "--smoke", "--outdir", str(tmp_path), "--jobs", "4"],
                          env=env, cwd=root, capture_output=True, text=True, timeout=1500)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert len(recs) == 39                      # 10 archs x 4 shapes, less one skip
    assert all(r["status"] == "ok" for r in recs.values())
    assert recs["yi-6b__prefill_32k__pod16x16.json"]["kernels"] == {"flash_attention": 2}
    assert set(recs["rwkv6-7b__train_4k__pod16x16.json"]["kernels"]) == {"gla_scan",
                                                                         "gla_scan_bwd"}


def test_gla_scan_uses_mma_equals_the_libraries_rule(dev):
    """The Python copy the launchers read on fake tensors, against both
    libraries' own rule over a grid of types and sizes."""
    from repro_torch.kernels.gla_scan import gla_scan as gs

    fwd, bwd = gs._lib(), gs._bwd_lib()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for dk in (16, 48, 64, 72, 128, 144):
            for dv in (16, 64, 80, 128, 160):
                for chunk in (8, 16, 32, 48, 64, 128):
                    want = gs.uses_mma(dtype, dk, dv, chunk)
                    assert bool(bwd.gla_scan_bwd_uses_mma(code, dk, dv, chunk)) == want
                    assert bool(fwd.gla_scan_uses_mma(code, dk, dv, chunk)) == want
