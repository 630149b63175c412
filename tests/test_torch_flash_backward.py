"""The flash backward's plain version and its tiled algebra, on the CPU.

``attention_bwd_ref`` (the formulas the CUDA backward kernel computes, from
the forward's output and per-row log-sum-exp) is held against torch autograd
of ``attention_ref`` and against ``jax.vjp`` of the reference's
``_grouped_attend`` (the attention its training path differentiates), for
GQA, causal and not, and ragged lengths; f32, tolerance
``tests/test_kernels.py``'s 2e-5 times 4, as that file scales attention. The
kernels' partitions are written out in f64 and must agree with autograd of
an f64 attention to 1e-10: the bf16 kernels' (dq in 128-query tiles over
64-key tiles up to the causal key limit; dk/dv in 64-key tiles over 64-query
tiles from the diagonal on; rows past Lq with lse +inf, so P = 0 there) and
the f32 kernels' (32 and 32); both summing over a group's heads in one block,
with D = rowsum(dO O) and P recomputed from lse. The kernel itself runs only
on the card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _grouped_attend
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ops import attend
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)

TOL = 2e-5 * 4
# The kernels' partitions: dq's query and key tiles, dk/dv's key and query
# tiles; the bf16 kernels' plans (csrc/flash_attention_bwd.cu, DqPlan<HD> and
# KvPlan<HD>) take the same tiles at hd 64, 80 and 128.
PARTITIONS = {
    "bf16 wgmma": dict(dq_rows=128, dq_keys=64, kv_keys=64, kv_queries=64),
    "f32 CUDA cores": dict(dq_rows=32, dq_keys=32, kv_keys=32, kv_queries=32),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run thousands of tiny eager ops (RK45 steps, training
    iterations); beside other test workers, torch's intra-op threads only
    contend for the cores, so each test runs on one and restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class OnCard(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: reaches the wrapper's checks
    that come after the device test, which must refuse before any launch."""

    @property
    def is_cuda(self):
        return True


def _inputs(seed, B, H, KV, Lq, Lk, hd=128, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype)
            for s in ((B, H, Lq, hd), (B, KV, Lk, hd), (B, KV, Lk, hd), (B, H, Lq, hd))]


def _mask(Lq, Lk, causal):
    return np.arange(Lq)[:, None] >= np.arange(Lk)[None, :] if causal else None


def _jax_vjp(q, k, v, do, causal):
    """jax.vjp of the reference's _grouped_attend, in the port's layout."""
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    G = H // KV
    to_q = lambda x: jnp.asarray(x).reshape(B, KV, G, Lq, hd).transpose(0, 3, 1, 2, 4)  # noqa: E731
    to_k = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    m = _mask(Lq, Lk, causal)
    mask = None if m is None else jnp.asarray(m)[None]
    _, vjp = jax.vjp(lambda a, b, c: _grouped_attend(a, b, c, mask), to_q(q), to_k(k), to_k(v))
    dq, dk, dv = vjp(to_q(do))
    return (np.asarray(dq.transpose(0, 2, 3, 1, 4)).reshape(B, H, Lq, hd),
            np.asarray(dk.transpose(0, 2, 1, 3)), np.asarray(dv.transpose(0, 2, 1, 3)))


SHAPES = [  # B, H, KV, Lq, Lk, causal
    (2, 8, 2, 77, 77, True),
    (2, 8, 2, 77, 77, False),
    (1, 4, 4, 33, 33, True),     # G = 1
    (1, 8, 1, 64, 64, True),     # G = 8, L a multiple of the tile
    (1, 6, 2, 100, 100, False),
    (1, 4, 2, 1, 1, True),       # one position
]


@pytest.mark.parametrize("B,H,KV,Lq,Lk,causal", SHAPES)
def test_attention_bwd_ref_matches_autograd_and_jax_vjp(B, H, KV, Lq, Lk, causal):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(Lq + H, B, H, KV, Lq, Lk))
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = attention_ref(qs, ks, vs, causal=causal)
    want = torch.autograd.grad(o, (qs, ks, vs), do)
    lse = attention_lse_ref(q, k, causal=causal)
    got = attention_bwd_ref(q, k, v, o.detach(), lse, do, causal=causal)
    jwant = _jax_vjp(*(t.numpy() for t in (q, k, v, do)), causal)
    for g, w, jw in zip(got, want, jwant):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g.numpy(), jw, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_bwd_ref_in_bf16_returns_bf16(causal):
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(3, 1, 4, 2, 40, 40))
    o = attention_ref(q, k, v, causal=causal)
    got = attention_bwd_ref(q, k, v, o, attention_lse_ref(q, k, causal=causal), do,
                            causal=causal)
    want = attention_bwd_ref(*(t.float() for t in (q, k, v, o)),
                             attention_lse_ref(q, k, causal=causal), do.float(), causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Lq,Lk", [(50, 50), (30, 90)])
def test_lse_ref_matches_reference_scores(causal, Lq, Lk):
    q, k, _, _ = _inputs(Lq, 2, 4, 2, Lq, Lk, hd=64)
    s = jnp.einsum("bkgqh,bksh->bkgqs", jnp.asarray(q).reshape(2, 2, 2, Lq, 64) * 64 ** -0.5,
                   jnp.asarray(k))
    m = _mask(Lq, Lk, causal)
    if m is not None:
        s = jnp.where(jnp.asarray(m), s, -1e30)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(2, 4, Lq)
    got = attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def _f64_attention(q, k, v, causal):
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    G = H // KV
    s = torch.einsum("bkgqh,bksh->bkgqs", q.reshape(B, KV, G, Lq, hd), k) * hd ** -0.5
    if causal:
        s = torch.where(torch.from_numpy(_mask(Lq, Lk, True)), s, -torch.inf)
    return torch.einsum("bkgqs,bksh->bkgqh", torch.softmax(s, -1), v).reshape(B, H, Lq, hd)


def _tiled_backward(q, k, v, o, lse, do, causal, part):
    """A kernel's partition in f64: what each block computes. Rows past Lq
    and keys past Lk are zeros, as the kernels' tile loads give them, and rows
    past Lq have lse +inf, as the bf16 kernels' row workspace holds (P = 0)."""
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    G, scale = H // KV, hd ** -0.5
    pad_q, pad_k = -Lq % 128, -Lk % 128
    qp, dop = (torch.nn.functional.pad(x, (0, 0, 0, pad_q)) for x in (q, do))
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, pad_k)) for x in (k, v))
    D = torch.nn.functional.pad((do * o).sum(-1), (0, pad_q))
    lse2 = torch.nn.functional.pad(lse, (0, pad_q), value=torch.inf)
    dq, dk, dv = torch.zeros_like(qp), torch.zeros_like(kp), torch.zeros_like(vp)

    def keep(i0, ni, j0, nj):  # the (query, key) pairs the kernels keep
        i = torch.arange(i0, i0 + ni)[:, None]
        j = torch.arange(j0, j0 + nj)[None, :]
        return (j < Lk) & ((j <= i) if causal else True)

    # dq pass: one block a (query tile, head, batch), key tiles to the causal limit
    nq, nk = part["dq_rows"], part["dq_keys"]
    for b in range(B):
        for h in range(H):
            kvh = h // G
            for q0 in range(0, Lq, nq):
                rows = slice(q0, q0 + nq)
                k_end = min(Lk, min(q0 + nq, Lq)) if causal else Lk
                acc = torch.zeros((nq, hd), dtype=q.dtype)
                for k0 in range(0, k_end, nk):
                    cols = slice(k0, k0 + nk)
                    s = qp[b, h, rows] @ kp[b, kvh, cols].T
                    dp = dop[b, h, rows] @ vp[b, kvh, cols].T
                    p = torch.where(keep(q0, nq, k0, nk),
                                    torch.exp(s * scale - lse2[b, h, rows, None]), 0.0)
                    acc += (p * (dp - D[b, h, rows, None])) @ kp[b, kvh, cols]
                dq[b, h, rows] = acc * scale
    # dk/dv pass: one block a (key tile, KV head, batch), the query tiles of
    # the group's heads from the diagonal on
    nk, nq = part["kv_keys"], part["kv_queries"]
    for b in range(B):
        for kvh in range(KV):
            for k0 in range(0, Lk, nk):
                cols = slice(k0, k0 + nk)
                adk = torch.zeros((nk, hd), dtype=q.dtype)
                adv = torch.zeros((nk, hd), dtype=q.dtype)
                for hg in range(G):
                    h = kvh * G + hg
                    for q0 in range(k0 if causal else 0, Lq, nq):
                        rows = slice(q0, q0 + nq)
                        st = kp[b, kvh, cols] @ qp[b, h, rows].T     # (keys, queries)
                        dpt = vp[b, kvh, cols] @ dop[b, h, rows].T
                        p = torch.where(keep(q0, nq, k0, nk).T,
                                        torch.exp(st * scale - lse2[b, h, None, rows]), 0.0)
                        ds = p * (dpt - D[b, h, None, rows])
                        adv += p @ dop[b, h, rows]
                        adk += ds @ qp[b, h, rows]
                dk[b, kvh, cols] = adk * scale
                dv[b, kvh, cols] = adv
    return dq[:, :, :Lq], dk[:, :, :Lk], dv[:, :, :Lk]


@pytest.mark.parametrize("B,H,KV,Lq,Lk,causal", SHAPES + [
    (1, 4, 2, 50, 70, True),     # causal, Lq < Lk: top-left aligned mask
    (1, 4, 2, 70, 50, True),     # causal, Lq > Lk: late rows see every key
    (1, 4, 2, 40, 97, False),
    (1, 8, 1, 200, 150, True)])  # more rows than the bf16 dq tile
@pytest.mark.parametrize("partition", sorted(PARTITIONS))
@pytest.mark.parametrize("hd", [64, 80, 128])
def test_tiled_algebra_matches_autograd_in_f64(B, H, KV, Lq, Lk, causal, partition, hd):
    """Recompute from lse, D from dO and O, the sum over the group's heads,
    and the causal tile skipping (no query tile before the key tile's diagonal, no key tile past
    the query tile's last row) lose nothing, at each head dim the kernels take."""
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in _inputs(Lk + 7, B, H, KV, Lq, Lk, hd=hd))
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = _f64_attention(qs, ks, vs, causal)
    want = torch.autograd.grad(o, (qs, ks, vs), do)
    s = torch.einsum("bkgqh,bksh->bkgqs", q.reshape(B, KV, H // KV, Lq, hd), k) * hd ** -0.5
    if causal:
        s = torch.where(torch.from_numpy(_mask(Lq, Lk, True)), s, -torch.inf)
    lse = torch.logsumexp(s, -1).reshape(B, H, Lq)
    got = _tiled_backward(q, k, v, o.detach(), lse, do, causal, PARTITIONS[partition])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("causal", [True, False])
def test_attend_under_grad_on_cpu_is_differentiated_like_the_reference(causal):
    """The CPU route (the plain version) keeps its graph: the output has a
    grad_fn and its gradient is jax.vjp of the reference's _grouped_attend."""
    B, H, KV, L, hd = 2, 8, 2, 45, 64
    q, k, v, do = _inputs(9, B, H, KV, L, L, hd=hd)
    # attend takes the model's (B, L, heads, hd) layout
    qm, km, vm = (torch.from_numpy(a).transpose(1, 2).contiguous().requires_grad_(True)
                  for a in (q, k, v))
    out = attend(qm, km, vm, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (qm, km, vm), torch.from_numpy(do).transpose(1, 2))
    want = _jax_vjp(q, k, v, do, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,H,KV,Lq,Lk,causal,hd", [
    (1, 4, 4, 24, 40, False, 64),    # whisper-medium's cross-attention form, Lq != Lk
    (1, 4, 4, 33, 33, True, 64),     # its decoder's causal self-attention
    (1, 4, 4, 24, 40, False, 80),
    (1, 4, 4, 29, 29, True, 80),     # zamba2-2.7b's shared attention, G 1
    (2, 8, 2, 40, 17, True, 80),     # GQA, causal with Lq > Lk
])
def test_attention_bwd_ref_at_hd_64_and_80(B, H, KV, Lq, Lk, causal, hd):
    """The formulas the backward kernels compute at the head dims the
    CUDA-core backward adds, against autograd of the plain attention and
    jax.vjp of the reference's, Lq != Lk included."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(Lq + hd, B, H, KV, Lq, Lk, hd=hd))
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = attention_ref(qs, ks, vs, causal=causal)
    want = torch.autograd.grad(o, (qs, ks, vs), do)
    lse = attention_lse_ref(q, k, causal=causal)
    got = attention_bwd_ref(q, k, v, o.detach(), lse, do, causal=causal)
    jwant = _jax_vjp(*(t.numpy() for t in (q, k, v, do)), causal)
    for g, w, jw in zip(got, want, jwant):
        assert g.shape == w.shape and g.shape[-1] == hd
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g.numpy(), jw, rtol=TOL, atol=TOL)


def test_backward_wrapper_refuses_cpu_tensors_and_other_head_dims_before_any_launch():
    """hd 64, 80 and 128 pass the checks the forward with lse and the
    backward share (zamba2-2.7b's 80 and whisper-medium's 64 train); any
    other head dim is refused, as a CPU tensor is, before any launch."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 1, 4, 2, 8, 8))
    lse = attention_lse_ref(q, k)
    before = (fa_mod.COUNTER.launches, fa_mod.BWD_COUNTER.launches)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, v, q, lse, do)
    for hd in (64, 80, 128):
        qh, kh, vh, _ = (torch.from_numpy(a).as_subclass(OnCard)
                         for a in _inputs(2, 1, 4, 2, 8, 8, hd=hd))
        fa_mod._check_inputs("flash_attention_bwd", qh, kh, vh)
    q32, k32, v32, do32 = (torch.from_numpy(a).as_subclass(OnCard)
                           for a in _inputs(2, 1, 4, 2, 8, 8, hd=32))
    with pytest.raises(ValueError, match=r"head dims \(64, 80, 128\), got 32"):
        flash_attention_bwd(q32, k32, v32, q32, lse, do32)
    with pytest.raises(ValueError, match=r"head dims \(64, 80, 128\), got 32"):
        flash_attention(q32, k32, v32, return_lse=True)
    assert (fa_mod.COUNTER.launches, fa_mod.BWD_COUNTER.launches) == before


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("fault", ["pointer", "stride"])
def test_bf16_backward_refuses_misaligned_inputs_at_hd_64_and_80_before_any_launch(hd, fault):
    """bf16 at hd 64 and 80 takes the tensor-core path, whose TMA maps need
    16-byte aligned q, k, v, o and strides that are multiples of 8: a tensor
    one element off, or a view whose position stride is hd + 4, is refused
    before any launch, as at hd 128."""
    B, H, KV, L = 1, 4, 2, 8
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(3, B, H, KV, L, L, hd=hd))
    lse = attention_lse_ref(q.float(), k.float())
    if fault == "pointer":
        # the same values one bf16 element (2 bytes) past an aligned start
        buf = torch.empty(k.numel() + 1, dtype=torch.bfloat16)
        k = buf[1:].view(k.shape).copy_(k)
    else:
        # (B, L, KV, hd + 4) storage: the position stride is KV (hd + 4)
        buf = torch.zeros(B, L, KV, hd + 4, dtype=torch.bfloat16)
        buf[..., :hd] = k.transpose(1, 2)
        k = buf[..., :hd].transpose(1, 2)
    q, k, v, o, do = (t.as_subclass(OnCard) for t in (q, k, v, q, do))
    before = (fa_mod.COUNTER.launches, fa_mod.BWD_COUNTER.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd(q, k, v, o, lse, do, dkdv=False)
    assert (fa_mod.COUNTER.launches, fa_mod.BWD_COUNTER.launches) == before
