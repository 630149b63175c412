"""The port's gated linear recurrence against the JAX reference, on the CPU.

``models.linear_scan`` (``gla_recurrent``, ``gla_step``, ``gla_chunked``)
against ``repro.models.linear_scan`` on the cases of
``tests/test_models_units.py``, and the kernel's CPU route (``ops.gla``, the
plain chunked form) against ``repro.kernels.gla_scan.gla_scan`` in interpret
mode on the ``test_gla_scan_sweep`` shapes. Inputs are made with numpy from a
seed and handed to both sides. Tolerances: the reference tests' own
(chunked-vs-recurrent 5e-4 / 2e-4; the sweep atol 20 TOL, rtol TOL with TOL
f32 2e-5, bf16 2e-2) and f32 TOL for one framework's form against the
other's same form.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gla_scan.gla_scan import gla_scan as jax_gla_scan
from repro.models import linear_scan as J
from repro_torch.kernels.gla_scan import gla_scan as gs_mod
from repro_torch.kernels.gla_scan.ops import gla
from repro_torch.kernels.gla_scan.ref import gla_ref
from repro_torch.models import linear_scan as T

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, B, L, H, dk, dv, scale=0.5, ld_dk=None, s0=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, L, H, dk)).astype(np.float32)
    k = rng.standard_normal((B, L, H, dk)).astype(np.float32)
    v = rng.standard_normal((B, L, H, dv)).astype(np.float32)
    ld = (-np.abs(rng.standard_normal((B, L, H, ld_dk or dk))) * scale).astype(np.float32)
    out = [q, k, v, ld]
    if s0:
        out.append(rng.standard_normal((B, H, dk, dv)).astype(np.float32))
    return out


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, atol, rtol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.to(torch.float32).numpy(),
                                   np.asarray(w, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("L,chunk,inclusive,strong", [
    (4, 8, True, False), (17, 8, False, False), (33, 16, True, True),
    (64, 16, False, True), (96, 32, True, False), (50, 32, False, False),
    (96, 8, False, True), (23, 16, True, False),
])
def test_gla_chunked_matches_recurrent(L, chunk, inclusive, strong):
    """tests/test_models_units.py: chunked == recurrent over L, chunk, mode
    and decay strength, on the port's side, and each form against the
    reference's same form."""
    x = _inputs(L * 7 + chunk, 2, L, 2, 8, 12, scale=25.0 if strong else 0.5)
    o_rec, s_rec = T.gla_recurrent(*_t(x), inclusive=inclusive)
    o, s = T.gla_chunked(*_t(x), inclusive=inclusive, chunk=chunk)
    _close((o, s), (o_rec.numpy(), s_rec.numpy()), atol=5e-4, rtol=2e-4)
    _close((o_rec, s_rec), J.gla_recurrent(*_j(x), inclusive=inclusive),
           atol=TOL["float32"], rtol=TOL["float32"])
    # the strong-decay forms differ from each other by 5e-4 (the reference
    # test's tolerance), so each framework's chunked form is held at that
    _close((o, s), J.gla_chunked(*_j(x), inclusive=inclusive, chunk=chunk),
           atol=5e-4 if strong else TOL["float32"], rtol=2e-4 if strong else TOL["float32"])


def test_gla_scalar_decay_matches_broadcast():
    """One decay per head (ld's last dim 1) == that decay broadcast to dk."""
    q, k, v, ld1 = _inputs(5, 2, 64, 3, 16, 32, ld_dk=1)
    ld = np.broadcast_to(ld1, q.shape).copy()
    o1, s1 = T.gla_chunked(*_t([q, k, v, ld1]), chunk=16)
    o2, s2 = T.gla_chunked(*_t([q, k, v, ld]), chunk=16)
    _close((o1, s1), (o2.numpy(), s2.numpy()), atol=1e-4, rtol=0)
    o3, _ = T.gla_recurrent(*_t([q, k, v, ld]))
    _close((o1,), (o3.numpy(),), atol=1e-4, rtol=0)
    _close((o1, s1), J.gla_chunked(*_j([q, k, v, ld1]), chunk=16),
           atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("inclusive", [True, False])
def test_gla_state_carry_composes(inclusive):
    """Two halves with the state carried == the whole sequence; a given s0
    matches the reference's."""
    q, k, v, ld, s0 = _inputs(0, 1, 64, 2, 8, 8, s0=True)
    x = _t([q, k, v, ld])
    o_full, s_full = T.gla_chunked(*x, inclusive=inclusive, chunk=16)
    o1, s1 = T.gla_chunked(*(a[:, :32] for a in x), inclusive=inclusive, chunk=16)
    o2, s2 = T.gla_chunked(*(a[:, 32:] for a in x), s1, inclusive=inclusive, chunk=16)
    _close((torch.cat([o1, o2], 1), s2), (o_full.numpy(), s_full.numpy()), atol=1e-4, rtol=0)
    got = T.gla_chunked(*x, torch.from_numpy(s0), inclusive=inclusive, chunk=16)
    _close(got, J.gla_chunked(*_j([q, k, v, ld, s0]), inclusive=inclusive, chunk=16),
           atol=TOL["float32"], rtol=TOL["float32"])
    _close(got, [a.numpy() for a in T.gla_recurrent(*x, torch.from_numpy(s0),
                                                    inclusive=inclusive)],
           atol=5e-4, rtol=2e-4)


def test_gla_strong_decay_stays_finite():
    """ld x30 (tests/test_kernels.py): no exponent of the chunked form is
    positive, so the output is finite and matches the oracle."""
    x = _inputs(1, 1, 128, 2, 16, 16, scale=30.0)
    o, s = T.gla_chunked(*_t(x), inclusive=False, chunk=32)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    o_ref, _ = J.gla_recurrent(*_j(x), inclusive=False)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-3)


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gla_step_matches_reference(inclusive, dtype):
    q, k, v, ld, S = _inputs(3, 2, 1, 4, 16, 24, s0=True)
    q, k, v, ld = (a[:, 0] for a in (q, k, v, ld))            # (B, H, d): one step
    tq = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    jq = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    o, s_new = T.gla_step(*tq, torch.from_numpy(ld), torch.from_numpy(S),
                          inclusive=inclusive)
    jo, js = J.gla_step(*jq, jnp.asarray(ld), jnp.asarray(S), inclusive=inclusive)
    assert o.dtype == getattr(torch, dtype) and s_new.dtype == torch.float32
    _close((o, s_new), (jo, js), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,chunk,inclusive,dk,dv", [
    (128, 32, True, 64, 64),     # mamba2-style (dk=d_state, dv=head_dim)
    (128, 32, False, 64, 64),    # rwkv6-style exclusive
    (96, 16, False, 32, 48),     # ragged head dims
    (64, 64, True, 16, 128),     # single chunk
])
def test_plain_route_matches_the_reference_kernel(L, chunk, inclusive, dk, dv, dtype):
    """The kernel's CPU route against the Pallas kernel in interpret mode on
    tests/test_kernels.py::test_gla_scan_sweep's shapes and tolerances; both
    take the same inputs in ``dtype`` (ld in f32, as the model gives it)."""
    q, k, v, ld = _inputs(L + chunk, 2, L, 3, dk, dv)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    before = gs_mod.COUNTER.launches
    o, s = gla(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.from_numpy(ld),
               inclusive=inclusive, chunk=chunk)
    assert gs_mod.COUNTER.launches == before                  # CPU: the plain route
    assert o.dtype == tdt and s.dtype == torch.float32
    jo, js = jax_gla_scan(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(ld),
                          inclusive=inclusive, chunk=chunk, interpret=True)
    tol = TOL[dtype]
    _close((o, s), (jo, js), atol=tol * 20, rtol=tol)


def _subchunk_way(q, k, v, ld, s0, *, inclusive, chunk):
    """The bf16 tensor-core kernel's algorithm (csrc/gla_scan.cu), written out
    in f64 for a check of its algebra: each chunk is cut into 16-row
    sub-chunks; query sub-chunk i takes its off-diagonal score blocks (key
    sub-chunk j < i) as one product about the reference point r_i = cum at
    the last row of sub-chunk i - 1,

        scores_ij = (q_i e^{cum_q - r_i}) (k_j e^{r_i - cum_j})^T,

    and the 16 x 16 diagonal blocks are cut once more, into 8-row halves:
    the lower-left 8 x 8 block is the same product about cum at the 8th row,
    and only the two 8 x 8 diagonal triangles keep the per-channel clamped
    exponential. cum_q is the previous row of cum behind a zero row
    (exclusive) or cum itself (inclusive). A ragged tail reads as zeros."""
    B, L, H, dk = q.shape
    dv = v.shape[-1]
    pad = (-L) % chunk
    q, k, v, ld = (torch.nn.functional.pad(a.double(), (0, 0, 0, 0, 0, pad)).transpose(1, 2)
                   for a in (q, k, v, ld))
    ld = ld.expand(B, H, L + pad, dk)
    S = torch.zeros((B, H, dk, dv), dtype=torch.float64) if s0 is None else s0.double()
    idx = torch.arange(16)
    keep = idx[:, None] >= idx[None, :] if inclusive else idx[:, None] > idx[None, :]
    outs = []
    for l0 in range(0, L + pad, chunk):
        qc, kc, vc, lc = (a[:, :, l0:l0 + chunk] for a in (q, k, v, ld))
        cz = torch.nn.functional.pad(lc.cumsum(2), (0, 0, 1, 0))   # zero row, then cum
        cum = cz[:, :, 1:]
        cq = cum if inclusive else cz[:, :, :-1]
        scores = torch.zeros((B, H, chunk, chunk), dtype=torch.float64)
        for i in range(chunk // 16):
            T = slice(16 * i, 16 * i + 16)
            if i:
                r = cum[:, :, 16 * i - 1:16 * i]
                qp = qc[:, :, T] * torch.exp(cq[:, :, T] - r)
                kp = kc[:, :, :16 * i] * torch.exp(r - cum[:, :, :16 * i])
                scores[:, :, T, :16 * i] = qp @ kp.transpose(-1, -2)
            diag = torch.zeros((B, H, 16, 16), dtype=torch.float64)
            for h in (0, 8):                        # the two 8 x 8 diagonal triangles
                R = slice(16 * i + h, 16 * i + h + 8)
                dd = (cq[:, :, R, None, :] - cum[:, :, None, R, :]).clamp(max=0.0)
                diag[:, :, h:h + 8, h:h + 8] = (qc[:, :, R, None, :] * kc[:, :, None, R, :]
                                                * torch.exp(dd)).sum(-1)
            lo, hi = slice(16 * i, 16 * i + 8), slice(16 * i + 8, 16 * i + 16)
            rh = cum[:, :, 16 * i + 7:16 * i + 8]   # cum at the 8th row of the sub-chunk
            diag[:, :, 8:, :8] = ((qc[:, :, hi] * torch.exp(cq[:, :, hi] - rh))
                                  @ (kc[:, :, lo] * torch.exp(rh - cum[:, :, lo])).transpose(-1, -2))
            scores[:, :, T, T] = torch.where(keep, diag, 0.0)
        outs.append((qc * torch.exp(cq)) @ S + scores @ vc)
        cend = cum[:, :, -1:]
        S = torch.exp(cend[:, :, 0, :, None]) * S + (kc * torch.exp(cend - cum)).transpose(-1, -2) @ vc
    return torch.cat(outs, 2).transpose(1, 2)[:, :L], S


@pytest.mark.parametrize("decay", ["moderate", "strong", "per head"])
@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_subchunk_algebra_matches_chunked_form(chunk, inclusive, decay):
    """The kernel's sub-chunk algebra (f64, _subchunk_way) against the f64
    recurrence (1e-9) and against gla_chunked, over chunks of 16, 32 and 64,
    both modes, moderate (x0.5) and strong (x30) per-channel decay and a
    decay per head, a ragged tail and an s0. Every output is finite, so no
    factor of the algebra overflows. gla_chunked computes in f32; it is held
    at its tolerance against the recurrence (tests/test_models_units.py,
    5e-4 / 2e-4), except under strong decay at chunks of 32 and 64, where its
    f32 cumulative decays (|cum| ~ 1e3, one ulp ~ 1e-4) put it up to 2.1e-3
    from the exact recurrence on these inputs: atol 3e-3 there."""
    scale = 30.0 if decay == "strong" else 0.5
    q, k, v, ld, s0 = _t(_inputs(chunk + 3 * inclusive, 2, 2 * chunk + 10, 2, 32, 48,
                                 scale=scale, ld_dk=1 if decay == "per head" else None, s0=True))
    o, s = _subchunk_way(q, k, v, ld, s0, inclusive=inclusive, chunk=chunk)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    exact = T.gla_recurrent(*(a.double() for a in (q, k, v, ld, s0)), inclusive=inclusive)
    _close((o, s), [w.numpy() for w in exact], atol=1e-9, rtol=1e-9)
    want = T.gla_chunked(q, k, v, ld, s0, inclusive=inclusive, chunk=chunk)
    f32_drift = decay == "strong" and chunk > 16
    _close((o, s), [w.numpy() for w in want], atol=3e-3 if f32_drift else 5e-4, rtol=2e-4)


def test_ops_gla_on_cpu_is_the_chunked_form():
    q, k, v, ld, s0 = _t(_inputs(8, 2, 40, 2, 16, 16, s0=True))
    before = gs_mod.COUNTER.launches
    got = gla(q, k, v, ld, s0, inclusive=False, chunk=16)
    want = T.gla_chunked(q, k, v, ld, s0, inclusive=False, chunk=16)
    assert gs_mod.COUNTER.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_gla_ref_is_the_recurrent_oracle():
    assert gla_ref is T.gla_recurrent


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, ld = _t(_inputs(0, 1, 8, 1, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        gs_mod.gla_scan(q, k, v, ld)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``, so ``ops.gla`` takes its card
    route, with the kernels stood in for by their plain versions."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("needs_grad", ["q", "k", "v", "ld", "s0"])
def test_card_route_under_grad_runs_the_forward_and_backward_kernels(needs_grad,
                                                                     monkeypatch):
    """On the card, an input that requires grad under grad mode goes through
    ``GLAScan``: the forward kernel, then at the backward the backward kernel
    (``gla_scan_bwd``), nothing else; the gradient is the CPU route's. Under
    no_grad the same inputs reach the forward kernel alone."""
    from repro_torch.kernels.gla_scan import ops as gla_ops
    from repro_torch.kernels.gla_scan.ref import gla_chunked_bwd

    arrays = dict(zip(("q", "k", "v", "ld", "s0"),
                      _t(_inputs(3, 1, 8, 2, 4, 4, s0=True))))
    arrays[needs_grad].requires_grad_(True)
    calls = []

    def forward(q, k, v, ld, s0=None, *, inclusive, chunk):
        calls.append("gla_scan")
        return T.gla_chunked(q, k, v, ld, s0, inclusive=inclusive, chunk=chunk)

    def backward(*args, inclusive, chunk):
        calls.append("gla_scan_bwd")
        return gla_chunked_bwd(*args, inclusive=inclusive, chunk=chunk)

    monkeypatch.setattr(gla_ops, "gla_scan", forward)
    monkeypatch.setattr(gla_ops, "gla_scan_bwd", backward)
    card = {name: t.as_subclass(_OnCard) for name, t in arrays.items()}
    do, dS = _t(_inputs(4, 1, 8, 2, 4, 4, s0=True))[2::2]
    o, S = gla(card["q"], card["k"], card["v"], card["ld"], card["s0"])
    assert type(o.grad_fn).__name__ == "GLAScanBackward" and calls == ["gla_scan"]
    got, = torch.autograd.grad((o * do).sum() + (S * dS).sum(), arrays[needs_grad])
    assert calls == ["gla_scan", "gla_scan_bwd"]
    o, S = gla(arrays["q"], arrays["k"], arrays["v"], arrays["ld"], arrays["s0"])
    want, = torch.autograd.grad((o * do).sum() + (S * dS).sum(), arrays[needs_grad])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL["float32"],
                               atol=TOL["float32"])
    with torch.no_grad():
        gla(card["q"], card["k"], card["v"], card["ld"], card["s0"])
    assert calls == ["gla_scan", "gla_scan_bwd", "gla_scan"]
