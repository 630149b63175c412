"""The gla_scan backward's plain version, ``ref.gla_chunked_bwd``, on the CPU.

It is the closed form the CUDA backward kernel (``csrc/gla_scan_bwd.cu``)
computes, chunk by chunk in reverse. Held against torch autograd of the
port's ``models.linear_scan.gla_chunked`` in f64 (to 1e-10 relative L2) and
against ``jax.vjp`` of the reference's ``repro.models.linear_scan.gla_chunked``
in f32 (``tests/test_kernels.py``'s TOL, 2e-5), in rwkv6's exclusive form
(one decay a channel), the inclusive form and zamba2's (inclusive, q and k
one group broadcast over the heads, one decay a head); ragged L, an initial
state and a final-state gradient, strong and weak decay. Inputs are made with
numpy from a seed and handed to both sides. ``_subchunk_bwd_way`` writes out
the bf16 tensor-core kernel's sub-chunk algebra (reference points, 8-row
halves, masks by mode) in f64 and is held to both; change it with the
kernel. The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import linear_scan as J
from repro_torch.kernels.gla_scan.ref import gla_chunked_bwd
from repro_torch.models.linear_scan import gla_chunked

TOL = 2e-5
FORMS = {  # inclusive, q and k one group over the heads, one decay a head
    "exclusive": (False, False, False),
    "inclusive": (True, False, False),
    "group": (True, True, True),
}


def _inputs(seed, B, L, H, dk, dv, form, strength, state):
    _, group, scalar = FORMS[form]
    rng = np.random.default_rng(seed)
    Hq = 1 if group else H
    out = {
        "q": rng.standard_normal((B, L, Hq, dk)),
        "k": rng.standard_normal((B, L, Hq, dk)),
        "v": rng.standard_normal((B, L, H, dv)),
        "ld": -strength * np.exp(rng.standard_normal((B, L, H, 1 if scalar else dk))),
        "do": rng.standard_normal((B, L, H, dv)),
        "s0": rng.standard_normal((B, H, dk, dv)) if state else None,
        "dS": rng.standard_normal((B, H, dk, dv)) if state else None,
    }
    return out


def _relative_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("L,chunk,strength,state", [
    (37, 16, 0.05, True),     # ragged, weak decay, s0 and dS_final
    (37, 16, 4.0, True),      # strong decay: most factors underflow towards 0
    (32, 8, 0.5, False),      # a multiple of the chunk, no state
    (5, 16, 0.5, True),       # one chunk, cut to L
])
def test_matches_autograd_of_gla_chunked_in_f64(form, L, chunk, strength, state):
    inclusive, group, _ = FORMS[form]
    a = _inputs(L + chunk, 2, L, 3, 8, 6, form, strength, state)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    leaves = {k: t[k].clone().requires_grad_(True) for k in ("q", "k", "v", "ld", "s0")
              if t[k] is not None}
    B, _, H, _ = t["v"].shape
    dk = t["q"].shape[-1]
    o, S = gla_chunked(leaves["q"].expand(B, L, H, dk), leaves["k"].expand(B, L, H, dk),
                       leaves["v"], leaves["ld"], leaves.get("s0"), inclusive=inclusive,
                       chunk=chunk)
    loss = (o * t["do"]).sum() + ((S * t["dS"]).sum() if state else 0.0)
    want = torch.autograd.grad(loss, list(leaves.values()))
    got = gla_chunked_bwd(t["q"], t["k"], t["v"], t["ld"], t["s0"], t["do"], t["dS"],
                          inclusive=inclusive, chunk=chunk)
    assert (got[4] is None) == (not state)
    for g, w, name in zip(got, want, leaves):
        assert g.shape == w.shape and g.dtype == torch.float64, name
        assert _relative_l2(g, w) <= 1e-10, name


def _jax_vjp(a, inclusive, chunk):
    """jax.vjp of the reference's gla_chunked, q and k broadcast over the
    heads where they are one group (their cotangents summed by the vjp)."""
    B, L, H, _ = a["v"].shape
    dk = a["q"].shape[-1]
    f32 = {k: None if v is None else jnp.asarray(v, jnp.float32) for k, v in a.items()}

    def run(q, k, v, ld, *s0):
        return J.gla_chunked(jnp.broadcast_to(q, (B, L, H, dk)),
                             jnp.broadcast_to(k, (B, L, H, dk)), v, ld,
                             s0[0] if s0 else None, inclusive=inclusive, chunk=chunk)

    primals = [f32[k] for k in ("q", "k", "v", "ld")] + ([f32["s0"]] if a["s0"] is not None
                                                         else [])
    (o, S), vjp = jax.vjp(run, *primals)
    dS = f32["dS"] if a["dS"] is not None else jnp.zeros_like(S)
    return [np.asarray(g) for g in vjp((f32["do"], dS))]


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("L,chunk,state", [(37, 16, True), (24, 8, False)])
def test_matches_jax_vjp_of_the_reference_in_f32(form, L, chunk, state):
    inclusive, _, _ = FORMS[form]
    a = _inputs(L + 3, 2, L, 3, 8, 6, form, 0.3, state)
    a = {k: None if v is None else v.astype(np.float32) for k, v in a.items()}
    want = _jax_vjp(a, inclusive, chunk)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    got = gla_chunked_bwd(t["q"], t["k"], t["v"], t["ld"], t["s0"], t["do"], t["dS"],
                          inclusive=inclusive, chunk=chunk)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


def test_bf16_inputs_give_gradients_in_each_input_dtype():
    a = _inputs(1, 1, 20, 2, 8, 8, "exclusive", 0.5, True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    bf = {k: t[k].to(torch.bfloat16) for k in ("q", "k", "v", "do")}
    got = gla_chunked_bwd(bf["q"], bf["k"], bf["v"], t["ld"].float(), t["s0"].float(),
                          bf["do"], t["dS"].float(), inclusive=False, chunk=8)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 2
    want = gla_chunked_bwd(*(x.to(torch.float64) for x in (
        bf["q"], bf["k"], bf["v"], t["ld"].float(), t["s0"].float(), bf["do"],
        t["dS"].float())), inclusive=False, chunk=8)
    for g, w in zip(got, want):
        assert _relative_l2(g.double(), w) <= 1e-2


def _subchunk_bwd_way(q, k, v, ld, s0, do, dS, *, inclusive, chunk):
    """The bf16 tensor-core backward kernel's algorithm
    (csrc/gla_scan_bwd.cu::gla_scan_bwd_mma_kernel), written out in f64 for
    a check of its algebra. A forward sweep from s0 leaves dq's state term
    e^{cum_q} (S0 do) a chunk; then the chunks in reverse with G, cut into
    16-row sub-chunks. With r_i = cum at the row before query sub-chunk i
    and rho_j = cum at key sub-chunk j's last row, for j < i:

        P_ij  = (q_i e^{cum_q - r_i}) (k_j e^{r_i - cum_j})^T
        dq_i += e^{cum_q - rho_j} (dP_ij (k_j e^{rho_j - cum_j}))
        dk_j += e^{r_i - cum_j} (dP_ij^T (q_i e^{cum_q - r_i}))

    and the 16 x 16 diagonal blocks of P, dq and dk in 8-row halves: the
    lower-left 8 x 8 block a product about rh = cum at the 8th row (through
    F = k e^{rh - cum} on the first half, q e^{cum_q - rh} on the last), the
    two 8 x 8 triangles with the per-channel clamped exponential, masked by
    mode. dv = P^T do + (k e^{cum_end - cum}) G; dld the reverse sums of
    q dq (a row later, exclusive) - k dk. q, k may be one group over v's
    heads, ld one decay a head. A ragged tail reads as zeros."""
    B, L, Hq, dk = q.shape
    H, dv = v.shape[2], v.shape[3]
    c = chunk
    pad = (-L) % c
    n_chunks = (L + pad) // c

    def rows(a, width):                                 # (B, H, L + pad, width)
        a = a.double().expand(B, L, H, width)
        return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad)).transpose(1, 2)

    q_, k_, ld_ = rows(q, dk), rows(k, dk), rows(ld, dk)
    v_, do_ = rows(v, dv), rows(do, dv)
    ex = torch.exp
    idx = torch.arange(16)
    keep = idx[:, None] >= idx[None, :] if inclusive else idx[:, None] > idx[None, :]
    half_keep = keep[:8, :8]
    nsub = c // 16

    def chunk_of(ic):
        T = slice(ic * c, ic * c + c)
        qc, kc, vc, lc, oc = (a[:, :, T] for a in (q_, k_, v_, ld_, do_))
        cz = torch.nn.functional.pad(lc.cumsum(2), (0, 0, 1, 0))   # zero row, then cum
        cum = cz[:, :, 1:]
        cq = cum if inclusive else cz[:, :, :-1]
        return qc, kc, vc, oc, cum, cq

    S = (torch.zeros((B, H, dk, dv), dtype=torch.float64) if s0 is None
         else s0.double().clone())
    dqs = []
    for ic in range(n_chunks):                          # the forward sweep
        qc, kc, vc, oc, cum, cq = chunk_of(ic)
        dqs.append(ex(cq) * (oc @ S.transpose(-1, -2)))
        cend = cum[:, :, -1:]
        S = ex(cend[:, :, 0, :, None]) * S + (kc * ex(cend - cum)).transpose(-1, -2) @ vc

    G = (torch.zeros((B, H, dk, dv), dtype=torch.float64) if dS is None
         else dS.double().clone())
    run = (G * S).sum(-1)
    qn = torch.zeros_like(run)
    parts = []
    for ic in reversed(range(n_chunks)):                # the reverse sweep
        qc, kc, vc, oc, cum, cq = chunk_of(ic)
        cend = cum[:, :, -1:]
        dP = oc @ vc.transpose(-1, -2)
        P = torch.zeros((B, H, c, c), dtype=torch.float64)
        dq = dqs[ic].clone()
        dk_ = ex(cend - cum) * (vc @ G.transpose(-1, -2))
        for i in range(nsub):
            I = slice(16 * i, 16 * i + 16)
            rh = cum[:, :, 16 * i + 7:16 * i + 8]
            lo, hi = slice(16 * i, 16 * i + 8), slice(16 * i + 8, 16 * i + 16)
            Fk = kc[:, :, lo] * ex(rh - cum[:, :, lo])
            Fq = qc[:, :, hi] * ex(cq[:, :, hi] - rh)
            diag = torch.zeros((B, H, 16, 16), dtype=torch.float64)
            diag[:, :, 8:, :8] = Fq @ Fk.transpose(-1, -2)
            dq[:, :, hi] += ex(cq[:, :, hi] - rh) * (dP[:, :, hi, lo] @ Fk)
            dk_[:, :, lo] += ex(rh - cum[:, :, lo]) * (dP[:, :, hi, lo].transpose(-1, -2) @ Fq)
            for h in (lo, hi):                          # the two 8 x 8 triangles
                E = ex((cq[:, :, h, None, :] - cum[:, :, None, h, :]).clamp(max=0.0))
                E = torch.where(half_keep[:, :, None], E, 0.0)
                diag[:, :, h.start - 16 * i:h.stop - 16 * i, h.start - 16 * i:h.stop - 16 * i] = \
                    (qc[:, :, h, None, :] * kc[:, :, None, h, :] * E).sum(-1)
                dq[:, :, h] += (dP[:, :, h, h, None] * kc[:, :, None, h, :] * E).sum(3)
                dk_[:, :, h] += (dP[:, :, h, h, None] * qc[:, :, h, None, :] * E).sum(2)
            P[:, :, I, I] = torch.where(keep, diag, 0.0)
            for j in range(i):                          # key sub-chunks before i
                J = slice(16 * j, 16 * j + 16)
                r = cum[:, :, 16 * i - 1:16 * i]
                rho = cum[:, :, 16 * j + 15:16 * j + 16]
                qbar = qc[:, :, I] * ex(cq[:, :, I] - r)
                P[:, :, I, J] = qbar @ (kc[:, :, J] * ex(r - cum[:, :, J])).transpose(-1, -2)
                dq[:, :, I] += ex(cq[:, :, I] - rho) * (dP[:, :, I, J]
                                                       @ (kc[:, :, J] * ex(rho - cum[:, :, J])))
                dk_[:, :, J] += ex(r - cum[:, :, J]) * (dP[:, :, I, J].transpose(-1, -2) @ qbar)
        dv_ = P.transpose(-1, -2) @ oc + (kc * ex(cend - cum)) @ G
        qdq = qc * dq
        if not inclusive:                               # o_{t+1} reads S_t
            qdq, qn = torch.cat([qdq[:, :, 1:], qn[:, :, None]], dim=2), qdq[:, :, 0]
        dld = torch.flip(torch.cumsum(torch.flip(qdq - kc * dk_, [2]), 2), [2]) + run[:, :, None]
        run = dld[:, :, 0]
        G = ex(cend[:, :, 0, :, None]) * G + (qc * ex(cq)).transpose(-1, -2) @ oc
        parts.append((dq, dk_, dv_, dld))

    def unchunk(i):                                     # (B, L, H, width)
        return torch.cat([p[i] for p in reversed(parts)], 2).transpose(1, 2)[:, :L]

    dq, dk_, dv_, dld = (unchunk(i) for i in range(4))
    if Hq != H:
        dq, dk_ = dq.sum(2, keepdim=True), dk_.sum(2, keepdim=True)
    if ld.shape[-1] != dk:
        dld = dld.sum(-1, keepdim=True)
    return dq, dk_, dv_, dld, None if s0 is None else G


def _subchunk_inputs(seed, chunk, form, decay):
    """Ragged (2 chunks and 10 rows), s0 and dS_final, dk 32, dv 48; ld =
    -|N(0, 1)| x 0.5 (moderate) or x 30 (strong), per channel or one a head
    (tests/test_kernels.py's draw)."""
    _, group, _ = FORMS[form]
    rng = np.random.default_rng(seed)
    B, L, H, dk, dv = 2, 2 * chunk + 10, 3, 32, 48
    Hq = 1 if group else H
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    scale = 30.0 if decay == "strong" else 0.5
    return {
        "q": f32(rng.standard_normal((B, L, Hq, dk))),
        "k": f32(rng.standard_normal((B, L, Hq, dk))),
        "v": f32(rng.standard_normal((B, L, H, dv))),
        "ld": f32(-np.abs(rng.standard_normal((B, L, H, 1 if decay == "per head" else dk)))
                  * scale),
        "do": f32(rng.standard_normal((B, L, H, dv))),
        "s0": f32(rng.standard_normal((B, H, dk, dv))),
        "dS": f32(rng.standard_normal((B, H, dk, dv))),
    }


@pytest.mark.parametrize("decay", ["moderate", "strong", "per head"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_subchunk_bwd_algebra_matches_the_closed_form(chunk, form, decay):
    """The tensor-core backward's sub-chunk algebra (f64, _subchunk_bwd_way)
    against gla_chunked_bwd in f64 (relative L2 1e-9) and jax.vjp of the
    reference's gla_chunked in f32 (relative L2 TOL), over chunks of 16, 32
    and 64, the exclusive, inclusive and group forms, moderate (x0.5) and
    strong (x30) per-channel decay and a decay per head, with a ragged tail,
    s0 and dS_final. Every output is finite, so no factor of the algebra
    overflows. Under strong decay at chunks of 32 and 64 the reference's f32
    cumulative decays (|cum| ~ 1e3, an ulp ~ 1e-4) put its own gradient up to
    2.9e-5 from the f64 closed form on these inputs: 1e-4 there."""
    inclusive = FORMS[form][0]
    a = _subchunk_inputs(chunk + len(form), chunk, form, decay)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    args = [t[n] for n in ("q", "k", "v", "ld", "s0", "do", "dS")]
    got = _subchunk_bwd_way(*args, inclusive=inclusive, chunk=chunk)
    want = gla_chunked_bwd(*(x.double() for x in args), inclusive=inclusive, chunk=chunk)
    ref = _jax_vjp(a, inclusive, chunk)
    jax_tol = 1e-4 if decay == "strong" and chunk > 16 else TOL
    for g, w, r, name in zip(got, want, ref, ("dq", "dk", "dv", "dld", "ds0")):
        assert bool(torch.isfinite(g).all()), name
        assert g.shape == w.shape and tuple(g.shape) == r.shape, name
        assert _relative_l2(g, w) <= 1e-9, name
        assert _relative_l2(g, r) <= jax_tol, name
