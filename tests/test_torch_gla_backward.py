"""The gla_scan backward's plain version, ``ref.gla_chunked_bwd``, on the CPU.

It is the closed form the CUDA backward kernel (``csrc/gla_scan_bwd.cu``)
computes, chunk by chunk in reverse. Held against torch autograd of the
port's ``models.linear_scan.gla_chunked`` in f64 (to 1e-10 relative L2) and
against ``jax.vjp`` of the reference's ``repro.models.linear_scan.gla_chunked``
in f32 (``tests/test_kernels.py``'s TOL, 2e-5), in rwkv6's exclusive form
(one decay a channel), the inclusive form and zamba2's (inclusive, q and k
one group broadcast over the heads, one decay a head); ragged L, an initial
state and a final-state gradient, strong and weak decay. Inputs are made with
numpy from a seed and handed to both sides. The kernel itself runs only on
the card (``tests/test_torch_cuda.py``).
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
