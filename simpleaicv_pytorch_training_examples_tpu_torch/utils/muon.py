"""Muon update math.

Counterpart of the JAX package's ``utils/muon.py``: momentum SGD followed by
the quintic Newton-Schulz orthogonalisation of the update of every 2-D (or
larger) parameter, with the ``0.2 * sqrt(max(A, B))`` lr adjustment; the
optimizer (``utils/optimizers.py``) takes AdamW for the rest.

The iteration runs in bf16 as the JAX package's does: the matrix is cast to
bf16 and normalised by its Frobenius norm, each of the five steps' three
products is a bf16 ``torch.matmul`` (bf16 out), every scale and add rounds
to bf16 (the quintic's coefficients too, as JAX rounds them), and the
result is cast to the input's dtype only at the end. The
products are plain matrix products, as in the JAX package, where no Pallas
kernel computes them.

The matrix a parameter is orthogonalised as is the JAX package's view up to
a permutation of rows, whose result is the same permutation of the JAX
result: a Linear weight [out, in] is taken as its transpose [in, out] (Flax's
Dense kernel), a convolution [O, I, kh, kw] as [I * kh * kw, O] (JAX
flattens HWIO to [kh * kw * I, O]), and any other parameter as
``reshape(-1, shape[-1])``, as JAX does. So ``max(A, B)`` and the decision
to transpose the wide way are JAX's.
"""

import torch

__all__ = ["newton_schulz5", "muon_update", "muon_matrix", "from_muon_matrix"]

_NS_COEFFS = (3.4445, -4.7750, 2.0315)
# JAX rounds a Python scalar to a bf16 array's dtype before it multiplies;
# torch would multiply by the fp32 value, so the coefficients are rounded
# here
_NS_COEFFS_BF16 = tuple(float(torch.tensor(v, dtype=torch.bfloat16))
                        for v in _NS_COEFFS)


def newton_schulz5(g: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Orthogonalise a matrix [A, B] (or a stack [..., A, B] of them) with
    the quintic Newton-Schulz iteration in bf16; returns ~U S' V^T (S'
    diagonal in [0.5, 1.5]) in g's dtype."""
    a, b, c = _NS_COEFFS_BF16
    x = g.to(torch.bfloat16)
    transposed = g.shape[-2] > g.shape[-1]
    if transposed:
        x = x.mT
    norm = torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    x = x / (norm + 1e-7)
    for _ in range(steps):
        aa = torch.matmul(x, x.mT)
        bb = b * aa + c * torch.matmul(aa, aa)
        x = a * x + torch.matmul(bb, x)
    if transposed:
        x = x.mT
    return x.to(g.dtype)


def muon_matrix(t: torch.Tensor, out_first: bool) -> torch.Tensor:
    """The 2-D view of a parameter-shaped tensor that Muon orthogonalises:
    ``out_first`` for the weight of a Linear or a convolution (output
    channels first), whose view is [fan in, out]; else ``reshape(-1,
    shape[-1])``."""
    if out_first:
        return t.reshape(t.shape[0], -1).mT
    return t.reshape(-1, t.shape[-1])


def from_muon_matrix(m: torch.Tensor, shape, out_first: bool) -> torch.Tensor:
    """Inverse of ``muon_matrix``."""
    if out_first:
        return m.mT.reshape(shape)
    return m.reshape(shape)


def muon_update(grad, buf, momentum: float, nesterov: bool, ns_steps: int,
                out_first: bool = False):
    """One Muon update of one parameter, as the JAX package's: returns
    (orthogonalised update scaled by 0.2 * sqrt(max(A, B)), new momentum
    buffer). The caller applies the lr and the decoupled weight decay."""
    new_buf = momentum * buf + grad
    eff = grad + momentum * new_buf if nesterov else new_buf
    ortho = newton_schulz5(muon_matrix(eff, out_first), ns_steps)
    adjusted = 0.2 * max(ortho.shape) ** 0.5
    return from_muon_matrix(ortho * adjusted, eff.shape, out_first), new_buf
