"""Shared building blocks: norms, RoPE, SwiGLU MLP, initializers (port of
``src/repro/models/layers.py``).

Conventions across the port's model stack, the reference's numbers:
  * parameters are stored in f32 and cast to the activation dtype at each
    use; activations are bf16.  Where the reference asks for an f32 result
    of bf16 operands (``preferred_element_type=jnp.float32``), the port
    upcasts the operands and multiplies in f32 (TF32 stays off), so the
    result is never rounded to bf16;
  * every sublayer is pre-norm + residual;
  * weight layouts are the reference's: ``(in, out)``, the wide axis last.
"""

from __future__ import annotations

import math

import torch
from torch import nn

COMPUTE_DTYPE = torch.bfloat16


def he_init(
    shape: tuple[int, ...],
    generator: torch.Generator,
    scale: float = 1.0,
    device=None,
) -> torch.Tensor:
    """f32 normal with std ``scale / sqrt(fan_in)``, drawn from
    ``generator`` (which must live on ``device``)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / (fan_in**0.5)
    t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return t.mul_(std)


def param(
    shape: tuple[int, ...],
    generator: torch.Generator | None,
    device=None,
    *,
    scale: float = 1.0,
    fill: float | None = None,
) -> nn.Parameter:
    """An f32 parameter, frozen until a trainer marks it trained
    (``Model.trainable``): ``fill`` everywhere (norm weights, biases),
    else He-initialised from ``generator``, else left empty (to be loaded,
    e.g. from ``convert.from_jax_params``)."""
    if fill is not None:
        t = torch.full(shape, fill, dtype=torch.float32, device=device)
    elif generator is None:
        t = torch.empty(shape, dtype=torch.float32, device=device)
    else:
        t = he_init(shape, generator, scale, device)
    return nn.Parameter(t, requires_grad=False)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def layer_norm(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * w.to(dt) + b.to(dt)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: JAX lowers it to ``1 / (1 + exp(-x))`` in every
    dtype, each op rounded to x's dtype; spelled out the same way, the
    port's bf16 numbers are the reference's (``torch.sigmoid`` rounds
    once, and differs in ~1/3 of the bf16 values)."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * jax.nn.sigmoid(x)``."""
    return x * sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``jnp.logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))`` with no threshold (``F.softplus``
    returns ``x`` above 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s product of two dtypes: both operands cast to the
    wider one (a bf16 weight against f32 activations multiplies in f32;
    ``torch.matmul`` refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, as the reference
    evaluates it: in x's dtype, its constants rounded to that dtype, every
    op rounded (``F.gelu(approximate="tanh")`` rounds once, and differs in
    about half of the bf16 values)."""
    c = torch.tensor(math.sqrt(2 / math.pi), device=x.device).to(x.dtype)
    k = torch.tensor(0.044715, device=x.device).to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, d_head: int, theta: float):
    """positions (...,) -> cos/sin (..., d_head/2) in f32."""
    half = d_head // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta**exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, d_head); cos/sin (..., S, d_head/2), cast to x's
    dtype before they multiply."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def sinusoidal_positions(n: int, d: int) -> torch.Tensor:
    """Classic transformer sinusoids (whisper-style encoder)."""
    pos = torch.arange(n, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU weights; ``norm`` adds the pre-norm weight of a dense FFN
    sublayer (a MoE's shared experts have none)."""

    def __init__(
        self,
        d_model: int,
        d_ff: int,
        generator: torch.Generator | None = None,
        device=None,
        *,
        norm: bool = False,
    ):
        super().__init__()
        self.w_gate = param((d_model, d_ff), generator, device)
        self.w_up = param((d_model, d_ff), generator, device)
        self.w_down = param((d_ff, d_model), generator, device)
        if norm:
            self.norm = param((d_model,), None, device, fill=1.0)


def apply_mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = x @ p.w_gate.to(dt)
    u = x @ p.w_up.to(dt)
    return (silu(g) * u) @ p.w_down.to(dt)
