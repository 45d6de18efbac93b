"""Recurrent sequence mixers (port of ``repro.models.recurrent``): the
Mamba-style selective SSM of Hymba's parallel head branch and the xLSTM
cells (mLSTM matrix memory, sLSTM scalar memory).

Every time-parallel projection is a ``mor_dot`` (the MoR-quantized
GEMMs, on the port's kernels). The recurrences are plain PyTorch over the
time steps, as the reference's are plain JAX under a remat-chunked
``lax.scan``: :func:`~repro_torch.models.common.chunked_scan` in chunks
of ``SCAN_CHUNK`` steps, each under ``torch.utils.checkpoint`` in train
mode. Decode runs one step with no scan and writes the new state into
the cache it is given, in place (as attention writes the K/V lanes);
prefill returns the final state. Decode takes one token a call: the
engine prefills these families in one shot.

The arithmetic is the reference's, in its order and with its f32 / bf16
casts. Where PyTorch's activations differ in formula from JAX's they are
spelled as JAX computes them (``softplus`` is ``logaddexp(x, 0)``,
``log_sigmoid`` is ``-softplus(-x)``, f32 silu is x * sigmoid(x)); bf16
silu is ``common.activation('silu')``. Their derivatives are PyTorch's
native ones, which differ from JAX's formulas by a few ulps: a Python
autograd Function would cost a scan step more host time than its other
operations. Work that does not depend on the carry (the mLSTM's log
forget gate, the mamba mixer's dt * x) runs time-parallel before the
scan, and each stream is shaped for the step once. A Python float times a bf16 tensor rounds the float to bf16
first, as JAX's weak typing does. The f32 contractions run in full f32
(``ieee_f32_matmul``) and the divisions through
``core.formats.true_divide``. XLA's exp, log1p, tanh and logistic differ
from PyTorch's by a few ulps (and a fused multiply-add may round once
where XLA rounds twice), so the mixers agree with the reference within
a stated bound, not bit for bit (``tests/test_torch_recurrent.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import ieee_f32_matmul
from repro_torch.core.formats import true_divide
from repro_torch.core.linear import mor_dot
from repro_torch.core.policy import MoRDotPolicy

from .common import activation, chunked_scan, rms_norm

__all__ = ["mamba_mix", "mlstm_mix", "slstm_mix", "softplus",
           "log_sigmoid", "silu_f32", "SCAN_CHUNK"]

SCAN_CHUNK = 64
_F32 = torch.float32


def _tok(tok, name):
    return None if tok is None else tok[name]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), which PyTorch computes as JAX
    does, max(x, 0) + log1p(exp(-|x|)) (NaN stays NaN);
    ``torch.nn.functional.softplus`` returns x above 20."""
    return torch.logaddexp(x, x.new_zeros(()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def silu_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``jax.nn.silu``: x * logistic(x) (XLA's f32 logistic is within 2
    ulps of ``torch.sigmoid``; ``F.silu`` divides instead)."""
    return x * torch.sigmoid(x)


_silu_bf16 = activation("silu")


def _one_step(mode: str, S: int):
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"recurrent mode {mode!r}")
    if mode == "decode" and S != 1:
        raise ValueError(
            f"the recurrent mixers decode one token a call, got {S} (the "
            "engine prefills the recurrent families in one shot)")
    return mode == "decode"


def _write_state(mode: str, cache, new: Dict[str, torch.Tensor]):
    """The mixer's returned cache: prefill the new state; decode the
    given cache with the new state written into it in place."""
    if mode == "prefill":
        return new
    if mode == "decode":
        for k, v in new.items():
            cache[k].copy_(v)
        return cache
    return None


def _scan(step, init, xs, S: int, mode: str):
    """``chunked_scan`` over the time-major ``xs`` (remat in train
    mode); returns (final carry, outputs batch-major)."""
    carry, ys = chunked_scan(step, init, tuple(x.transpose(0, 1)
                                              for x in xs),
                             S, SCAN_CHUNK, remat=mode == "train")
    return carry, ys.transpose(0, 1)


# ------------------------------------------------------------------ mamba --
def _causal_dw_conv(x, w, conv_state=None):
    """Depthwise causal conv along time; x: (B, S, D), w: (cw, D). Returns
    (y in x's dtype, the trailing cw - 1 inputs: the new state)."""
    B, S, D = x.shape
    cw = w.shape[0]
    if conv_state is None:
        conv_state = x.new_zeros((B, cw - 1, D))
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = torch.zeros((B, S, D), dtype=_F32, device=x.device)
    wf = w.to(_F32)
    for i in range(cw):  # cw is tiny (4): unrolled taps
        y = y + xp[:, i:i + S].to(_F32) * wf[i]
    return y.to(x.dtype), xp[:, -(cw - 1):]


def mamba_mix(p, xn: torch.Tensor, tok, policy: MoRDotPolicy,
              cfg: ArchConfig, mode: str,
              cache: Optional[Dict[str, torch.Tensor]]):
    """Selective SSM branch: xn (B, S, d) -> (B, S, d), the cache
    ``{'h': (B, di, N) f32, 'conv': (B, cw - 1, di) bf16}`` and the stats
    of 'ssm_in' / 'ssm_out'."""
    with ieee_f32_matmul():
        return _mamba_mix(p, xn, tok, policy, cfg, mode, cache)


def _mamba_mix(p, xn, tok, policy, cfg, mode, cache):
    B, S, _ = xn.shape
    one = _one_step(mode, S)
    di, N = cfg.mamba_d_inner, cfg.ssm_state
    xz, st_in = mor_dot(xn, p["w_in"], _tok(tok, "ssm_in"), policy)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_c, new_conv = _causal_dw_conv(
        x_in, p["conv_w"], None if cache is None else cache["conv"])
    x_c = silu_f32(x_c.to(_F32))
    # The small data-dependent projections in f32 (the reference's plain
    # einsums); "bsd,dr,re->bse" contracts x with w_dt_down first, as
    # XLA's path does.
    bc = x_c @ p["w_bc"].to(_F32)
    dt_in = (x_c @ p["w_dt_down"].to(_F32)) @ p["w_dt_up"].to(_F32)
    B_t, C_t = torch.chunk(bc, 2, dim=-1)  # (B, S, N) each
    dt = softplus(dt_in + p["dt_bias"].to(_F32))  # (B, S, di)
    A = -torch.exp(p["A_log"].to(_F32))  # (di, N)
    h0 = (torch.zeros((B, di, N), dtype=_F32, device=xn.device)
          if cache is None else cache["h"].to(_F32))

    # da = exp(dt * A) and dbx = (dt * x) * B are formed inside the step
    # from the (di)- and (N)-sized streams, as in the reference; dt * x
    # is time-parallel, and each stream is shaped for the step once.
    def ssm_step(carry, inp):
        (h,) = carry
        dt_t, dtx_t, b_t, c_t = inp  # (B, di, 1) x 2, (B, 1, N), (B, N, 1)
        h = torch.addcmul(torch.exp(dt_t * A) * h, dtx_t, b_t)
        return (h,), torch.matmul(h, c_t)  # "bdn,bn->bd", (B, di, 1)

    streams = (dt[..., None], (dt * x_c)[..., None], B_t[..., None, :],
               C_t[..., None])
    if one:
        (new_h,), y = ssm_step((h0,), tuple(t[:, 0] for t in streams))
        y = y[:, None]
    else:
        (new_h,), y = _scan(ssm_step, (h0,), streams, S, mode)
    y = y[..., 0] + x_c * p["D"].to(_F32)
    y = (y * silu_f32(z.to(_F32))).to(xn.dtype)
    out, st_out = mor_dot(y, p["w_out"], _tok(tok, "ssm_out"), policy)
    new_cache = _write_state(mode, cache, {"h": new_h, "conv": new_conv})
    return out, new_cache, {"ssm_in": st_in, "ssm_out": st_out}


# ------------------------------------------------------------------ mLSTM --
def mlstm_mix(p, xn: torch.Tensor, tok, policy: MoRDotPolicy,
              cfg: ArchConfig, mode: str, cache):
    """xLSTM mLSTM block body (matrix memory, exponential gating); the
    cache ``{'C': (B, H, dh, dh), 'n': (B, H, dh), 'm': (B, H)}``, all
    f32; stats of 'up' / 'qkv' / 'down'."""
    with ieee_f32_matmul():
        return _mlstm_mix(p, xn, tok, policy, cfg, mode, cache)


def _mlstm_mix(p, xn, tok, policy, cfg, mode, cache):
    B, S, d = xn.shape
    one = _one_step(mode, S)
    H = cfg.n_heads
    di = 2 * d  # xLSTM mLSTM expansion factor 2
    dh = di // H
    up, st_up = mor_dot(xn, p["w_up"], _tok(tok, "up"), policy)
    x_i, z = torch.chunk(up, 2, dim=-1)
    qkv, st_qkv = mor_dot(x_i, p["w_qkv"], _tok(tok, "qkv"), policy)
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    q = q.reshape(B, S, H, dh)
    # dh**-0.5 rounded to the keys' dtype first (JAX's weak typing).
    k = k.reshape(B, S, H, dh) * torch.tensor(dh**-0.5, dtype=k.dtype)
    v = v.reshape(B, S, H, dh)
    # Gate pre-activations: the bf16 einsum's f32 sum, rounded once.
    gates = (x_i.to(_F32) @ p["w_gate"].to(x_i.dtype).to(_F32)).to(
        x_i.dtype).to(_F32) + p["gate_bias"].to(_F32)
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)  # (B, S, H)
    if cache is not None:
        C0, n0, m0 = (cache[n].to(_F32) for n in ("C", "n", "m"))
    else:
        C0 = torch.zeros((B, H, dh, dh), dtype=_F32, device=xn.device)
        n0 = torch.zeros((B, H, dh), dtype=_F32, device=xn.device)
        m0 = torch.full((B, H), -1e30, dtype=_F32, device=xn.device)

    # n and m are carried as (B, H, 1, dh) and (B, H, 1, 1), and each
    # stream is shaped for the step once; log_f is time-parallel.
    def step(carry, inp):
        C, n, m = carry
        q_t, k_t, v_t, i_t, lf_t = inp  # q, v (B, H, dh, 1); k (B, H, 1, dh)
        lfm = lf_t + m  # log_f + m
        m_new = torch.maximum(lfm, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(lfm - m_new)
        C = torch.addcmul(f_p * C, i_p, v_t * k_t)  # i_p * (v k^T)
        n = torch.addcmul(f_p * n, i_p, k_t)
        num = torch.matmul(C, q_t)  # "bhvk,bhk->bhv"
        den = torch.abs(torch.matmul(n, q_t))  # "bhk,bhk->bh"
        den = torch.maximum(den, torch.exp(-m_new))
        return (C, n, m_new), true_divide(num, den)

    streams = (q.to(_F32)[..., None], k.to(_F32)[..., None, :],
               v.to(_F32)[..., None], i_raw[..., None, None],
               log_sigmoid(f_raw)[..., None, None])
    init = (C0, n0[:, :, None], m0[..., None, None])
    if one:
        (C1, n1, m1), y = step(init, tuple(t[:, 0] for t in streams))
        y = y[:, None]  # (B, 1, H, dh, 1)
    else:
        (C1, n1, m1), y = _scan(step, init, streams, S, mode)
    n1, m1 = n1[:, :, 0], m1[..., 0, 0]
    y = rms_norm(y.reshape(B, -1, di).to(xn.dtype), p["out_norm"])
    y = y * _silu_bf16(z)
    out, st_dn = mor_dot(y, p["w_down"], _tok(tok, "down"), policy)
    new_cache = _write_state(mode, cache, {"C": C1, "n": n1, "m": m1})
    return out, new_cache, {"up": st_up, "qkv": st_qkv, "down": st_dn}


# ------------------------------------------------------------------ sLSTM --
def slstm_mix(p, xn: torch.Tensor, tok, policy: MoRDotPolicy,
              cfg: ArchConfig, mode: str, cache):
    """xLSTM sLSTM block body (scalar memory, block-diagonal recurrence)
    and its gated feed-forward; the cache ``{'h', 'c', 'n', 'm'}``, (B,
    d) f32 each; stats of 'wx' / 'ff1' / 'ff2'. The input projection is
    a ``mor_dot``; the per-step recurrence R runs in f32."""
    with ieee_f32_matmul():
        return _slstm_mix(p, xn, tok, policy, cfg, mode, cache)


def _slstm_mix(p, xn, tok, policy, cfg, mode, cache):
    B, S, d = xn.shape
    one = _one_step(mode, S)
    H = cfg.n_heads
    dh = d // H
    wx, st_w = mor_dot(xn, p["w_x"], _tok(tok, "wx"), policy)  # (B, S, 4d)
    wx = wx.to(_F32)
    # "bhk,hkg->bhg" then (B, 4d) is one product with R's heads on the
    # diagonal of a (d, 4d) matrix (the zeros add nothing to a sum).
    R = torch.block_diag(*p["r"].to(_F32).unbind(0))
    if cache is not None:
        h0, c0, n0, m0 = (cache[n].to(_F32) for n in ("h", "c", "n", "m"))
    else:
        h0 = torch.zeros((B, d), dtype=_F32, device=xn.device)
        c0 = torch.zeros((B, d), dtype=_F32, device=xn.device)
        n0 = torch.ones((B, d), dtype=_F32, device=xn.device)
        m0 = torch.zeros((B, d), dtype=_F32, device=xn.device)
    eps = torch.full((), 1e-6, dtype=_F32, device=xn.device)
    def step(carry, inp):
        h, c, n, m = carry
        (wx_t,) = inp
        pre = wx_t + torch.matmul(h, R)
        z_p, i_p, f_p, o_p = torch.chunk(pre, 4, dim=-1)
        lfm = log_sigmoid(f_p) + m
        m_new = torch.maximum(lfm, i_p)
        i_g = torch.exp(i_p - m_new)
        f_g = torch.exp(lfm - m_new)
        c = torch.addcmul(f_g * c, i_g, torch.tanh(z_p))
        n = torch.addcmul(i_g, f_g, n)  # f_g * n + i_g
        h = torch.sigmoid(o_p) * true_divide(c, torch.maximum(n, eps))
        return (h, c, n, m_new), h

    if one:
        (h1, c1, n1, m1), y = step((h0, c0, n0, m0), (wx[:, 0],))
        y = y[:, None]
    else:
        (h1, c1, n1, m1), y = _scan(step, (h0, c0, n0, m0), (wx,), S, mode)
    # Gated feed-forward (factor 4/3, per the xLSTM block spec).
    y = rms_norm(y.to(xn.dtype), p["out_norm"])
    hf, st_f1 = mor_dot(y, p["w_ff1"], _tok(tok, "ff1"), policy)
    g, u = torch.chunk(hf, 2, dim=-1)
    hf = _silu_bf16(g) * u
    out, st_f2 = mor_dot(hf, p["w_ff2"], _tok(tok, "ff2"), policy)
    new_cache = _write_state(mode, cache, {"h": h1, "c": c1, "n": n1,
                                           "m": m1})
    return out, new_cache, {"wx": st_w, "ff1": st_f1, "ff2": st_f2}
