"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

These are what a CPU tensor runs and what ``backend='torch'`` asks for
on a CUDA tensor; ``chip_smoke.py`` holds each CUDA kernel against them.
They follow the JAX references op for op, so on the CPU they agree with
``repro.kernels.ref`` byte for byte on every decision and payload lane.

``quantize_pack_ref.calls``, ``mixed_gemm_ref.calls``,
``mor_select_ref.calls``, ``quant_err_ref.calls``, ``gam_quant_ref.calls``,
``fp8_gemm_ref.calls`` and ``flash_attention_ref.calls`` count the
calls, so a run can show its main path never took a plain version. The
last two agree with the reference to within f32 summation order (their
matmuls sum in PyTorch's order, XLA's in its own).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.device import ieee_f32_matmul
from repro_torch.core.formats import (
    E2M1_AMAX,
    E4M3,
    E5M2,
    NVFP4,
    NVFP4_MICRO,
    FormatSpec,
    cast_to_format,
    decode_e2m1,
    encode_e2m1,
    round_to_e2m1,
    true_divide,
)
from repro_torch.core.gam import compute_scales, scales_from_bmax
from repro_torch.core.metrics import E5M2_RANGE_RATIO, NVFP4_RANGE_RATIO
from repro_torch.core.partition import Partition, _pad2d, from_blocks, to_blocks

__all__ = [
    "TAG_E4M3", "TAG_E5M2", "TAG_BF16", "TAG_NVFP4", "MorSelect",
    "expand_micro_onehot",
    "QuantErr", "MixedOperand", "nvfp4_block_capable", "pack_mixed",
    "passthrough_mixed", "activation_row_block", "decode_mixed_ref",
    "mixed_gemm_ref", "mor_select_ref", "quantize_pack_ref",
    "quant_err_ref", "gam_quant_ref", "fp8_gemm_ref", "flash_attention_ref",
]

# Per-block representation tags (the contract between selection,
# packing and the mixed GEMM).
TAG_E4M3 = 0
TAG_E5M2 = 1
TAG_BF16 = 2
TAG_NVFP4 = 3


def nvfp4_block_capable(block: Tuple[int, int]) -> bool:
    """Even rows (nibble packing pairs rows) and 16-divisible columns
    (micro scales group NVFP4_MICRO contraction elements)."""
    br, bk = block
    return br % 2 == 0 and bk % NVFP4_MICRO == 0


def expand_micro_onehot(d: torch.Tensor, bk: int, g0) -> torch.Tensor:
    """(rows, G) per-micro-group row stripe -> (rows, bk) for the block
    whose first group index is ``g0``, through an f32 matmul with a
    one-hot (G, bk) matrix: each output sums its one group value and
    zeros, so for finite values it equals a repeat bit for bit (a
    nonfinite value spreads over its row, as in the reference's
    ``dot_general``). Run in full f32 whatever the caller's TF32
    setting."""
    G = d.shape[-1]
    r = torch.arange(G, device=d.device)[:, None]
    c = torch.arange(bk, device=d.device)[None, :]
    onehot = (g0 + torch.div(c, NVFP4_MICRO, rounding_mode="floor")
              == r).to(torch.float32)
    with ieee_f32_matmul():
        return d.to(torch.float32) @ onehot


def _nib_compact_shape(block: Tuple[int, int]) -> Tuple[int, int]:
    return (max(block[0] // 2, 1), block[1])


def _ms_compact_shape(block: Tuple[int, int]) -> Tuple[int, int]:
    return (block[0], max(block[1] // NVFP4_MICRO, 1))


class MorSelect(NamedTuple):
    """One sub-tensor selection event (fields as in the reference)."""

    y: Optional[torch.Tensor]
    sel: torch.Tensor
    e4_sums: torch.Tensor
    e5_sums: torch.Tensor
    counts: torch.Tensor
    group_amax: torch.Tensor
    group_mantissa: torch.Tensor
    nv_sums: Optional[torch.Tensor] = None


class QuantErr(NamedTuple):
    """One fused quantize + error event (fields as in the reference):
    ``y`` (M, K) fake-quantized in the input dtype, per-block ``err_sums``
    and nonzero ``counts`` (nm, nk) f32, the group amax and the shared
    mantissa m_g (1.0 for the ablation algos)."""

    y: torch.Tensor
    err_sums: torch.Tensor
    counts: torch.Tensor
    group_amax: torch.Tensor
    group_mantissa: torch.Tensor


@dataclasses.dataclass
class MixedOperand:
    """One GEMM operand in the mixed-representation block layout.

    The (R, K) quantization view (contraction last), zero-padded to a
    multiple of ``block``: ``payload_q`` (Rp, Kp) u8 fp8 bits,
    ``payload_bf16`` (Rp, Kp) original values, ``payload_nib`` (Rp/2,
    Kp) u8 row-halves-packed E2M1 nibbles, ``micro_scales`` (Rp, Kp/16)
    u8 E4M3 bits, ``tags`` (nr, nk) int32 and ``scales`` (nr, nk) f32.
    Any payload lane may be *compact* (one don't-care block) when no tag
    references it. Leading axes (a layer-stacked weight) precede every
    lane's last two.
    """

    payload_q: torch.Tensor
    payload_bf16: torch.Tensor
    tags: torch.Tensor
    scales: torch.Tensor
    block: Tuple[int, int]
    shape: Tuple[int, int]
    payload_nib: Optional[torch.Tensor] = None
    micro_scales: Optional[torch.Tensor] = None
    has_nvfp4: Optional[bool] = None

    def __post_init__(self):
        lead = tuple(self.tags.shape[:-2])
        dev = self.tags.device
        if self.payload_nib is None:
            self.payload_nib = torch.zeros(
                (*lead, *_nib_compact_shape(self.block)), dtype=torch.uint8,
                device=dev,
            )
        if self.micro_scales is None:
            self.micro_scales = torch.zeros(
                (*lead, *_ms_compact_shape(self.block)), dtype=torch.uint8,
                device=dev,
            )

    def stack_index(self, i: int) -> "MixedOperand":
        """The pack of entry ``i`` of a stacked operand (a layer of a
        layer-stacked weight, an expert of an expert stack): views of
        every lane's entry ``i``."""
        return dataclasses.replace(self, **{
            k: getattr(self, k)[i] for k in (
                "payload_q", "payload_bf16", "tags", "scales",
                "payload_nib", "micro_scales")})

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return (self.tags.shape[-2] * self.block[0],
                self.tags.shape[-1] * self.block[1])

    @property
    def device(self) -> torch.device:
        return self.tags.device

    def compact(self) -> "MixedOperand":
        """Drop every payload lane no tag references down to one
        don't-care block (host-side: reads the tags)."""
        tags = self.tags.cpu().numpy()
        br, bk = self.block
        lead = tuple(self.payload_q.shape[:-2])
        dev = self.device
        out = dataclasses.replace(
            self, has_nvfp4=bool((tags == TAG_NVFP4).any())
        )
        if not ((tags == TAG_E4M3) | (tags == TAG_E5M2)).any():
            out = dataclasses.replace(out, payload_q=torch.zeros(
                (*lead, br, bk), dtype=torch.uint8, device=dev))
        if not (tags == TAG_BF16).any():
            out = dataclasses.replace(out, payload_bf16=torch.zeros(
                (*lead, br, bk), dtype=self.payload_bf16.dtype, device=dev))
        if not (tags == TAG_NVFP4).any():
            out = dataclasses.replace(
                out,
                payload_nib=torch.zeros(
                    (*lead, *_nib_compact_shape(self.block)),
                    dtype=torch.uint8, device=dev),
                micro_scales=torch.zeros(
                    (*lead, *_ms_compact_shape(self.block)),
                    dtype=torch.uint8, device=dev),
            )
        return out

    def transpose(self) -> "MixedOperand":
        """The transposed quantization view: tags, scales and the fp8 and
        BF16 lanes permute with the blocks (exact), made contiguous for
        the GEMM kernel. NVFP4 blocks are not transpose-invariant (their
        nibble pairing and 1x16 micro blocks follow the contraction
        axis), so a pack with dense sub-byte lanes or an NVFP4 tag is
        refused: re-quantize the transposed view instead."""
        if self.tags.ndim != 2:
            raise ValueError("transpose() is for single-matrix operands; "
                             "slice a stacked operand per layer first")
        nr, nk = self.tags.shape
        dense_nib = (nr > 1 or nk > 1) and tuple(self.payload_nib.shape) \
            == (self.padded_shape[0] // 2, self.padded_shape[1])
        if dense_nib or bool((self.tags == TAG_NVFP4).any()):
            raise ValueError(
                "cannot transpose a pack with NVFP4 payload lanes: micro "
                "scales are contraction-directed (re-quantize the "
                "transposed view)")
        block_t = (self.block[1], self.block[0])
        return MixedOperand(
            payload_q=self.payload_q.T.contiguous(),
            payload_bf16=self.payload_bf16.T.contiguous(),
            tags=self.tags.T.contiguous(),
            scales=self.scales.T.contiguous(),
            block=block_t,
            shape=(self.shape[1], self.shape[0]),
            has_nvfp4=False,
        )

    def dequant(self) -> torch.Tensor:
        """Stored (Fig. 4: original-dtype) values, unpadded (R, K)."""
        R, K = self.shape
        return decode_mixed_ref(self)[:R, :K]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Raw bytes of an fp8 tensor as uint8."""
    return t.view(torch.uint8)


def _nvfp4_lanes(xf, s_nv, tags, block):
    """(nib blocks (nr, nk, br/2, bk), micro-scale blocks (nr, nk, br,
    bk/16)) of the NVFP4 candidate, zeroed outside TAG_NVFP4 blocks."""
    nr, nk = xf.shape[:2]
    br, bk = block
    ng = bk // NVFP4_MICRO
    xs = xf * s_nv[:, :, None, None]
    g = xs.reshape(nr, nk, br, ng, NVFP4_MICRO)
    d = true_divide(torch.amax(g.abs(), dim=-1), E2M1_AMAX)
    d_q = cast_to_format(d, E4M3)
    safe_d = torch.where(d_q > 0, d_q, torch.ones_like(d_q))
    q = round_to_e2m1(g / safe_d[..., None]).reshape(nr, nk, br, bk)
    codes = encode_e2m1(q)
    nib = (codes[:, :, : br // 2, :] | (codes[:, :, br // 2:, :] << 4)).to(
        torch.uint8)
    ms = _bits(safe_d.to(torch.float8_e4m3fn))
    is_nv = (tags == TAG_NVFP4)[:, :, None, None]
    zero = torch.zeros((), dtype=torch.uint8, device=xf.device)
    return torch.where(is_nv, nib, zero), torch.where(is_nv, ms, zero)


def pack_mixed(x2d: torch.Tensor, tags: torch.Tensor,
               block: Tuple[int, int], algo: str = "gam",
               group_amax: Optional[torch.Tensor] = None,
               with_nvfp4: bool = False) -> MixedOperand:
    """Real-quantize a 2-D operand into the mixed block layout under the
    per-block ``tags`` (same scales and saturating casts as the
    fake-quantization path)."""
    br, bk = block
    xp = _pad2d(x2d, br, bk)
    xb = to_blocks(xp, Partition("block", (br, bk)))
    nr, nk = xb.shape[:2]
    if tuple(tags.shape) != (nr, nk):
        raise ValueError(f"tags {tuple(tags.shape)} != grid {(nr, nk)}")

    bmax = torch.amax(xb.abs(), dim=(2, 3)).to(torch.float32)
    s4 = scales_from_bmax(bmax, E4M3, algo, group_amax=group_amax).scale
    s5 = scales_from_bmax(bmax, E5M2, algo, group_amax=group_amax).scale
    xf = xb.to(torch.float32)

    def bits(scale, fmt):
        xs = torch.clamp(xf * scale[:, :, None, None], -fmt.amax, fmt.amax)
        return _bits(xs.to(fmt.dtype))

    t = tags[:, :, None, None]
    zero8 = torch.zeros((), dtype=torch.uint8, device=xb.device)
    payload_q = torch.where(
        t == TAG_E4M3, bits(s4, E4M3),
        torch.where(t == TAG_E5M2, bits(s5, E5M2), zero8),
    )
    payload_bf16 = torch.where(t == TAG_BF16, xb, torch.zeros_like(xb))
    one = torch.ones((), dtype=torch.float32, device=xb.device)
    scales = torch.where(tags == TAG_E4M3, s4,
                         torch.where(tags == TAG_E5M2, s5, one))

    padded = (nr * br, nk * bk)
    if with_nvfp4:
        if not nvfp4_block_capable(block):
            raise ValueError(
                f"NVFP4 packing needs an even-row, {NVFP4_MICRO}-"
                f"divisible-column block, got {block} (the sub4 recipe "
                "aligns its partition to (2, 16) automatically)"
            )
        s_nv = scales_from_bmax(bmax, NVFP4, algo,
                                group_amax=group_amax).scale
        nib, ms = _nvfp4_lanes(xf, s_nv, tags, block)
        scales = torch.where(tags == TAG_NVFP4, s_nv, scales)
        payload_nib = from_blocks(nib, (padded[0] // 2, padded[1]))
        micro_scales = from_blocks(ms, (padded[0], padded[1] // NVFP4_MICRO))
    else:
        payload_nib = micro_scales = None
    return MixedOperand(
        payload_q=from_blocks(payload_q, padded).contiguous(),
        payload_bf16=from_blocks(payload_bf16, padded).contiguous(),
        tags=tags.to(torch.int32),
        scales=scales.to(torch.float32),
        block=(br, bk),
        shape=tuple(x2d.shape),
        payload_nib=None if payload_nib is None
        else payload_nib.contiguous(),
        micro_scales=None if micro_scales is None
        else micro_scales.contiguous(),
        has_nvfp4=with_nvfp4,
    )


def passthrough_mixed(x2d: torch.Tensor,
                      block: Tuple[int, int]) -> MixedOperand:
    """All-BF16 mixed layout of an unquantized operand (the activation
    side of a serving GEMM); the fp8 and sub-byte lanes are compact."""
    br, bk = block
    xp = _pad2d(x2d, br, bk).contiguous()
    nr, nk = xp.shape[0] // br, xp.shape[1] // bk
    dev = x2d.device
    return MixedOperand(
        payload_q=torch.zeros((br, bk), dtype=torch.uint8, device=dev),
        payload_bf16=xp,
        tags=torch.full((nr, nk), TAG_BF16, dtype=torch.int32, device=dev),
        scales=torch.ones((nr, nk), dtype=torch.float32, device=dev),
        block=(br, bk),
        shape=tuple(x2d.shape),
        has_nvfp4=False,
    )


def activation_row_block(m: int, bk: int) -> int:
    """Row block of a passthrough activation pack: rows padded to 16,
    never to a full 128-row block (decode has a handful of rows)."""
    return min(bk, -(-m // 16) * 16)


def _full_buffer(buf, padded_shape, dtype):
    """A compact lane decodes as zeros (no tag references it)."""
    if tuple(buf.shape) == tuple(padded_shape):
        return buf
    return torch.zeros(padded_shape, dtype=dtype, device=buf.device)


def decode_mixed_ref(mo: MixedOperand) -> torch.Tensor:
    """Padded (Rp, Kp) stored values in the operand's original dtype."""
    br, bk = mo.block
    Rp, Kp = mo.padded_shape
    st = mo.payload_bf16.dtype
    part = Partition("block", (br, bk))
    qb = to_blocks(_full_buffer(mo.payload_q, (Rp, Kp), torch.uint8), part)
    q4 = qb.view(torch.float8_e4m3fn).to(torch.float32)
    q5 = qb.view(torch.float8_e5m2).to(torch.float32)
    t = mo.tags[:, :, None, None]
    s = mo.scales[:, :, None, None]
    f8 = (torch.where(t == TAG_E5M2, q5, q4) / s).to(st)
    bfb = to_blocks(_full_buffer(mo.payload_bf16, (Rp, Kp), st), part)
    yb = torch.where(t == TAG_BF16, bfb, f8)
    if nvfp4_block_capable(mo.block):
        nibb = to_blocks(
            _full_buffer(mo.payload_nib, (Rp // 2, Kp), torch.uint8),
            Partition("block", (br // 2, bk)),
        ).to(torch.int32)
        vals = torch.cat(
            [decode_e2m1(nibb & 15), decode_e2m1(nibb >> 4)], dim=2
        )
        msb = to_blocks(
            _full_buffer(mo.micro_scales, (Rp, Kp // NVFP4_MICRO),
                         torch.uint8),
            Partition("block", (br, bk // NVFP4_MICRO)),
        )
        d = msb.contiguous().view(torch.float8_e4m3fn).to(torch.float32)
        d_exp = torch.repeat_interleave(d, NVFP4_MICRO, dim=3)
        nv = ((vals * d_exp) / s).to(st)
        yb = torch.where(t == TAG_NVFP4, nv, yb)
    return from_blocks(yb, (Rp, Kp))


def mixed_gemm_ref(a: MixedOperand, b: MixedOperand,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """C = A @ B^T, unpadded (M, N): both operands decoded to their
    stored values, f32 accumulation one K block at a time."""
    mixed_gemm_ref.calls += 1
    if a.block[1] != b.block[1] or a.padded_shape[1] != b.padded_shape[1]:
        raise ValueError(
            f"contraction blocks differ: {a.block}/{a.padded_shape} vs "
            f"{b.block}/{b.padded_shape}"
        )
    bk = a.block[1]
    M, N = a.shape[0], b.shape[0]
    A = decode_mixed_ref(a)[:M].to(torch.float32)
    B = decode_mixed_ref(b)[:N].to(torch.float32)
    acc = torch.zeros((M, N), dtype=torch.float32, device=A.device)
    for k0 in range(0, a.padded_shape[1], bk):
        # Each K block's dot sums its products in k order, as the
        # reference's XLA dot does on the CPU (bf16 products are exact
        # in f32, so this reproduces its f32 sums bit for bit).
        blk = torch.zeros_like(acc)
        for k in range(k0, k0 + bk):
            blk = blk + A[:, k, None] * B[None, :, k]
        acc = acc + blk
    return acc.to(out_dtype)


mixed_gemm_ref.calls = 0


def _blocked_quant_err(xb: torch.Tensor, fmt: FormatSpec, algo: str,
                       group_amax=None):
    """Quantize + per-block error sums on a blocked view (nm, nk, bm,
    bk) in its original dtype: (xqb, scales, err_sums, counts)."""
    bmax = torch.amax(xb.abs(), dim=(2, 3)).to(torch.float32)
    scales = scales_from_bmax(bmax, fmt, algo, group_amax=group_amax)
    s = scales.scale[:, :, None, None]
    xqb = (cast_to_format(xb.to(torch.float32) * s, fmt) / s).to(xb.dtype)
    xf = xb.to(torch.float32)
    nz = xf != 0.0
    err = torch.where(
        nz,
        ((xf - xqb.to(torch.float32))
         / torch.where(nz, xf, torch.ones_like(xf))).abs(),
        torch.zeros_like(xf),
    )
    return (xqb, scales, err.sum(dim=(2, 3)),
            nz.sum(dim=(2, 3)).to(torch.float32))


def _select(x: torch.Tensor, part: Partition, mode: str, algo: str,
            want_y: bool, group_amax=None) -> MorSelect:
    if mode not in ("sub2", "sub3", "sub4"):
        raise ValueError(f"unknown selection mode {mode!r}")
    xb = to_blocks(x, part)
    q4b, scales4, e4_sums, counts = _blocked_quant_err(xb, E4M3, algo,
                                                       group_amax)
    q5b, _, e5_sums, _ = _blocked_quant_err(xb, E5M2, algo, group_amax)

    m1 = e4_sums < e5_sums  # Eq. 3
    use_nv = nv_sums = qnb = None
    if mode == "sub2":
        use5 = torch.zeros_like(m1)
    else:
        xabs = xb.abs()
        anynz = counts > 0
        bmax = torch.amax(xabs, dim=(2, 3)).to(torch.float32)
        big = torch.tensor(torch.finfo(xb.dtype).max, dtype=xb.dtype,
                           device=xb.device)
        bmin = torch.amin(torch.where(xb != 0, xabs, big),
                          dim=(2, 3)).to(torch.float32)
        one = torch.ones_like(bmax)
        ratio = torch.where(anynz, bmax / torch.where(anynz, bmin, one), one)
        use5 = (~m1) & (ratio < E5M2_RANGE_RATIO)
        if mode == "sub4":
            qnb, _, nv_sums, _ = _blocked_quant_err(xb, NVFP4, algo,
                                                    group_amax)
            nm_, nk_, bm_, bk_ = xb.shape
            xbg = xb.to(torch.float32)
            pad_g = (-bk_) % NVFP4_MICRO
            if pad_g:
                xbg = torch.cat(
                    [xbg, xbg.new_zeros((nm_, nk_, bm_, pad_g))], dim=-1)
            ga = torch.amax(
                xbg.abs().reshape(nm_, nk_, bm_, -1, NVFP4_MICRO), dim=-1)
            big32 = torch.tensor(torch.finfo(torch.float32).max,
                                 device=xb.device)
            ga_min = torch.amin(torch.where(ga > 0, ga, big32), dim=(2, 3))
            g_ratio = torch.where(
                anynz, bmax / torch.where(anynz, ga_min, one), one)
            use_nv = (nv_sums < e4_sums) & (g_ratio < NVFP4_RANGE_RATIO)

    sel = torch.where(m1, 0, torch.where(use5, 1, 2)).to(torch.int32)
    if use_nv is not None:
        sel = torch.where(use_nv, TAG_NVFP4, sel).to(torch.int32)
    y = None
    if want_y:
        yb = torch.where(m1[:, :, None, None], q4b,
                         torch.where(use5[:, :, None, None], q5b, xb))
        if use_nv is not None:
            yb = torch.where(use_nv[:, :, None, None], qnb, yb)
        y = from_blocks(yb, tuple(x.shape))
    return MorSelect(y, sel, e4_sums, e5_sums, counts, scales4.group_amax,
                     scales4.group_mantissa, nv_sums)


def mor_select_ref(x: torch.Tensor, part: Partition, mode: str = "sub3",
                   algo: str = "gam", group_amax=None) -> MorSelect:
    """Per-block sub2/sub3/sub4 selection with the fake-quant output
    ``y``: each block's winning candidate as stored (in x's dtype), the
    NVFP4 snap included under sub4; BF16 blocks keep their input values.
    ``group_amax``: the raw group amax to scale by where x is a stripe of
    block rows of a larger operand or one rank's shard of it (its blocks
    then decide as they do in the whole; ``MoRPolicy.mesh_axes``); by
    default x's own."""
    mor_select_ref.calls += 1
    return _select(x, part, mode, algo, want_y=True, group_amax=group_amax)


mor_select_ref.calls = 0


def quant_err_ref(x: torch.Tensor, part: Partition, fmt: FormatSpec,
                  algo: str = "gam", group_amax=None) -> QuantErr:
    """Plain version of the one-format event behind the 'tensor' and
    'e4m3' recipes: fake-quantize under Alg. 1 scales, per-block error
    sums on the stored values and nonzero counts. ``group_amax`` as in
    :func:`mor_select_ref`."""
    quant_err_ref.calls += 1
    xb = to_blocks(x, part)
    xqb, scales, err_sums, counts = _blocked_quant_err(xb, fmt, algo,
                                                       group_amax)
    return QuantErr(from_blocks(xqb, tuple(x.shape)), err_sums, counts,
                    scales.group_amax, scales.group_mantissa)


quant_err_ref.calls = 0


def gam_quant_ref(x: torch.Tensor, part: Partition, fmt: FormatSpec,
                  algo: str = "gam"):
    """Plain version of the ``gam_quant`` kernel: (xq in x.dtype,
    block_exp (nm, nk) int32, err_sums, counts (nm, nk) f32)."""
    gam_quant_ref.calls += 1
    scales = compute_scales(x, part, fmt, algo=algo)
    xb = to_blocks(x.to(torch.float32), part)
    s = scales.scale[:, :, None, None]
    xqb = true_divide(cast_to_format(xb * s, fmt), s)
    xq = from_blocks(xqb, tuple(x.shape)).to(x.dtype)
    xqb = to_blocks(xq.to(torch.float32), part)
    nz = xb != 0
    err = torch.where(
        nz, ((xb - xqb) / torch.where(nz, xb, torch.ones_like(xb))).abs(),
        torch.zeros_like(xb))
    return (xq, scales.block_exp, err.sum(dim=(2, 3)),
            nz.sum(dim=(2, 3)).to(torch.float32))


gam_quant_ref.calls = 0


def quantize_pack_ref(x: torch.Tensor, part: Partition, mode: str = "sub3",
                      algo: str = "gam", group_amax=None):
    """Plain version of the pack-emitting selection kernel: selection,
    then ``pack_mixed`` over its tags. Returns (MixedOperand, MorSelect
    with y=None). ``group_amax`` as in :func:`mor_select_ref`."""
    quantize_pack_ref.calls += 1
    r = _select(x, part, mode, algo, want_y=False, group_amax=group_amax)
    block = part.resolve(tuple(x.shape))
    mo = pack_mixed(x, r.sel, block, algo, group_amax=r.group_amax,
                    with_nvfp4=(mode == "sub4"))
    return mo, r


quantize_pack_ref.calls = 0


def compact_lane_shapes(block: Tuple[int, int]):
    """Compact (one-block) shapes of the (q/bf16, nib, ms) lanes."""
    return (tuple(block), _nib_compact_shape(block),
            _ms_compact_shape(block))


def fp8_gemm_ref(a_q: torch.Tensor, b_q: torch.Tensor, a_scale: torch.Tensor,
                 b_scale: torch.Tensor, block=(128, 128, 128),
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the per-block-scaled fp8 GEMM: every payload
    element dequantized in f32 by an IEEE division by its block's scale,
    then one f32 matmul, cast to ``out_dtype``. a_q (M, K) and b_q (K, N)
    fp8; a_scale (M/bm, K/bk), b_scale (K/bk, N/bn) f32."""
    fp8_gemm_ref.calls += 1
    bm, bn, bk = block
    M, K = a_q.shape
    N = b_q.shape[1]
    a = a_q.to(torch.float32).reshape(M // bm, bm, K // bk, bk)
    a = true_divide(a, a_scale[:, None, :, None])
    b = b_q.to(torch.float32).reshape(K // bk, bk, N // bn, bn)
    b = true_divide(b, b_scale[:, None, :, None])
    return (a.reshape(M, K) @ b.reshape(K, N)).to(out_dtype)


fp8_gemm_ref.calls = 0


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, q_offset: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention of the flash kernel. q (BH, S, d), k / v
    (BH, T, d); returns (BH, S, d) in q.dtype.

    ``q_offset``: (BH,) int32 key position of each row's query 0, as
    ``kernels.flash_attention.flash_offsets`` normalizes it; ignored when
    not causal. Scores are an f32 einsum scaled by d^-0.5 afterwards;
    masked scores are -1e30, so a row with no visible key (offset + row
    < 0) gets the mean of v over all T keys."""
    flash_attention_ref.calls += 1
    BH, S, d = q.shape
    T = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * (d ** -0.5)
    if causal:
        q_pos = q_offset[:, None] + torch.arange(S, device=q.device)
        mask = (torch.arange(T, device=q.device)[None, None, :]
                <= q_pos[:, :, None])
        s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)


flash_attention_ref.calls = 0
