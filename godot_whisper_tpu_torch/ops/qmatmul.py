"""K9/K10: weight-only quantized matmuls (csrc/qmatmul.cu) and their plain
versions, with the int8 / int4 weight containers.

Counterpart of the JAX package's ``ops/qmatmul.py``: ``quant_matmul`` (TPU
kernel ``_qmm_kernel``, int8 weights with per-output-channel f32 scales) and
``quant_matmul4`` (TPU kernel ``_q4mm_kernel``, int4 weights nibble-packed
along the contraction axis with f32 scales per group of rows).  Decode reads
every decoder weight once per step, so the weight bytes bound it; storing
them in 8 or 4 bits halves or quarters that read, as long as the kernel turns
them into bf16 on chip and never writes a dequantized copy to device memory.

Layouts (the JAX package's):

- ``io``: int8 weight (S_in, O_out), scales (O,): ``x @ W`` projections;
- ``oi``: int8 weight (O_out, S_in), scales (O,): the token embedding (V, S),
  whose one int8 buffer serves the embedding gather and the logits;
- int4 (``Quant4Tensor``): q (S/2, O) uint8, s (S/G, O) f32.  Within group
  g, byte row r holds weight row gG + r in its low nibble and gG + G/2 + r in
  its high nibble, each stored +8 in [0, 15].

Both containers are NamedTuples whose ``[i]`` is tuple indexing, so code
that slices per-layer leaves must call ``.layer(li)`` (``qlayer``), never
``[li]``.

K9 takes one of three routes on the card (``quant_matmul.route_launches``):
``io_rows`` (``io``, at most 16 rows: the contraction axis split across
a cluster of CTAs by ``io_rows_plan``, the slices' sums added in order
inside the launch),
``oi_rows`` (``oi``, at most 16 rows: the logits on the tensor cores) and
``tc`` (more than 16 rows: pipelined tensor-core tiles).  K10 takes one of
two (``quant_matmul4.route_launches``): ``rows`` (at most 16 rows, the
packed axis split on group boundaries by ``io4_rows_plan``) and ``tc``
(more than 16 rows).
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Tuple

import torch

from . import kernels as K


class QuantTensor(NamedTuple):
    """Symmetric per-channel int8: ``dequant = q * s`` with ``s`` broadcast
    along the one reduced axis (the contraction axis)."""
    q: torch.Tensor  # int8, full shape
    s: torch.Tensor  # float32, q.shape without the reduced axis

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):  # dtype of the dequantized value
        return torch.float32

    def layer(self, li: int) -> "QuantTensor":
        return QuantTensor(self.q[li], self.s[li])

    def to(self, device) -> "QuantTensor":
        return QuantTensor(self.q.to(device), self.s.to(device))


class Quant4Tensor(NamedTuple):
    """Group-wise symmetric int4 for the ``io`` layout, logical weight
    (..., S, O): q (..., S/2, O) uint8 nibble-packed, s (..., S/G, O) f32."""
    q: torch.Tensor
    s: torch.Tensor

    @property
    def group(self) -> int:
        return 2 * self.q.shape[-2] // self.s.shape[-2]

    @property
    def shape(self):
        return (*self.q.shape[:-2], 2 * self.q.shape[-2], self.q.shape[-1])

    @property
    def dtype(self):
        return torch.float32

    def layer(self, li: int) -> "Quant4Tensor":
        return Quant4Tensor(self.q[li], self.s[li])

    def to(self, device) -> "Quant4Tensor":
        return Quant4Tensor(self.q.to(device), self.s.to(device))


QUANT_TYPES = (QuantTensor, Quant4Tensor)


def qlayer(v, li: int):
    """Layer ``li`` of a stacked leaf: a tensor's ``[li]`` or a quant
    container's ``.layer(li)``."""
    return v.layer(li) if isinstance(v, QUANT_TYPES) else v[li]


def reduced_axis(qt: QuantTensor) -> int:
    """Which axis of ``q`` the scales were reduced over (shape diff)."""
    qs, ss = list(qt.q.shape), list(qt.s.shape)
    for i in range(len(qs)):
        if qs[:i] + qs[i + 1:] == ss:
            return i
    raise ValueError(f"scale shape {ss} does not match quant shape {qs}")


def quantize_tensor(w: torch.Tensor, *, reduce_axis: int) -> QuantTensor:
    """Symmetric absmax int8, scales per channel of every axis except
    ``reduce_axis``; the JAX package's rounding points (f32 scale clamped at
    1e-12, round half to even)."""
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(dim=reduce_axis) / 127.0, 1e-12)
    q = torch.clamp(torch.round(wf / s.unsqueeze(reduce_axis)), -127, 127)
    return QuantTensor(q=q.to(torch.int8).contiguous(), s=s.contiguous())


def dequantize(qt: QuantTensor) -> torch.Tensor:
    return qt.q.float() * qt.s.unsqueeze(reduced_axis(qt))


def quantize_tensor4(w: torch.Tensor, *, group: int = 128) -> Quant4Tensor:
    """Symmetric absmax int4 over groups of ``group`` rows of the
    contraction axis (axis -2 of an (..., S, O) weight)."""
    wf = w.float()
    *lead, S, O = wf.shape
    if S % group or group % 2:
        raise ValueError(f"contraction dim {S} not divisible by group {group}")
    g = wf.reshape(*lead, S // group, group, O)
    s = torch.clamp_min(g.abs().amax(dim=-2) / 7.0, 1e-12)   # (..., S/G, O)
    q = torch.clamp(torch.round(g / s.unsqueeze(-2)), -8, 7).to(torch.int32)
    q = q + 8
    lo, hi = q[..., :group // 2, :], q[..., group // 2:, :]
    packed = (lo | (hi << 4)).to(torch.uint8)
    return Quant4Tensor(q=packed.reshape(*lead, S // 2, O), s=s)


def _unpack4(q: torch.Tensor, n_g: int) -> torch.Tensor:
    """(..., S/2, O) packed -> (..., n_g, G, O) int32 in [-8, 7]."""
    *lead, S2, O = q.shape
    p = q.reshape(*lead, n_g, S2 // n_g, O).to(torch.int32)
    return torch.cat([p & 0xF, p >> 4], dim=-2) - 8


def dequantize4(qt: Quant4Tensor) -> torch.Tensor:
    *lead, S2, O = qt.q.shape
    n_g = qt.s.shape[-2]
    w = _unpack4(qt.q, n_g).float() * qt.s.unsqueeze(-2)
    return w.reshape(*lead, 2 * S2, O)


# ------------------------------------------------------------- plain versions
def quant_matmul_plain(x: torch.Tensor, qt: QuantTensor, *,
                       layout: str = "io") -> torch.Tensor:
    """The JAX package's CPU branch: bf16 x against the int8 weight widened
    (exactly) to float, f32 accumulation, then the f32 column scales."""
    xb = x.to(torch.bfloat16).float().reshape(-1, x.shape[-1])
    w = qt.q.float()
    y = xb @ (w.t() if layout == "oi" else w)
    return (y * qt.s[None, :]).reshape(*x.shape[:-1], y.shape[-1])


def quant_matmul4_plain(x: torch.Tensor, qt: Quant4Tensor) -> torch.Tensor:
    """The JAX package's CPU branch: per group an f32 partial product of
    bf16 x and the exact integer weights, times the f32 group scales, summed
    over groups (never a bf16-rounded q * s)."""
    S = x.shape[-1]
    O = qt.q.shape[-1]
    n_g = qt.s.shape[-2]
    group = S // n_g
    xb = x.to(torch.bfloat16).float().reshape(-1, n_g, group)
    w = _unpack4(qt.q, n_g).float()                         # (n_g, G, O)
    part = torch.einsum("bgk,gko->bgo", xb, w)
    return (part * qt.s[None]).sum(dim=1).reshape(*x.shape[:-1], O)


# ------------------------------------------------------------------ wrappers
ROWS_MAX = 16         # x rows the decode-row kernels take
ROW_TILE = 16         # output columns per CTA of the io decode-row kernel
ROWS_PER_PASS = 256   # rows (K10: byte rows) a pass covers (256 threads)
MAX_WHOLE = 512       # rows (K10: byte rows) a CTA takes without a split
MAX_SPLIT = 8         # slices of the contraction axis: a portable cluster
H100_SMS = 132


def io_rows_plan(m: int, s: int, o: int,
                 n_sms: int = H100_SMS) -> Tuple[int, int]:
    """Slice length (weight rows) and slice count of K9's ``io`` decode-row
    kernel for x (m, s) @ W (s, o), m <= 16.

    The kernel's grid is (ceil(o / 16), n_split) in clusters of (1,
    n_split): a CTA owns 16 columns (one 16-byte vector of each weight row)
    and one slice [i * slice, min((i + 1) * slice, s)) of the contraction
    axis, and the cluster adds its slices' sums in order.  Up to MAX_WHOLE
    rows a CTA takes the whole axis (two passes; a split's cluster barrier
    would cost more than it saves); beyond, the axis is cut into slices of
    at least one pass (a multiple of 8 rows), a power of two (clusters of
    2, 4 or 8 pack the card's SM groups), as many as one wave of CTAs holds
    (a CTA fills an SM's registers), at most MAX_SPLIT.  Shapes
    and the SM count decide, never data, so the grid is the same at every
    step."""
    if not 1 <= m <= ROWS_MAX:
        raise ValueError(f"io_rows_plan: {m} rows, the kernel takes 1..16")
    return _axis_plan(s, o, n_sms, 8)


def io4_rows_plan(m: int, s: int, o: int, group: int,
                  n_sms: int = H100_SMS) -> Tuple[int, int]:
    """Slice length (packed byte rows) and slice count of K10's decode-row
    kernel for x (m, s) @ int4 W (s, o) in groups of ``group`` rows, m <=
    16.

    The packed axis has s / 2 byte rows, each holding two weight rows of
    one group (its two nibbles); a group is group / 2 byte rows.  The plan
    is ``io_rows_plan``'s over the byte rows, with slices of whole groups,
    so no group's partial product is cut before it is scaled; the cluster
    adds the slices' sums in order.  Shapes and the SM count decide, never
    data."""
    if not 1 <= m <= ROWS_MAX:
        raise ValueError(f"io4_rows_plan: {m} rows, the kernel takes 1..16")
    if group < 64 or group % 64 or s % group:
        raise ValueError(f"io4_rows_plan: contraction {s} in groups of "
                         f"{group} (a multiple of 64 dividing it)")
    return _axis_plan(s // 2, o, n_sms, group // 2)


def _axis_plan(axis: int, o: int, n_sms: int,
               unit: int) -> Tuple[int, int]:
    """(slice, n_split) of a decode-row kernel over ``axis`` rows: slices
    of whole ``unit``s, a power of two of them past MAX_WHOLE rows (see
    ``io_rows_plan``)."""
    n_tiles = -(-o // ROW_TILE)
    n = 1
    if axis > MAX_WHOLE:
        cap = min(MAX_SPLIT, -(-axis // ROWS_PER_PASS), n_sms // n_tiles)
        while 2 * n <= cap:  # clusters of 2, 4 or 8 pack an SM group
            n *= 2
    sl = -(-(-(-axis // n)) // unit) * unit
    return sl, -(-axis // sl)


def _launch(name: str, layout: int, x2: torch.Tensor, qt, out: torch.Tensor,
            group: int, slice_rows: int = 0, n_split: int = 0) -> None:
    """One call of csrc/qmatmul.cu's entry; slice_rows and n_split are the
    decode-row kernels' (``io_rows_plan``, ``io4_rows_plan``), 0
    elsewhere."""
    M, S = x2.shape
    O = out.shape[1]
    fn = K.entry("qmatmul", "gwt_qmatmul",
                 (K.P,) * 4 + (K.I,) * 7 + (K.P,))
    K.launch(fn, name, x2.device,
             x2.data_ptr(), qt.q.data_ptr(), qt.s.data_ptr(),
             out.data_ptr(), M, S, O, layout, group, slice_rows, n_split)


def quant_matmul(x: torch.Tensor, qt: QuantTensor, *,
                 layout: str = "io") -> torch.Tensor:
    """``x (..., S) @ QuantTensor -> (..., O)`` float32.  layout "io": q
    (S, O); "oi": q (O, S); scales (O,).  CUDA tensors launch
    csrc/qmatmul.cu, CPU tensors take the plain version."""
    if layout not in ("io", "oi"):
        raise ValueError(f"layout must be 'io' or 'oi', got {layout!r}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qt, layout=layout)
    S = x.shape[-1]
    x2 = x.reshape(-1, S).to(torch.bfloat16).contiguous()
    K.require_cuda("quant_matmul", x2, qt.q, qt.s)
    oi = layout == "oi"
    O = qt.q.shape[0] if oi else qt.q.shape[1]
    if (qt.q.dtype != torch.int8 or qt.q.dim() != 2
            or qt.q.shape[1 if oi else 0] != S or qt.s.dtype != torch.float32
            or tuple(qt.s.shape) != (O,)):
        raise ValueError("quant_matmul: q int8 (S, O) for 'io' or (O, S) for "
                         "'oi' with S = x.shape[-1], s float32 (O,)")
    M = x2.shape[0]
    route = "tc" if M > ROWS_MAX else "oi_rows" if oi else "io_rows"
    out = torch.empty((M, O), dtype=torch.float32, device=x.device)
    if M:
        sl, n_split = (io_rows_plan(M, S, O, K.sm_count(x.device.index))
                       if route == "io_rows" else (0, 0))
        _launch(f"gwt_qmatmul[int8 {route}]", 1 if oi else 0, x2, qt, out,
                0, sl, n_split)
        K.count(quant_matmul, (quant_matmul.layout_launches, layout),
                (quant_matmul.route_launches, route))
    return out.reshape(*x.shape[:-1], O)


def quant_matmul4(x: torch.Tensor, qt: Quant4Tensor) -> torch.Tensor:
    """``x (..., S) @ Quant4Tensor (S, O) -> (..., O)`` float32.  CUDA
    tensors launch csrc/qmatmul.cu, CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return quant_matmul4_plain(x, qt)
    S = x.shape[-1]
    x2 = x.reshape(-1, S).to(torch.bfloat16).contiguous()
    K.require_cuda("quant_matmul4", x2, qt.q, qt.s)
    O = qt.q.shape[-1]
    group = qt.group
    if (qt.q.dtype != torch.uint8 or qt.q.dim() != 2 or 2 * qt.q.shape[0] != S
            or qt.s.dtype != torch.float32
            or tuple(qt.s.shape) != (S // group, O) or group % 64):
        raise ValueError("quant_matmul4: q uint8 (S/2, O), s float32 (S/G, O) "
                         "with S = x.shape[-1] and G a multiple of 64")
    M = x2.shape[0]
    route = "tc" if M > ROWS_MAX else "rows"
    out = torch.empty((M, O), dtype=torch.float32, device=x.device)
    if M:
        sl, n_split = (io4_rows_plan(M, S, O, group, K.sm_count(
            x.device.index)) if route == "rows" else (0, 0))
        _launch(f"gwt_qmatmul[int4 {route}]", 2, x2, qt, out, group, sl,
                n_split)
        K.count(quant_matmul4, (quant_matmul4.route_launches, route))
    return out.reshape(*x.shape[:-1], O)


quant_matmul.launches = 0
quant_matmul.layout_launches = collections.Counter()  # "io" / "oi"
# by route: "io_rows" (io, M <= 16), "oi_rows" (oi, M <= 16), "tc" (M > 16)
quant_matmul.route_launches = collections.Counter()
quant_matmul4.launches = 0
# by route: "rows" (M <= 16), "tc" (M > 16)
quant_matmul4.route_launches = collections.Counter()
