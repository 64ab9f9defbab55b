"""K8: bounded beam reorder of the merged self-KV cache
(csrc/kv_reorder.cu) and its plain version.

Counterpart of the JAX package's ``ops/kv_reorder.py`` entry
``reorder_kv_live`` (TPU kernel ``_copy_kernel``), the beam merge's path for
configurations too wide for the split cache (``beam_size * n_text_head >
128``): every row j of the ``(L, B, C, S)`` caches takes the history of row
``src[j]`` over slots ``[0, hi)``.  Slots ``>= hi`` of the result are
unspecified; the decode loop writes slot hi before it attends it, and the
port's decode-attention kernel reads no slot past ``max(hi, max lo)``.

The copy cannot run in place (row j may read a row that another block has
already overwritten), so the wrapper writes into a second preallocated
cache pair and the decode loop swaps the two (ping-pong).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kernels as K


def reorder_kv_live_plain(k, v, src, hi: int):
    """``index_select`` on the row axis (every slot, not just [0, hi))."""
    idx = src.to(k.device, torch.int64)
    return torch.index_select(k, 1, idx), torch.index_select(v, 1, idx)


def reorder_kv_live(k: torch.Tensor, v: torch.Tensor, src: torch.Tensor,
                    hi: int, *, out: Tuple[torch.Tensor, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper.  k/v (L, B, C, S); src (B,) int32 row indices;
    ``out`` a second (k, v) pair of the same shape and dtype, written over
    slots [0, hi) and returned.  CUDA tensors launch csrc/kv_reorder.cu,
    CPU tensors take the plain version."""
    k_out, v_out = out
    if k.device.type == "cpu":
        idx = src.to(torch.int64)
        torch.index_select(k, 1, idx, out=k_out)
        torch.index_select(v, 1, idx, out=v_out)
        return k_out, v_out
    K.require_cuda("reorder_kv_live", k, v, src, k_out, v_out)
    n_layer, b, c, s = k.shape
    item = k.element_size()
    if (v.shape != k.shape or k_out.shape != k.shape
            or v_out.shape != k.shape
            or any(t.dtype != k.dtype for t in (v, k_out, v_out))
            or (s * item) % 16 or src.dtype != torch.int32
            or tuple(src.shape) != (b,) or not 0 <= hi <= c
            or {k_out.data_ptr(), v_out.data_ptr()}
            & {k.data_ptr(), v.data_ptr()}):
        raise ValueError("reorder_kv_live: k/v and out (L, B, C, S) of one "
                         "dtype, S * itemsize a multiple of 16, src (B,) "
                         "int32, 0 <= hi <= C, out distinct from k/v")
    fn = K.entry("kv_reorder", "gwt_reorder_kv",
                 (K.P,) * 5 + (K.I,) * 6 + (K.P,))
    K.launch(fn, "gwt_reorder_kv", k.device, k.data_ptr(), v.data_ptr(),
             k_out.data_ptr(), v_out.data_ptr(), src.data_ptr(), n_layer, b,
             c, s, item, int(hi))
    reorder_kv_live.launches += 1
    return k_out, v_out


reorder_kv_live.launches = 0
