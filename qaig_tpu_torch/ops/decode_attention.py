"""Shared-prefix rollout decode attention (counterpart of
``qaig_tpu/ops/decode_attention.py``).

One rollout decode step: the B rollouts of image n attend in one float32
softmax over the image's SHARED prefix (slots ``< index0`` of slot-minor
(N, H, dh, S) caches) and over their own segment (slots
``<= block_index`` of (N*B, H, bw, dh) blocks).

* :func:`shared_prefix_attention_fused_t` -- prefix in the working dtype
  (kernel B);
* :func:`shared_prefix_attention_fused_int8` -- int8 prefix with per-slot
  bf16 scales (N, H, S) folded into the scores (K) and the probabilities
  (V) (kernel C).

Layout.  The caches stay slot-minor, (N, H, dh, S), as in the JAX package:
the kernel (``qaig_tpu_torch/csrc/decode_attention.cu``) reads that layout
directly, neighbouring threads on neighbouring slots, one block per
(image, head) streaming the prefix once for all B rollouts.

On CUDA tensors both functions launch the kernel (one CUDA source,
instantiated for a working-dtype or an int8 prefix); on CPU tensors they
run :func:`shared_prefix_attention_reference`, the plain PyTorch version.
A CUDA input the kernel does not take raises.  Any ``bw >= 1`` is taken,
including crossing segments whose width is not a multiple of 8.
"""

import ctypes
import math

import torch

from qaig_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_MAX_SMEM = 227 * 1024


def shared_prefix_attention_reference(q, k_shared, v_shared, k_block,
                                      v_block, index0, block_index,
                                      k_scale=None, v_scale=None):
    """Plain PyTorch version (the JAX package's einsum path,
    ``qaig_tpu/ops/attention.py:200-240``), computed in float32.

    q (N*B, 1, D); k_shared/v_shared (N, H, dh, S) (int8 with
    ``k_scale``/``v_scale`` (N, H, S)); k_block/v_block (N*B, H, bw, dh).
    Returns (N*B, 1, D) in q's dtype."""
    nb, _, d = q.shape
    n, heads, dh, s = k_shared.shape
    b = nb // n
    bw = k_block.shape[2]
    scale = 1.0 / math.sqrt(dh)
    f32 = torch.float32

    qh = q.to(f32).reshape(nb, heads, dh)                   # (N*B, H, dh)
    qg = qh.reshape(n, b, heads, dh)
    s_shared = torch.einsum("nbhd,nhds->nbhs", qg,
                            k_shared.to(f32)) * scale
    if k_scale is not None:
        s_shared = s_shared * k_scale.to(f32)[:, None]
    s_shared = s_shared.reshape(nb, heads, s)
    live = torch.arange(s, device=q.device) < index0
    s_shared = s_shared.masked_fill(~live, float("-inf"))

    s_block = torch.einsum("rhd,rhtd->rht", qh, k_block.to(f32)) * scale
    live_b = torch.arange(bw, device=q.device) <= block_index
    s_block = s_block.masked_fill(~live_b, float("-inf"))

    weights = torch.softmax(torch.cat([s_shared, s_block], dim=-1), dim=-1)
    w_shared = weights[..., :s].reshape(n, b, heads, s)
    if v_scale is not None:
        w_shared = w_shared * v_scale.to(f32)[:, None]
    out = torch.einsum("nbhs,nhds->nbhd", w_shared,
                       v_shared.to(f32)).reshape(nb, heads, dh)
    out = out + torch.einsum("rht,rhtd->rhd", weights[..., s:],
                             v_block.to(f32))
    return out.reshape(nb, 1, d).to(q.dtype)


def shared_prefix_attention_fused_t(q, kt_shared, vt_shared, k_block,
                                    v_block, index0, block_index):
    """Rollout decode attention over a working-dtype prefix (kernel B on
    CUDA tensors).  ``index0``/``block_index`` are Python ints."""
    if q.device.type == "cpu":
        return shared_prefix_attention_reference(
            q, kt_shared, vt_shared, k_block, v_block, index0, block_index)
    out = _launch(q, kt_shared, vt_shared, None, None, k_block, v_block,
                  index0, block_index)
    shared_prefix_attention_fused_t.launches += 1
    return out


shared_prefix_attention_fused_t.launches = 0


def shared_prefix_attention_fused_int8(q, k8t_shared, k_scale, v8t_shared,
                                       v_scale, k_block, v_block, index0,
                                       block_index):
    """Rollout decode attention over an int8 prefix with per-slot scales
    (kernel C on CUDA tensors).  ``index0``/``block_index`` are Python
    ints."""
    if q.device.type == "cpu":
        return shared_prefix_attention_reference(
            q, k8t_shared, v8t_shared, k_block, v_block, index0,
            block_index, k_scale=k_scale, v_scale=v_scale)
    out = _launch(q, k8t_shared, v8t_shared, k_scale, v_scale, k_block,
                  v_block, index0, block_index)
    shared_prefix_attention_fused_int8.launches += 1
    return out


shared_prefix_attention_fused_int8.launches = 0


def _launch(q, k_shared, v_shared, k_scale, v_scale, k_block, v_block,
            index0, block_index):
    quant = k_scale is not None
    _check_kernel_inputs(q, k_shared, v_shared, k_scale, v_scale, k_block,
                         v_block, index0, block_index)
    n, heads, dh, s = k_shared.shape
    nb = q.shape[0]
    b = nb // n
    bw = k_block.shape[2]
    smem = cuda_build.function(
        "decode_attention", "qaig_shared_prefix_attention_smem",
        [ctypes.c_int, ctypes.c_int], ctypes.c_size_t)(b, dh)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"shared_prefix_attention: {b} rollouts x dh {dh} need {smem} "
            f"bytes of shared memory, above the {_MAX_SMEM} a block has")
    out = torch.empty_like(q)
    fn = cuda_build.function("decode_attention",
                             "qaig_shared_prefix_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k_shared.data_ptr(), v_shared.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None,
             k_block.data_ptr(), v_block.data_ptr(), out.data_ptr(),
             n, b, heads, dh, s, bw, int(index0), int(block_index),
             _DTYPES[q.dtype], int(quant), cuda_build.stream_handle(q))
    cuda_build.check("decode_attention", err)
    return out


def _check_kernel_inputs(q, k_shared, v_shared, k_scale, v_scale, k_block,
                         v_block, index0, block_index):
    name = "shared_prefix_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError(f"{name}: give both k_scale and v_scale or neither")
    prefix_dtype = torch.int8 if quant else q.dtype
    tensors = [("q", q, q.dtype), ("k_shared", k_shared, prefix_dtype),
               ("v_shared", v_shared, prefix_dtype),
               ("k_block", k_block, q.dtype), ("v_block", v_block, q.dtype)]
    if quant:
        tensors += [("k_scale", k_scale, torch.bfloat16),
                    ("v_scale", v_scale, torch.bfloat16)]
    for tname, x, dtype in tensors:
        if x.device != q.device:
            raise ValueError(f"{name}: {tname} is on {x.device}, q on "
                             f"{q.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name}: {tname} must be {dtype}, got "
                             f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {tname} is not contiguous")
    if k_shared.ndim != 4 or q.ndim != 3 or q.shape[1] != 1:
        raise ValueError(
            f"{name}: expected q (N*B, 1, D) and slot-minor prefix "
            f"(N, H, dh, S), got q {tuple(q.shape)}, prefix "
            f"{tuple(k_shared.shape)}")
    n, heads, dh, s = k_shared.shape
    nb, _, d = q.shape
    if d != heads * dh or nb % n:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit prefix "
                         f"{tuple(k_shared.shape)}")
    if v_shared.shape != k_shared.shape:
        raise ValueError(f"{name}: v_shared shape {tuple(v_shared.shape)} "
                         f"!= k_shared {tuple(k_shared.shape)}")
    if quant and (k_scale.shape != (n, heads, s)
                  or v_scale.shape != (n, heads, s)):
        raise ValueError(f"{name}: scales must be (N, H, S) = "
                         f"{(n, heads, s)}")
    if (k_block.ndim != 4 or k_block.shape[:2] != (nb, heads)
            or k_block.shape[3] != dh or v_block.shape != k_block.shape):
        raise ValueError(
            f"{name}: blocks must be (N*B, H, bw, dh) = "
            f"({nb}, {heads}, bw, {dh}), got {tuple(k_block.shape)} / "
            f"{tuple(v_block.shape)}")
    bw = k_block.shape[2]
    if not (0 <= int(index0) <= s and 0 <= int(block_index) < bw):
        raise ValueError(f"{name}: index0 {index0} / block_index "
                         f"{block_index} outside prefix {s} / block {bw}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are not on the current CUDA "
                         "device")
